"""The port has a counterpart for every public name of the JAX reference.

Each module ``src/repro/<path>`` is one case.  Its public ``def``s and
``class``es, the public methods of those classes and its UPPER-case
constants must each be defined or imported in ``src/repro_torch/<path>``,
or stand in ``RENAMED`` (with the port location, which must exist) or in
``JAX_ONLY`` (with the reason there is no counterpart).  Both trees are read
with ``ast`` only; neither package is imported.
"""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
_UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")

# "<reference path>::<name>" -> "<port path>::<name>"
RENAMED = {
    "core/codec.py::FloatLayout.uint_dtype": "core/codec.py::FloatLayout.bits_dtype",
    "kernels/ops.py::pack": "kernels/bitpack.py::pack",
    "kernels/ops.py::unpack": "kernels/bitpack.py::unpack",
    "kernels/ops.py::rans_encode": "kernels/rans.py::encode",
    "kernels/ops.py::rans_decode": "kernels/rans.py::decode",
    "kernels/rans.py::PROB_BITS": "kernels/ref.py::PROB_BITS",
    "kernels/rans.py::M": "kernels/ref.py::M",
    "kernels/rans.py::RANS_L": "kernels/ref.py::RANS_L",
    **{f"models/layers.py::init_{part}": "models/transformer.py::init"
       for part in ("attention", "mla", "swiglu", "moe", "mamba", "xlstm")},
    "models/transformer.py::forward": "models/transformer.py::Transformer.forward",
}

_SWITCH = "chooses Pallas or interpret mode; the port's route follows the tensor's device"
_FALLBACK = "records a Pallas fallback; a port wrapper launches or raises, and counts launches"
_TILE = "a Pallas tile; the CUDA kernels size their tiles in kernels.tile_geometry"

# "<reference path>::<name>" -> why the port has no counterpart
JAX_ONLY = {
    "jax_compat.py::assert_compat": "backfills JAX APIs; the port imports no JAX",
    **{f"kernels/__init__.py::{name}": _SWITCH
       for name in ("backend", "has_tpu", "default_use_pallas", "default_interpret",
                    "resolve_use_pallas", "resolve_interpret", "probe_cache_clear")},
    **{f"kernels/__init__.py::{name}": _FALLBACK
       for name in ("record_fallback", "fallback_counts", "clear_fallbacks")},
    "kernels/bitpack.py::TILE_G": _TILE,
    "kernels/decode_reduce.py::TILE_G": _TILE,
    "kernels/encode_fused.py::TILE_B": _TILE,
    "kernels/plane_split.py::TILE_B": _TILE,
    "kernels/rans.py::LANE_TILE": _TILE,
    "serve/engine.py::build_prefill_step": "a jit closure; the port runs transformer.prefill eagerly",
    "serve/engine.py::build_decode_step": "a jit closure; the port runs transformer.decode_step eagerly",
    "train/step.py::build_train_step": "a jit closure over the mesh; the port calls train_step",
    "roofline/model.py::collective_bytes_trip_aware": "counts collectives in HLO text; the port "
                                                      "reads a torch.profiler trace",
    "launch/dryrun.py::COLLECTIVE_RE": "an HLO regex; the port's dry run reads a profiler trace",
    "roofline/analysis.py::ICI_BW": "a TPU link rate; the H100's are LINK_BW and NET_BW",
    "roofline/analysis.py::DCN_BW": "a TPU link rate; the H100's are LINK_BW and NET_BW",
}


def _targets(node) -> list:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)]


def public_names(source: str) -> set:
    """Top-level public defs and classes, their classes' public methods
    (``Class.method``) and UPPER-case constants."""
    out = set()
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{b.name}" for b in node.body
                        if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not b.name.startswith("_")}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out |= {n for n in _targets(node) if _UPPER.match(n)}
    return out


def defined_names(source: str) -> set:
    """Every top-level name a module defines or imports, and every member
    (``Class.name``) of its classes."""
    out = set()
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for b in node.body:
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                        out.add(f"{node.name}.{b.name}")
                    elif isinstance(b, (ast.Assign, ast.AnnAssign)):
                        out |= {f"{node.name}.{n}" for n in _targets(b)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out |= set(_targets(node))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def without_counterpart(rel: str, ref_source: str, port_source: str, *,
                        renamed=RENAMED, jax_only=JAX_ONLY) -> list:
    """The public names of reference module ``rel`` that its port neither
    defines nor imports and that neither table accounts for."""
    have = defined_names(port_source)
    return sorted(n for n in public_names(ref_source) - have
                  if f"{rel}::{n}" not in renamed and f"{rel}::{n}" not in jax_only)


def _source(root: Path, rel: str) -> str:
    path = root / rel
    return path.read_text() if path.exists() else ""


REF_MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_a_counterpart_in_the_port(rel):
    ref_source, port_source = _source(REF, rel), _source(PORT, rel)
    assert without_counterpart(rel, ref_source, port_source) == []
    public, have = public_names(ref_source), defined_names(port_source)
    for key in (k for k in (*RENAMED, *JAX_ONLY) if k.startswith(f"{rel}::")):
        name = key.split("::")[1]
        assert name in public, f"{key} is no public name of the reference"
        assert name not in have, f"{key} is in the port under its own name"
    for key in (k for k in RENAMED if k.startswith(f"{rel}::")):
        where, name = RENAMED[key].split("::")
        assert name in defined_names(_source(PORT, where)), f"{key}: no {RENAMED[key]}"


def test_every_table_entry_names_a_reference_module():
    assert {k.split("::")[0] for k in (*RENAMED, *JAX_ONLY)} <= set(REF_MODULES)
    assert all(reason for reason in JAX_ONLY.values())


def test_a_module_pair_that_lacks_a_name_fails():
    ref = "def kept(): pass\nclass Plane:\n    def cost(self): pass\nWIDTH = 5\n_HIDDEN = 1\n"
    port = "from x import kept\nclass Plane:\n    pass\n"
    assert without_counterpart("m.py", ref, port) == ["Plane.cost", "WIDTH"]
    assert without_counterpart("m.py", ref, port, renamed={"m.py::WIDTH": "n.py::W"},
                               jax_only={"m.py::Plane.cost": "why"}) == []
    assert without_counterpart("m.py", ref, ref) == []
