"""The port's all-reduce family (``psum_compressed`` two-shot and ring,
``psum_raw_twoshot``, ``psum_safe``, ``psum_compressed_hierarchical``,
``all_to_all_compressed``, ``ppermute_compressed``,
``tree_psum_compressed``) and the unfused encode, held against the JAX
reference (``repro.core.compressed_collectives``).

At one rank each port function runs on a one-rank gloo group and the
reference's whole function inside ``jax.shard_map`` on a one-device mesh.
At 2 and 4 gloo ranks (``torch_port_util.psum_rank``) each result is held
against the rank-order f32 sum of the ranks' inputs and against a
composition of the reference's own ``_encode_chunks``,
``_decode_reduce_chunks`` and ``_decode_chunks`` on the stacked inputs.

Tolerances: none.  Values bit for bit, with NaN matched as NaN (a NaN's
payload after an f32 sum and a cast back differs between XLA and torch),
on inputs without subnormals (XLA:CPU flushes f32 subnormals); under
``jit`` XLA folds ``zeros + x`` to ``x``, so a -0.0 it keeps is +0.0 in
the port, as in IEEE.  ``psum_safe`` is a backend ``all_reduce`` whose
summation order neither gloo nor NCCL fixes: at four ranks its inputs are
small integers times powers of two, whose f32 sums are exact in any order.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import compressed_collectives as jcc
from repro.core import policy as jpolicy
from repro.core.policy import CompressionPolicy as JPolicy
from repro.launch.mesh import make_mesh
from repro_torch.core import compressed_collectives as cc
from repro_torch.core import policy
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch.train import single_process_group
from repro_torch.sched import compile as sched_compile
from torch_port_util import (A2A_INNER, FORMATS, PSUM_N, PSUM_VARIANTS, REPORT_FIELDS,
                             _psum_tree, assert_bits_equal, exact_f32, grad_like_bits,
                             np_of, psum_bits, psum_rank, report_rows, run_gloo_ranks,
                             to_jax, to_torch)

BLOCK = 512
POL = CompressionPolicy(min_bytes=0)
JPOL = JPolicy(min_bytes=0)
WIDTH = POL.width_for("gradient")
AG_WIDTH = min(WIDTH + POL.profile.ag_extra_bits, 8)


def _floats(bits: np.ndarray, fmt: str) -> np.ndarray:
    return to_torch(np.ascontiguousarray(bits), fmt).float().numpy()


def assert_equal_nan_as_nan(got, want, fmt: str, ctx=""):
    """Same bits, or NaN on both sides."""
    g, w = np_of(got).reshape(-1), np_of(want).reshape(-1)
    assert g.shape == w.shape, (ctx, g.shape, w.shape)
    nan = np.isnan(_floats(g, fmt)) & np.isnan(_floats(w, fmt))
    bad = np.flatnonzero((g != w) & ~nan)
    assert bad.size == 0, (ctx, f"{bad.size} differ; first at {bad[0]}: {g[bad[0]]} "
                                f"vs {w[bad[0]]}")


def _plus_zero(a):
    """The reference's -0.0 (kept by XLA's folded ``zeros + x``) as +0.0."""
    a = np.asarray(a)
    return np.where(a == 0, np.zeros((), a.dtype), a)


# the reference's chunk codec, jitted: one compile a shape, not one an op
_encode = jax.jit(jcc._encode_chunks, static_argnames=("width", "block", "exc_frac", "fused"))
_decode = jax.jit(jcc._decode_chunks, static_argnames=("dtype", "n", "width", "block"))
_decode_reduce = jax.jit(jcc._decode_reduce_chunks,
                         static_argnames=("dtype", "n", "width", "block"))


def _pad_bits(bits: np.ndarray, multiple: int) -> np.ndarray:
    return np.concatenate([bits, np.zeros((-bits.size) % multiple, bits.dtype)])


# ---------------------------------------------------------------------------
# models: the rank-order f32 sum, and the reference's own codec composed
# ---------------------------------------------------------------------------

def rank_order_sum(inputs: list) -> torch.Tensor:
    """Elementwise f32 sum in rank order (zeros, += rank 0, 1, ...)."""
    acc = torch.zeros(inputs[0].shape, dtype=torch.float32)
    for t in inputs:
        acc = acc + t.float()
    return acc


def ring_model(xs: list, k: int) -> torch.Tensor:
    """The ring's sum: chunk c starts at rank c and each later rank adds its
    own row to the partial sum it receives, rounded to the wire dtype."""
    rows = [cc._pad_flat(x, k * BLOCK).reshape(k, -1) for x in xs]
    out = []
    for c in range(k):
        p = rows[c][c].float()
        for j in range(1, k):
            p = rows[(c + j) % k][c].float() + p.to(xs[0].dtype).float()
        out.append(p.to(xs[0].dtype))
    return torch.cat(out)[: xs[0].numel()]


def ref_reduce_scatter(bits: list, fmt: str, width: int) -> list:
    """Each rank's f32 chunk sum: the reference's encode of every rank's
    rows and its fused decode+reduce of the chunks a rank receives."""
    k = len(bits)
    rows = [_pad_bits(b, k * BLOCK).reshape(k, -1) for b in bits]
    wires = [_encode(to_jax(r, fmt), width=width, block=BLOCK, exc_frac=0.02)
             for r in rows]
    chunk = rows[0].shape[1]
    out = []
    for q in range(k):
        recv = {key: jnp.stack([w[key][q] for w in wires]) for key in wires[0]}
        red, _ = _decode_reduce(recv, dtype=jnp.dtype(fmt), n=chunk,
                                           width=width, block=BLOCK)
        out.append(red)
    return out


def ref_all_gather(shards: list, fmt: str, width: int) -> np.ndarray:
    """The reference's encode of every rank's shard and decode of the
    gathered wire: the flat gathered buckets."""
    n = shards[0].shape[0]
    wires = [_encode(_pad_jax(s, BLOCK)[None], width=width, block=BLOCK,
                                exc_frac=0.02) for s in shards]
    gathered = {key: jnp.concatenate([w[key] for w in wires]) for key in wires[0]}
    vals, _ = _decode(gathered, dtype=jnp.dtype(fmt),
                                 n=-(-n // BLOCK) * BLOCK, width=width, block=BLOCK)
    return vals


def _pad_jax(a, multiple):
    return jnp.concatenate([a, jnp.zeros((-a.shape[0]) % multiple, a.dtype)])


def ref_two_shot(bits: list, fmt: str) -> np.ndarray:
    reds = ref_reduce_scatter(bits, fmt, WIDTH)
    vals = ref_all_gather([r.astype(fmt) for r in reds], fmt, AG_WIDTH)
    return np.asarray(vals).reshape(-1)[: bits[0].size]


def ref_ring(bits: list, fmt: str) -> np.ndarray:
    """The ring hop by hop, each hop the reference's encode and its fused
    decode+reduce (RS) or decode (AG); the result every rank holds."""
    k = len(bits)
    rows = [to_jax(_pad_bits(b, k * BLOCK), fmt).reshape(k, -1).astype(jnp.float32)
            for b in bits]
    chunk = rows[0].shape[1]
    kw = dict(width=WIDTH, block=BLOCK)

    def wire(v):
        return _encode(v.astype(fmt)[None], exc_frac=0.02, **kw)

    send = [rows[i][i] for i in range(k)]
    for h in range(k - 1):
        send = [_decode_reduce(wire(send[(i - 1) % k]), dtype=jnp.dtype(fmt),
                                          n=chunk, acc=rows[i][(i - h - 1) % k], **kw)[0]
                for i in range(k)]
    # after k - 1 hops rank i holds the whole sum of chunk (i + 1) % k; the
    # all-gather hops decode it losslessly, so every rank ends with these
    out = [None] * k
    for i in range(k):
        got, _ = _decode(wire(send[i]), dtype=jnp.dtype(fmt), n=chunk, **kw)
        out[(i + 1) % k] = got[0]
    return np.asarray(jnp.concatenate(out)).reshape(-1)[: bits[0].size]


# ---------------------------------------------------------------------------
# one rank: the port against the reference's whole function
# ---------------------------------------------------------------------------

def _in_shard_map(fn, *args, axes=("data", "model"), shape=(1, 1)):
    """Run ``fn`` inside ``shard_map`` on a one-device mesh, with the
    WireReports its trace records."""
    mesh = make_mesh(shape, axes)
    with jpolicy.capture_wire_reports() as reports:
        out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(),) * len(args),
                                    out_specs=P(), axis_names=set(axes),
                                    check_vma=False))(*args)
    return out, list(reports)


def _one_rank_bits(fmt="bfloat16", n=PSUM_N, seed=23):
    # the reference pads ragged input with a float copy, which drops bf16
    # NaN payloads on XLA:CPU: only NaNs that survive one
    return grad_like_bits(fmt, n, seed=seed, subnormals=False, xla_copy_nans=True)


_REFERENCE: dict = {}


def _reference_variants(fmt: str) -> dict:
    """The reference's psum_compressed in every variant, traced once in one
    program: ``{variant: (out, flag, WireReports)}``."""
    if fmt not in _REFERENCE:
        reports = {}

        def body(v):
            outs = {}
            for name, kw in PSUM_VARIANTS.items():
                with jpolicy.capture_wire_reports() as reports[name]:
                    outs[name] = jcc.psum_compressed(
                        v, "data", policy=dataclasses.replace(JPOL, **kw))
            return outs

        outs, _ = _in_shard_map(body, to_jax(_one_rank_bits(fmt), fmt))
        _REFERENCE[fmt] = {k: (*outs[k], list(reports[k])) for k in outs}
    return _REFERENCE[fmt]


@pytest.mark.parametrize("variant,fmt", [(v, "bfloat16") for v in sorted(PSUM_VARIANTS)]
                         + [("two_shot", "float32"), ("unfused_decode", "float32")])
def test_single_rank_psum_compressed_matches_reference(variant, fmt):
    bits = _one_rank_bits(fmt)
    kw = PSUM_VARIANTS[variant]
    jout, jflag, jreports = _reference_variants(fmt)[variant]
    x = to_torch(bits, fmt)
    with single_process_group("cpu") as group, policy.capture_wire_reports() as reports:
        out, flag = cc.psum_compressed(x, group, policy=dataclasses.replace(POL, **kw))
    assert_equal_nan_as_nan(out, _plus_zero(jout), fmt, variant)
    assert int(flag) == int(jflag) == 0
    assert report_rows(reports) == report_rows(jreports)
    if variant.startswith("ring"):
        assert reports == []  # no hop at one rank
    else:
        assert [r.encode_fused for r in reports] == [kw.get("fused_encode", True)] * 2


def test_single_rank_raw_paths_match_reference():
    """psum_raw_twoshot, psum_safe and the gated-off dispatch of
    psum_compressed (the raw two-shot at min_bytes or more, else
    psum_safe), on bf16 and f32."""
    bits = _one_rank_bits()
    xe = exact_f32(0, 3000)
    small = JPolicy(min_bytes=1 << 30)

    def body(v, e):
        return (jcc.psum_raw_twoshot(v, "data"), jcc.psum_safe(v, "data"),
                jcc.psum_raw_twoshot(e, "data"), jcc.psum_safe(e, "data"),
                jcc.psum_compressed(v, "data", policy=JPolicy.disabled())[0],
                jcc.psum_compressed(v, "data", policy=small)[0],
                jcc.psum_compressed(v, "model", policy=JPOL)[0])

    want, _ = _in_shard_map(body, to_jax(bits, "bfloat16"), jnp.asarray(xe))
    x, e = to_torch(bits, "bfloat16"), torch.from_numpy(xe)
    with single_process_group("cpu") as g:
        got = (cc.psum_raw_twoshot(x, g), cc.psum_safe(x, g), cc.psum_raw_twoshot(e, g),
               cc.psum_safe(e, g),
               cc.psum_compressed(x, g, policy=CompressionPolicy.disabled())[0],
               cc.psum_compressed(x, g, policy=CompressionPolicy(min_bytes=1 << 30))[0],
               cc.psum_compressed(x, g, policy=POL, axis_name="model")[0])
    for i, (a, b) in enumerate(zip(got, want)):
        assert_equal_nan_as_nan(a, _plus_zero(b), "bfloat16" if a.dtype == torch.bfloat16
                                else "float32", i)
    # the sum of one is the value itself (a NaN's payload aside: the f32
    # accumulator's cast back makes it the canonical NaN)
    assert_equal_nan_as_nan(got[0], x, "bfloat16")


@pytest.mark.parametrize("fused_encode", [True, False])
def test_single_rank_hierarchical_matches_reference(fused_encode):
    bits = _one_rank_bits()
    jpol = dataclasses.replace(JPOL, fused_encode=fused_encode)
    (jout, jflag), jreports = _in_shard_map(
        lambda v: jcc.psum_compressed_hierarchical(v, policy=jpol), to_jax(bits, "bfloat16"),
        axes=("pod", "data", "model"), shape=(1, 1, 1))
    x = to_torch(bits, "bfloat16")
    pol = dataclasses.replace(POL, fused_encode=fused_encode)
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        out, flag = cc.psum_compressed_hierarchical(x, g, g, policy=pol, group=g)
        raw, _ = cc.psum_compressed_hierarchical(x, g, g, policy=CompressionPolicy.disabled(),
                                                 group=g)
    assert_equal_nan_as_nan(out, _plus_zero(jout), "bfloat16")
    assert_equal_nan_as_nan(out, x, "bfloat16")
    assert_equal_nan_as_nan(raw, x, "bfloat16")
    assert int(flag) == int(jflag) == 0
    assert [r.name for r in reports] == ["reduce_scatter", "reduce_scatter", "all_gather",
                                         "all_gather"]
    assert report_rows(reports) == report_rows(jreports)


@pytest.mark.parametrize("fused_encode", [True, False])
def test_single_rank_all_to_all_and_ppermute_match_reference(fused_encode):
    bits = _one_rank_bits(n=A2A_INNER)
    jpol = dataclasses.replace(JPOL, fused_encode=fused_encode)

    def body(v):
        a, fa = jcc.all_to_all_compressed(v[None], "data", policy=jpol)
        p, fp = jcc.ppermute_compressed(v, "data", [(0, 0)], policy=jpol)
        return a, p, fa, fp

    (ja, jp, jfa, jfp), jreports = _in_shard_map(body, to_jax(bits, "bfloat16"))
    x = to_torch(bits, "bfloat16")
    pol = dataclasses.replace(POL, fused_encode=fused_encode)
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        a, fa = cc.all_to_all_compressed(x[None], g, policy=pol)
        p, fp = cc.ppermute_compressed(x, [(0, 0)], g, policy=pol)
    assert_bits_equal(a, ja)
    assert_bits_equal(p, jp)
    assert_bits_equal(a[0], x)
    assert int(fa) == int(jfa) == int(fp) == int(jfp) == 0
    assert report_rows(reports) == report_rows(jreports)
    assert [r.encode_fused for r in reports] == [fused_encode] * 2


def _jax_tree(rank: int):
    return {k: jax.lax.bitcast_convert_type(jnp.asarray(np_of(t)),
                                            jnp.dtype(str(t.dtype).removeprefix("torch.")))
            for k, t in _psum_tree(rank).items()}


def test_single_rank_tree_psum_matches_reference():
    """A bf16 + f32 + int32 tree: one bucket a codec dtype, the int32 leaf
    through psum_safe."""
    (jout, jflag), jreports = _in_shard_map(
        lambda t: jcc.tree_psum_compressed(t, "data", policy=JPOL), _jax_tree(0))
    tree = _psum_tree(0)
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        out, flag = cc.tree_psum_compressed(tree, g, policy=POL)
    for k in tree:
        assert out[k].dtype == tree[k].dtype and out[k].shape == tree[k].shape, k
        if k == "step":
            assert_bits_equal(out[k], jout[k], k)
            assert_bits_equal(out[k], tree[k], k)
        else:
            fmt = str(tree[k].dtype)[6:]
            assert_equal_nan_as_nan(out[k], _plus_zero(jout[k]), fmt, k)
            assert_equal_nan_as_nan(out[k], tree[k], fmt, k)
    assert int(flag) == int(jflag) == 0
    # buckets in sorted dtype-name order: bfloat16, then float32
    assert [r.raw_bytes for r in reports] == [r.raw_bytes for r in jreports]
    assert report_rows(reports) == report_rows(jreports)


# ---------------------------------------------------------------------------
# the unfused encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,chunk", [(f, 512 * 6) for f in FORMATS]
                         + [(f, 512 * 2 + 70) for f in ("bfloat16", "float8_e5m2")])
def test_unfused_encode_equals_fused_and_reference(fmt, chunk):
    """The three-pass encode gives the reference's wire, fused or not; at a
    block multiple it equals the port's one-pass wire, and both decode."""
    bits = grad_like_bits(fmt, 3 * chunk, seed=31)
    x = to_torch(bits, fmt).reshape(3, chunk)
    kw = dict(width=5, block=BLOCK, exc_frac=0.02)
    wire = cc._encode_chunks(x, fused=False, **kw)
    jwire = _encode(to_jax(bits, fmt).reshape(3, chunk), fused=False, **kw)
    assert set(wire) == set(jwire)
    for k in jwire:
        assert_bits_equal(wire[k], jwire[k], k)
    assert cc.wire_nbytes(wire) == sched_compile.encoded_wire_bytes(
        3, chunk, x.dtype, **kw)
    vals, flag = cc._decode_chunks(wire, dtype=x.dtype, n=chunk, width=5, block=BLOCK)
    assert_bits_equal(vals, x)
    if chunk % BLOCK == 0:
        fused = cc._encode_chunks(x, **kw)
        for k in wire:
            assert_bits_equal(wire[k], fused[k], k)
            assert_bits_equal(fused[k], _encode(to_jax(bits, fmt).reshape(3, chunk),
                                                **kw)[k], k)
    else:
        # a deliberate difference: the reference records a fallback and
        # encodes unfused; the port's one-pass encode raises
        with pytest.raises(ValueError, match="multiple of block"):
            cc._encode_chunks(x, **kw)


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("acc_dtype", [torch.float32, torch.float64])
def test_unfused_reduce_scatter_matches_fused(use_fused, acc_dtype):
    """reduce_scatter_compressed with use_fused=False or a non-f32
    acc_dtype decodes and sums in rank order: the fused path's bits, and
    the reference's."""
    bits = _one_rank_bits()
    jacc = jnp.float32 if acc_dtype == torch.float32 else jnp.float64
    x = to_torch(bits, "bfloat16")
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        got, flag = cc.reduce_scatter_compressed(x, g, width=WIDTH, use_fused=use_fused,
                                                 acc_dtype=acc_dtype)
        fused, _ = cc.reduce_scatter_compressed(x, g, width=WIDTH)
    assert got.dtype == acc_dtype and int(flag) == 0
    assert_equal_nan_as_nan(got.float(), fused, "float32")
    (jred, _), jreports = _in_shard_map(
        lambda v: jcc.reduce_scatter_compressed(v, "data", width=WIDTH, use_fused=use_fused,
                                                acc_dtype=jacc), to_jax(bits, "bfloat16"))
    if acc_dtype == torch.float32:
        assert_equal_nan_as_nan(got, _plus_zero(jred), "float32")
    assert report_rows(reports[:1]) == report_rows(jreports)
    assert reports[0].fused == (use_fused and acc_dtype == torch.float32)


def test_unfused_encode_report_counts_its_split_planes():
    """A fused_encode=False wire records encode_fused=False with the
    split-plane round-trip it paid, 2 (1 + itemsize) bytes an element."""
    x = to_torch(_one_rank_bits(), "bfloat16")
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        cc.reduce_scatter_compressed(x, g, width=WIDTH, fused_encode=False)
        cc.all_gather_compressed(x, g, width=WIDTH, fused_encode=False)
        cc.all_gather_compressed(x, g, width=WIDTH)
    n_pad = -(-PSUM_N // BLOCK) * BLOCK
    assert [(r.encode_fused, r.encode_hbm_bytes) for r in reports] == [
        (False, 2 * 3 * n_pad), (False, 2 * 3 * n_pad), (True, 2 * 3 * n_pad)]


# ---------------------------------------------------------------------------
# 2 and 4 ranks
# ---------------------------------------------------------------------------

_RUNS: dict = {}


def _run(k: int, tmp_path_factory) -> list:
    """Each rank count's results, run once a module."""
    if k not in _RUNS:
        _RUNS[k] = run_gloo_ranks(psum_rank, k, tmp_path_factory.mktemp(f"psum{k}"))
    return _RUNS[k]


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    return request.param, _run(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _run(4, tmp_path_factory)


def _inputs(k):
    return [to_torch(psum_bits(r), "bfloat16") for r in range(k)]


_MODELS: dict = {}


def _models(k: int, algorithm: str) -> tuple:
    """(rank-order model, reference composition) of the k-rank psum, made
    once for all the variants of an algorithm."""
    if (k, algorithm) not in _MODELS:
        xs, bits = _inputs(k), [psum_bits(r) for r in range(k)]
        _MODELS[k, algorithm] = (
            (ring_model(xs, k), ref_ring(bits, "bfloat16")) if algorithm == "ring" else
            (rank_order_sum(xs).to(torch.bfloat16), ref_two_shot(bits, "bfloat16")))
    return _MODELS[k, algorithm]


@pytest.mark.parametrize("variant", sorted(PSUM_VARIANTS))
def test_multi_rank_psum_compressed(ranks, variant):
    """Two-shot (fused, unfused encode, unfused decode): the rank-order f32
    sum, the raw twin's and the reference's two-shot; ring: the ring's own
    per-hop rounding, the reference's ring composed hop by hop."""
    k, res = ranks
    algorithm = "ring" if variant.startswith("ring") else "two_shot"
    model, ref = _models(k, algorithm)
    for r in range(k):
        got = res[r][f"psum_{variant}"]
        assert res[r][f"flag_{variant}"] == 0
        assert_equal_nan_as_nan(got, model, "bfloat16", (variant, r))
        assert_equal_nan_as_nan(got, ref, "bfloat16", (variant, r, "reference"))
        if not variant.startswith("ring"):
            assert_bits_equal(got, res[r]["raw_twoshot"], (variant, r, "raw twin"))
            assert_bits_equal(got, res[0][f"psum_{variant}"])


def test_multi_rank_reports_match_the_compiled_plans(ranks):
    """Each variant's WireReports sum to the psum plan's expected bytes (the
    compiler the sched tests hold against the reference's), and the
    unfused variants record what they paid."""
    k, res = ranks
    meta = {"x": torch.empty(PSUM_N, dtype=torch.bfloat16, device="meta")}
    for variant, kw in PSUM_VARIANTS.items():
        plan = sched_compile.compile_psum_plan(
            meta, "data", policy=dataclasses.replace(POL, **kw), n_dev=k, device="cpu")
        rows = json.loads(str(res[0][f"reports_{variant}"]))
        wire = dict(zip(REPORT_FIELDS, zip(*rows)))
        assert (sum(wire["raw_bytes"]), sum(wire["wire_bytes"])) == (
            plan.raw_bytes, plan.wire_bytes), variant
        assert set(wire["encode_fused"]) == {kw.get("fused_encode", True)}
        n_hops = 2 * (k - 1) if variant.startswith("ring") else 2
        assert len(rows) == n_hops


def test_multi_rank_raw_paths(ranks):
    """psum_raw_twoshot: the rank-order sum; psum_safe on sums exact in any
    order; the gated-off psum_compressed is the raw two-shot."""
    k, res = ranks
    xs = _inputs(k)
    es = [torch.from_numpy(exact_f32(r, 3000)) for r in range(k)]
    want = rank_order_sum(xs).to(torch.bfloat16)
    exact = rank_order_sum(es)
    for r in range(k):
        assert_equal_nan_as_nan(res[r]["raw_twoshot"], want, "bfloat16", r)
        assert_bits_equal(res[r]["gated_raw"], res[r]["raw_twoshot"], r)
        assert_bits_equal(res[r]["raw_twoshot_f32"], exact, r)
        assert_bits_equal(res[r]["safe_f32"], exact, r)
        assert_bits_equal(res[r]["safe_bf16"], rank_order_sum(
            [e.to(torch.bfloat16) for e in es]).to(torch.bfloat16), r)


def test_multi_rank_all_to_all(ranks):
    """Row j of rank r's result is row r of rank j's input, bit for bit,
    compressed (fused and unfused encode) or raw; each rank's received wire
    is the reference's encode of those rows."""
    k, res = ranks
    rows = [x[: k * A2A_INNER].reshape(k, A2A_INNER) for x in _inputs(k)]
    for r in range(k):
        want = torch.stack([rows[j][r] for j in range(k)])
        for tag in ("a2a", "a2a_unfused", "a2a_raw"):
            assert_bits_equal(res[r][tag], want, (tag, r))
            assert res[r][f"flag_{tag}"] == 0
    jrows = [jnp.stack([_pad_jax(to_jax(np_of(rows[j][r]), "bfloat16"), BLOCK)
                        for r in range(k)]) for j in range(k)]
    jwires = [_encode(j, width=POL.width_for("activation"), block=BLOCK,
                                 exc_frac=0.02) for j in jrows]
    recv = {key: jnp.stack([w[key][0] for w in jwires]) for key in jwires[0]}
    vals, _ = _decode(recv, dtype=jnp.bfloat16, n=jrows[0].shape[1],
                                 width=POL.width_for("activation"), block=BLOCK)
    assert_bits_equal(res[0]["a2a"], np.asarray(vals)[:, :A2A_INNER])


def test_multi_rank_ppermute(ranks):
    """A ring shift delivers rank r - 1's tensor; with one pair (0 -> k-1)
    only the target receives, and every other rank gets zeros."""
    k, res = ranks
    xs = _inputs(k)
    w = POL.width_for("weight")
    jwire = _encode(_pad_jax(to_jax(np_of(xs[k - 1]), "bfloat16"), BLOCK)[None],
                               width=w, block=BLOCK, exc_frac=0.02)
    jvals, _ = _decode(jwire, dtype=jnp.bfloat16, n=-(-PSUM_N // BLOCK) * BLOCK,
                                  width=w, block=BLOCK)
    for r in range(k):
        for tag in ("pp_shift", "pp_raw"):
            assert_bits_equal(res[r][tag], xs[(r - 1) % k], (tag, r))
        want = xs[0] if r == k - 1 else torch.zeros(PSUM_N, dtype=torch.bfloat16)
        assert_bits_equal(res[r]["pp_pair"], want, r)
    # the reference's pad is a float copy, which drops bf16 NaN payloads
    assert_equal_nan_as_nan(res[0]["pp_shift"], np.asarray(jvals)[0, :PSUM_N], "bfloat16")


def test_multi_rank_tree_psum_and_psum_with_plan(ranks):
    """tree_psum_compressed and psum_with_plan on a bf16 + f32 + int32
    tree: the rank-order sum of each leaf at its own dtype (the int32 and
    small-f32 leaves' sums are exact in any order), the same bits from both,
    and the plan's one consolidated report of the per-bucket wires."""
    from repro_torch.tree_util import tree_flatten

    k, res = ranks
    leaves = [tree_flatten(_psum_tree(r))[0] for r in range(k)]
    for i in range(len(leaves[0])):
        parts = [lv[i] for lv in leaves]
        dt = parts[0].dtype
        want = (sum(p.to(torch.int64) for p in parts).to(dt) if dt == torch.int32
                else rank_order_sum(parts).to(dt))
        for r in range(k):
            if dt == torch.int32:
                assert_bits_equal(res[r][f"tree_{i}"], want, (i, r))
            else:
                assert_equal_nan_as_nan(res[r][f"tree_{i}"], want, str(dt)[6:], (i, r))
            assert_bits_equal(res[r][f"plan_{i}"], res[r][f"tree_{i}"], (i, r))
    tree_rows = json.loads(str(res[0]["reports_tree"]))
    (plan_row,) = json.loads(str(res[0]["reports_plan"]))
    assert plan_row[0] == "plan:psum"
    assert plan_row[1:3] == [sum(r[1] for r in tree_rows), sum(r[2] for r in tree_rows)]


def test_four_rank_hierarchical(ranks4):
    """2 pods x 2 data ranks: the intra-pod reduce-scatter, the cross-pod
    two-shot of the shards and the intra-pod all-gather, against the
    rank-order sums of each level and the reference's codec composed; the
    unfused variant gives the same bits; the raw path sums exactly."""
    res = ranks4
    xs = _inputs(4)
    bits = [psum_bits(r) for r in range(4)]
    chunk = -(-PSUM_N // (2 * BLOCK)) * BLOCK
    shard_bits = {}  # (pod, data) -> the bf16 shard after the intra level
    for p in range(2):
        pod = [xs[2 * p + d] for d in range(2)]
        rows = [cc._pad_flat(x, 2 * BLOCK).reshape(2, -1) for x in pod]
        jred = ref_reduce_scatter([bits[2 * p], bits[2 * p + 1]], "bfloat16", WIDTH)
        for d in range(2):
            s = rank_order_sum([rw[d] for rw in rows])
            assert_equal_nan_as_nan(s, _plus_zero(jred[d]), "float32", (p, d))
            shard_bits[p, d] = np_of(s.to(torch.bfloat16))
    full = {}
    for d in range(2):
        sb = [shard_bits[p, d] for p in range(2)]
        model = rank_order_sum([to_torch(b, "bfloat16") for b in sb])
        reds = ref_reduce_scatter(sb, "bfloat16", WIDTH)
        gathered = np.asarray(ref_all_gather([r.astype(jnp.bfloat16) for r in reds],
                                             "bfloat16", WIDTH)).reshape(-1)[:chunk]
        assert_equal_nan_as_nan(gathered, model.to(torch.bfloat16), "bfloat16", d)
        full[d] = model.to(torch.bfloat16)
    want = torch.cat([full[0], full[1]])[:PSUM_N]
    exact = rank_order_sum([torch.from_numpy(exact_f32(r, 3000)) for r in range(4)])
    for r in range(4):
        assert res[r]["flag_hier"] == 0
        assert_equal_nan_as_nan(res[r]["hier"], want, "bfloat16", r)
        assert_bits_equal(res[r]["hier_unfused"], res[r]["hier"], r)
        assert_bits_equal(res[r]["hier_raw_f32"], exact, r)
