#!/usr/bin/env python3
"""Where tier-1's time goes in the port's multi-process test fixtures.

A mesh fixture runs the JAX reference in a subprocess on 4 forced host
devices (``tests/torch_port_util.run_reference``) and then the port on
gloo ranks (``run_gloo_ranks``).  This tool times the two halves apart.

As a pytest plugin (``-p tier1_split`` with ``tools`` on the path) it
appends one JSON line to ``$TIER1_SPLIT_LOG`` for every reference
subprocess and every set of gloo ranks: which half, the kind or the
worker, the test file and the seconds.  ``table`` sums a junit file's
seconds (the port's ``test_torch_*`` files and all), and with a log the
two halves by test file beside each file's junit seconds::

    TIER1_SPLIT_LOG=/tmp/split.jsonl PYTHONPATH=src:tools python -m pytest -q \\
        -p xdist -n 6 --dist loadfile -p tier1_split --junitxml=/tmp/t1.xml tests/...
    python tools/tier1_split.py table /tmp/t1.xml /tmp/split.jsonl

``refs`` runs each kind's reference subprocess alone, one after another, in
the environment the fixtures give it, and prints its seconds and its JAX
persistent-cache hits and misses.  With ``--shared`` the kinds share one
cache, as the subprocesses of one pytest run do; without it each kind has a
cache of its own, empty at its start.  ``--xla-flags`` adds XLA flags.
``same A B`` says, for each kind, whether two ``refs --out`` directories
hold the same bits::

    PYTHONPATH=src python tools/tier1_split.py refs --out /tmp/a dp_only tp
    PYTHONPATH=src python tools/tier1_split.py refs --out /tmp/b --shared dp_only tp
    python tools/tier1_split.py same /tmp/a /tmp/b
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import re
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

TESTS = Path(__file__).resolve().parents[1] / "tests"


def _logged(fn, half: str, kind_at: int):
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            of = args[0].__name__ if half == "ranks" else args[kind_at]
            line = {"half": half, "of": of, "s": time.perf_counter() - t0,
                    "file": os.environ.get("PYTEST_CURRENT_TEST", "").split("::")[0]}
            with open(os.environ["TIER1_SPLIT_LOG"], "a") as f:
                f.write(json.dumps(line) + "\n")
    return timed


def pytest_configure(config):
    """Wrap the fixtures' two halves before any test module imports them."""
    sys.path.insert(0, str(config.rootpath / "tests"))
    import torch_port_util as u

    u.run_gloo_ranks = _logged(u.run_gloo_ranks, "ranks", 0)
    if hasattr(u, "run_reference"):
        # before torch_mesh_serve_util imports it; the run_mesh_*_reference
        # helpers call it
        u.run_reference = _logged(u.run_reference, "ref", 2)
        return
    import torch_mesh_serve_util as serve_util  # a tree from before they shared it

    for m, name in ((u, "run_mesh_reference"), (u, "run_mesh_tp_reference"),
                    (serve_util, "run_mesh_serve_reference")):
        setattr(m, name, _logged(getattr(m, name), "ref", 0))


def table(junit: str, log: str = None) -> None:
    secs = collections.Counter()
    for case in ET.parse(junit).getroot().iter("testcase"):
        secs[case.get("classname").split(".")[-1]] += float(case.get("time", 0))
    port = sum(v for k, v in secs.items() if k.startswith("test_torch_"))
    print(f"junit: test_torch_* {port:.1f} s, all {sum(secs.values()):.1f} s")
    if log is None:
        return
    split = collections.defaultdict(collections.Counter)
    for line in open(log):
        r = json.loads(line)
        split[Path(r["file"]).stem][r["half"]] += r["s"]
    print(f"{'file':40s} {'junit s':>9s} {'ref s':>8s} {'ranks s':>8s}")
    for f in sorted(split, key=lambda f: -secs[f]):
        print(f"{f:40s} {secs[f]:9.1f} {split[f]['ref']:8.1f} {split[f]['ranks']:8.1f}")
    print(f"reference subprocesses {sum(c['ref'] for c in split.values()):.1f} s, "
          f"gloo ranks {sum(c['ranks'] for c in split.values()):.1f} s")


def _reference_of(kind: str) -> tuple:
    import torch_mesh_serve_util as serve_util
    import torch_port_util as u

    if kind in u.TP_RUNS:
        return "torch_port_util", "mesh_tp_reference"
    if kind in serve_util.SERVE_MESHES:
        return "torch_mesh_serve_util", "mesh_serve_reference"
    return "torch_port_util", "mesh_reference"


def refs(out: str, kinds: list, shared: bool, xla_flags: str) -> None:
    sys.path.insert(0, str(TESTS))
    import torch_port_util as u

    for kind in kinds:
        # reference_env puts the cache beside out_dir: one parent for all
        # kinds shares it
        out_dir = Path(out) / ("shared" if shared else kind) / kind
        out_dir.mkdir(parents=True)
        env = u.reference_env(out_dir)
        env["XLA_FLAGS"] += f" {xla_flags}" if xla_flags else ""
        env["JAX_DEBUG_LOG_MODULES"] = "jax._src.compiler"
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c",
                              u.reference_code(*_reference_of(kind), kind, out_dir)],
                             env=env, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        if res.returncode:
            raise SystemExit(f"{kind}: exit {res.returncode}\n{res.stderr[-3000:]}")
        hits = len(re.findall("Persistent compilation cache hit", res.stderr))
        misses = len(re.findall("PERSISTENT COMPILATION CACHE MISS", res.stderr))
        print(json.dumps({"kind": kind, "s": round(secs, 2), "hits": hits, "misses": misses}),
              flush=True)


def same(a: str, b: str) -> None:
    import numpy as np

    for npz in sorted(Path(a).glob("*/*/ref.npz")):
        other = np.load(next(Path(b).glob(f"*/{npz.parent.name}/ref.npz")))
        mine = np.load(npz)
        differ = [k for k in mine.files
                  if k not in other.files or mine[k].tobytes() != other[k].tobytes()]
        print(f"{npz.parent.name}: {len(differ)} of {len(mine.files)} arrays differ {differ[:6]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("table")
    t.add_argument("junit")
    t.add_argument("log", nargs="?")
    r = sub.add_parser("refs")
    r.add_argument("--out", required=True)
    r.add_argument("--shared", action="store_true")
    r.add_argument("--xla-flags", default="")
    r.add_argument("kinds", nargs="+")
    s = sub.add_parser("same")
    s.add_argument("a")
    s.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "table":
        table(args.junit, args.log)
    elif args.cmd == "refs":
        refs(args.out, args.kinds, args.shared, args.xla_flags)
    else:
        same(args.a, args.b)


if __name__ == "__main__":
    main()
