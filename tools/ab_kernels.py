#!/usr/bin/env python3
"""Time the encode_fused and unpack kernels of this checkout beside those of
an earlier checkout, in one run on one CUDA card.

    python3 tools/ab_kernels.py --parent DIR

DIR holds an earlier commit's tree (``git archive <commit> | tar -x -C
DIR``).  Each tree runs in a process of its own, in the order earlier,
current, current, earlier, through its own wrappers
(``encode_fused.encode_fused(x, width, block)``, ``bitpack.unpack(words,
width)``), which build its kernels into its own ``kernels/build/``.  At the
main paths' shapes (the all-gather bucket: bf16, n = 134 515 200, block
512, width 5; its payload at width 5 and lo plane at width 8; one KV
leaf's payload, n = 5 898 240, width 5) each process holds its kernels
against its plain versions, digests their outputs, and times them with
``chip_smoke._time``: one call a window, as the ``kernels`` line is timed,
and windows of 10 back-to-back calls, which leave out the host's time
before a launch.  Prints one ``ab:`` line a shape and a last JSON line with
every time, the bound (bytes over the card's memory bandwidth), whether
both trees gave the same outputs, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AG_N, KV_N, BLOCK, WIDTH = 134_515_200, 5_898_240, 512, 5
BACK_TO_BACK = 10


def worker() -> None:
    """One tree (the ``repro_torch`` on PYTHONPATH): check, digest and time
    each shape; print one JSON line."""
    import numpy as np
    import torch

    from repro_torch.kernels import bitpack, ref
    from repro_torch.kernels import encode_fused as ef

    sys.path.insert(0, ROOT)
    import chip_smoke  # after repro_torch: it puts this checkout's src/ first

    gen = np.random.default_rng(0)
    x = torch.from_numpy(gen.normal(0, 0.02, AG_N).astype(np.float32)).cuda().bfloat16()
    kv = torch.from_numpy(gen.normal(0, 0.5, KV_N).astype(np.float32)).cuda().bfloat16()
    pay, lo, _, _ = ef.encode_fused(x, WIDTH, BLOCK)
    kv_pay = ef.encode_fused(kv, WIDTH, BLOCK)[0]
    cases = {
        "encode_fused AG bucket": (lambda: ef.encode_fused(x, WIDTH, BLOCK),
                                   lambda: ref.encode_fused(x, WIDTH, BLOCK)),
        "unpack AG payload W5": (lambda: [bitpack.unpack(pay, WIDTH)],
                                 lambda: [ref.unpack(pay, WIDTH)]),
        "unpack AG lo plane W8": (lambda: [bitpack.unpack(lo, lo.shape[1])],
                                  lambda: [ref.unpack(lo, lo.shape[1])]),
        "unpack KV leaf W5": (lambda: [bitpack.unpack(kv_pay, WIDTH)],
                              lambda: [ref.unpack(kv_pay, WIDTH)]),
    }
    out = {"tree": os.path.dirname(os.path.dirname(bitpack.__file__))}
    for name, (kernel, plain) in cases.items():
        got = kernel()
        digest = hashlib.sha256()
        for t in got:
            digest.update(t.cpu().numpy().tobytes())
        out[name] = {"plain_equal": all(torch.equal(a, b) for a, b in zip(got, plain())),
                     "digest": digest.hexdigest(),
                     "one_call_ms": chip_smoke._time(kernel, torch),
                     "back_to_back_ms": chip_smoke._time(kernel, torch, reps=BACK_TO_BACK)}
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier commit's tree")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker()
        return 0
    if not args.parent:
        ap.error("--parent is required")
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    trees = {"earlier": os.path.abspath(args.parent), "current": ROOT}
    runs = {"earlier": [], "current": []}
    for which in ("earlier", "current", "current", "earlier"):
        env = dict(os.environ, PYTHONPATH=os.path.join(trees[which], "src"))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"],
                              env=env, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise RuntimeError(f"{which} tree: worker exit {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        if os.path.realpath(res.pop("tree")) != os.path.realpath(
                os.path.join(trees[which], "src", "repro_torch")):
            raise RuntimeError(f"{which} worker imported another tree's repro_torch")
        runs[which].append(res)

    bw = chip_smoke.card_bandwidth(torch.cuda.get_device_name(0))
    nbytes = {"encode_fused AG bucket": (AG_N * 2 + AG_N // 32 * (WIDTH + 8) * 4
                                         + AG_N // BLOCK * 8),
              "unpack AG payload W5": AG_N // 32 * WIDTH * 4 + AG_N * 4,
              "unpack AG lo plane W8": AG_N // 32 * 8 * 4 + AG_N * 4,
              "unpack KV leaf W5": KV_N // 32 * WIDTH * 4 + KV_N * 4}
    rows, failed = {}, []
    for name, nb in nbytes.items():
        every = runs["earlier"] + runs["current"]
        same = len({r[name]["digest"] for r in every}) == 1
        if not same or not all(r[name]["plain_equal"] for r in every):
            failed.append(name)
        row = {"bound_ms": nb / bw * 1e3, "bytes": nb, "identical": same}
        for which, rs in runs.items():
            for key in ("one_call_ms", "back_to_back_ms"):
                row[f"{which}_{key}"] = [r[name][key] for r in rs]
        rows[name] = row
        print(f"ab: {name}: one call a window, earlier {row['earlier_one_call_ms']} ms, "
              f"current {row['current_one_call_ms']} ms; {BACK_TO_BACK} back to back, "
              f"earlier {row['earlier_back_to_back_ms']} ms, current "
              f"{row['current_back_to_back_ms']} ms; bound {row['bound_ms']:.4f} ms; "
              f"outputs identical {same}")
    print(json.dumps({"card": smi, "rows": rows, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
