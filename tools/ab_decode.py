#!/usr/bin/env python3
"""Time the all-gather decode of this checkout beside that of an earlier
checkout, in one run on one CUDA card.

    python3 tools/ab_decode.py --parent DIR [--rounds N]

DIR holds an earlier commit's tree (``git archive <commit> | tar -x -C
DIR``).  The processes run as ``tools/ab_kernels.py``'s do: each tree in
processes of its own, in the order earlier, current, current, earlier, then
current, earlier, earlier, current, ``--rounds`` times (default 2).  A
process encodes each wire through its own tree
(``compressed_collectives._encode_chunks``, the encode_fused kernel), then
decodes it with ``compressed_collectives._decode_chunks`` (the unpack
kernel on the payload and the lo plane, then the zero-escape decode and
the merge in plain PyTorch), digests the output, and times the decode as
``chip_smoke.py``'s fsdp phase does: host clock to a device sync, median of
WINDOWS calls after a warm-up.  The shapes (bf16, weights drawn from
N(0, 0.02), width 5, block 512):

* the four gather signatures of the fsdp phase (smollm-135m at one rank):
  1536 x 576, 192 x 576, 576 x 576 and 49152 x 576, all-gathered 360, 240,
  240 and 2 times a step;
* the main path's ZeRO-1 all-gather bucket, 134 515 200 values.

Prints one ``ab:`` line a shape, the AG decodes of an FSDP step (each
signature's median times its all-gathers) for each tree and process, and a
last JSON line with every time, whether every process gave the same
outputs, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ab_kernels import card, run_trees  # noqa: E402

WIDTH, BLOCK, EXC_FRAC = 5, 512, 0.02
WINDOWS = 21
FSDP_SHAPES = {"fsdp 1536x576": (1536 * 576, 360), "fsdp 192x576": (192 * 576, 240),
               "fsdp 576x576": (576 * 576, 240), "fsdp 49152x576": (49152 * 576, 2)}
ZERO1_N = 134_515_200


def worker() -> None:
    """One tree (the ``repro_torch`` on PYTHONPATH): encode, decode, digest
    and time each shape; print one JSON line."""
    import numpy as np
    import torch

    from repro_torch.core import compressed_collectives as cc

    gen = np.random.default_rng(0)
    out = {"tree": os.path.dirname(os.path.dirname(cc.__file__))}
    shapes = {**{k: n for k, (n, _) in FSDP_SHAPES.items()}, "zero1 bucket": ZERO1_N}
    for name, n in shapes.items():
        x = torch.from_numpy(gen.normal(0, 0.02, n).astype(np.float32)).cuda().bfloat16()
        wire = cc._encode_chunks(x[None], width=WIDTH, block=BLOCK, exc_frac=EXC_FRAC)

        def decode():
            return cc._decode_chunks(wire, dtype=x.dtype, n=n, width=WIDTH, block=BLOCK)

        vals, flag = decode()
        torch.cuda.synchronize()
        times = []
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            decode()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"exact": bool(torch.equal(vals[0].view(torch.int16), x.view(torch.int16))),
                     "overflow": int(flag),
                     "digest": hashlib.sha256(vals.cpu().view(torch.int16).numpy()
                                              .tobytes()).hexdigest(),
                     "ms": sorted(times)[WINDOWS // 2]}
        del x, wire, vals
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier commit's tree")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of four processes, two a tree (default 2)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker()
        return 0
    if not args.parent:
        ap.error("--parent is required")
    import torch

    if not torch.cuda.is_available():
        print("ab_decode: needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = card()
    print(smi)
    runs = run_trees(os.path.abspath(__file__), args.parent, args.rounds)
    rows, failed = {}, []
    for name in runs["current"][0]:
        every = runs["earlier"] + runs["current"]
        same = len({r[name]["digest"] for r in every}) == 1
        if not same or not all(r[name]["exact"] and r[name]["overflow"] == 0 for r in every):
            failed.append(name)
        rows[name] = {"identical": same, **{which: [r[name]["ms"] for r in rs]
                                           for which, rs in runs.items()}}
        print(f"ab: {name}: decode ms, earlier {rows[name]['earlier']}, current "
              f"{rows[name]['current']}; outputs identical and exact {name not in failed}")
    step = {which: [sum(r[k]["ms"] * a for k, (_, a) in FSDP_SHAPES.items()) for r in rs]
            for which, rs in runs.items()}
    print(f"ab: AG decodes of an FSDP step (842 all-gathers), ms a process: earlier "
          f"{[round(t, 1) for t in step['earlier']]}, current "
          f"{[round(t, 1) for t in step['current']]}")
    print(json.dumps({"card": smi, "rows": rows, "fsdp_step_ag_decode_ms": step,
                      "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
