#!/usr/bin/env python3
"""Time the redesigned bit-plane kernels of this checkout beside those of an
earlier checkout, in one run on one CUDA card.

    python3 tools/ab_kernels.py --parent DIR [--rounds N]

DIR holds an earlier commit's tree (``git archive <commit> | tar -x -C
DIR``).  Each tree runs in a process of its own, ``--rounds`` times
(default 2) in the order earlier, current, current, earlier, then
current, earlier, earlier, current, and so on, through its own wrappers (``encode_fused.encode_fused(x, width, block)``,
``bitpack.unpack(words, width)``, ``decode_reduce.decode_reduce(...)``)
and, for pack, the entry point every path packs through
(``packing.bitplane_pack(vals, width)``), which build its kernels into its
own ``kernels/build/``.  At the main paths' shapes each process holds its
kernels against their plain versions, digests their outputs, and times
them with ``chip_smoke._time`` over WINDOWS windows: one call a window, as
the ``kernels`` line is timed, and 10 back-to-back calls a window, which
hide the device time behind the host's and so read the larger of the two.
A torch.profiler trace of 10 back-to-back calls, after one trace to warm
the profiler up, gives each kernel's own device time a launch, averaged
over the launches the trace shows (None if it shows none).  The shapes:

* the all-gather bucket (bf16, n = 134 515 200, block 512, width 5):
  encode_fused; decode_reduce of its wire into an f32 accumulator; unpack
  of its payload (width 5) and lo plane (width 8);
* one KV leaf (bf16, n = 5 898 240): unpack of its payload at width 5, and
  pack of its uint8 exponent residuals (width 5) and int32 lo plane
  (width 8);
* a weight-sync XOR delta of the bucket (30% of its values with a few low
  bits flipped): pack of its uint8 exponent residuals and its int32 lo
  delta at the widths the sync run calibrates (5 and 6; PERF.md).

Prints one ``ab:`` line a shape and a last JSON line with every time, the
bound (bytes over the card's memory bandwidth), whether both trees gave the
same outputs, and the card's name and power limit.
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
SYNC_WIDTHS = (5, 6)  # exponent, lo: the sync run's calibrated delta widths
BACK_TO_BACK = 10
WINDOWS = 100
ROUND = (("earlier", "current", "current", "earlier"), ("current", "earlier", "earlier", "current"))


def device_ms(fn, kernel: str, torch):
    """Device ms a launch of the CUDA kernel whose name holds ``kernel``,
    from a torch.profiler trace of BACK_TO_BACK calls of ``fn``; None when
    the trace shows none of its launches; also the launches it shows.  The
    first trace of a process can show no device time, so a trace is taken
    twice and the second read."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(BACK_TO_BACK):
                fn()
            torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            us += getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            count += e.count
    return (us / 1e3 / count if count and us > 0 else None), count


def worker() -> None:
    """One tree (the ``repro_torch`` on PYTHONPATH): check, digest, time and
    profile each shape; print one JSON line."""
    import numpy as np
    import torch

    from repro_torch.core import codec, packing
    from repro_torch.kernels import bitpack, ref
    from repro_torch.kernels import decode_reduce as dr
    from repro_torch.kernels import encode_fused as ef

    sys.path.insert(0, ROOT)
    import chip_smoke  # after repro_torch: it puts this checkout's src/ first

    gen = np.random.default_rng(0)
    x = torch.from_numpy(gen.normal(0, 0.02, AG_N).astype(np.float32)).cuda().bfloat16()
    kv = torch.from_numpy(gen.normal(0, 0.5, KV_N).astype(np.float32)).cuda().bfloat16()
    pay, lo, bases, _ = ef.encode_fused(x, WIDTH, BLOCK)
    gb = bases.repeat_interleave(BLOCK // packing.GROUP)
    acc = torch.from_numpy(gen.normal(0, 1e-3, AG_N).astype(np.float32)).cuda()
    work = acc.clone()
    kv_pay = ef.encode_fused(kv, WIDTH, BLOCK)[0]
    kv_exp, kv_lo = codec.split_planes(kv)
    kv_resid = packing.block_residuals(kv_exp, width=WIDTH, block=BLOCK)[3]
    flip = gen.integers(0, 8, AG_N).astype(np.int16)
    flip[gen.random(AG_N) > 0.3] = 0
    d_exp, d_lo = codec.split_planes(codec.xor_delta(
        (x.view(torch.int16) ^ torch.from_numpy(flip).cuda()).view(torch.bfloat16), x))
    d_resid = packing.block_residuals(d_exp, width=SYNC_WIDTHS[0], block=BLOCK)[3]
    d_lo = torch.where(packing._as_u32(d_lo) <= (1 << SYNC_WIDTHS[1]) - 1, d_lo, 0)

    def packs(vals, w):  # (time, check, plain, kernel name, bytes)
        return (lambda: packing.bitplane_pack(vals, w), lambda: [packing.bitplane_pack(vals, w)],
                lambda: [ref.pack(vals, w)], "::pack_kernel",
                vals.numel() * vals.element_size() + vals.numel() // 32 * w * 4)

    def unpacks(words, w):
        return (lambda: bitpack.unpack(words, w), lambda: [bitpack.unpack(words, w)],
                lambda: [ref.unpack(words, w)], "::unpack_kernel",
                words.shape[0] * w * 4 + words.shape[0] * 128)

    cases = {
        "encode_fused AG bucket": (
            lambda: ef.encode_fused(x, WIDTH, BLOCK), lambda: ef.encode_fused(x, WIDTH, BLOCK),
            lambda: ref.encode_fused(x, WIDTH, BLOCK), "encode_fused_kernel",
            AG_N * 2 + AG_N // 32 * (WIDTH + 8) * 4 + AG_N // BLOCK * 8),
        "decode_reduce AG bucket W5": (
            lambda: dr.decode_reduce(pay, lo, gb, work, "bfloat16", WIDTH),
            lambda: [dr.decode_reduce(pay, lo, gb, acc.clone(), "bfloat16", WIDTH)],
            lambda: [ref.decode_reduce(pay, lo, gb, acc, "bfloat16", WIDTH)],
            "decode_reduce_kernel", AG_N // 32 * (WIDTH + 8 + 1) * 4 + AG_N * 8),
        "unpack AG payload W5": unpacks(pay, WIDTH),
        "unpack AG lo plane W8": unpacks(lo, lo.shape[1]),
        "unpack KV leaf W5": unpacks(kv_pay, WIDTH),
        "pack KV residuals uint8 W5": packs(kv_resid, WIDTH),
        "pack KV lo plane int32 W8": packs(kv_lo, 8),
        f"pack sync exponent residuals uint8 W{SYNC_WIDTHS[0]}": packs(d_resid, SYNC_WIDTHS[0]),
        f"pack sync lo delta int32 W{SYNC_WIDTHS[1]}": packs(d_lo, SYNC_WIDTHS[1]),
    }
    out = {"tree": os.path.dirname(os.path.dirname(bitpack.__file__))}
    for name, (timed, kernel, plain, kname, nbytes) in cases.items():
        dev_ms, traced = device_ms(timed, kname, torch)
        got = kernel()
        digest = hashlib.sha256()
        for t in got:
            digest.update(t.cpu().numpy().tobytes())
        out[name] = {"plain_equal": all(torch.equal(a, b) for a, b in zip(got, plain())),
                     "digest": digest.hexdigest(), "bytes": nbytes,
                     "one_call_ms": chip_smoke._time(timed, torch, runs=WINDOWS),
                     "back_to_back_ms": chip_smoke._time(timed, torch, runs=WINDOWS,
                                                         reps=BACK_TO_BACK),
                     "profile_device_ms": dev_ms, "profile_launches": traced}
    print(json.dumps(out))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def run_trees(script: str, parent: str, rounds: int) -> dict:
    """``script --worker`` run once a process, each under one tree's
    ``src`` (the earlier tree ``parent``, the current one this checkout's),
    ``rounds`` rounds in ROUND's orders; returns each tree's worker results
    (the last JSON line of each run, without its ``tree`` key)."""
    trees = {"earlier": os.path.abspath(parent), "current": ROOT}
    runs = {"earlier": [], "current": []}
    for which in [w for r in range(rounds) for w in ROUND[r % 2]]:
        env = dict(os.environ, PYTHONPATH=os.path.join(trees[which], "src"))
        proc = subprocess.run([sys.executable, script, "--worker"],
                              env=env, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise RuntimeError(f"{which} tree: worker exit {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        if os.path.realpath(res.pop("tree")) != os.path.realpath(
                os.path.join(trees[which], "src", "repro_torch")):
            raise RuntimeError(f"{which} worker imported another tree's repro_torch")
        runs[which].append(res)
    return runs


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
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = card()
    print(smi)
    runs = run_trees(os.path.abspath(__file__), args.parent, args.rounds)

    bw = chip_smoke.card_bandwidth(torch.cuda.get_device_name(0))
    rows, failed = {}, []
    for name in runs["current"][0]:
        every = runs["earlier"] + runs["current"]
        same = len({r[name]["digest"] for r in every}) == 1
        if not same or not all(r[name]["plain_equal"] for r in every):
            failed.append(name)
        nb = runs["current"][0][name]["bytes"]
        row = {"bound_ms": nb / bw * 1e3, "bytes": nb, "identical": same}
        for which, rs in runs.items():
            for key in ("one_call_ms", "back_to_back_ms", "profile_device_ms",
                        "profile_launches"):
                row[f"{which}_{key}"] = [r[name][key] for r in rs]
        rows[name] = row
        print(f"ab: {name}: one call a window, earlier {row['earlier_one_call_ms']} ms, "
              f"current {row['current_one_call_ms']} ms; {BACK_TO_BACK} back to back, "
              f"earlier {row['earlier_back_to_back_ms']} ms, current "
              f"{row['current_back_to_back_ms']} ms; profiler device ms a launch, earlier "
              f"{row['earlier_profile_device_ms']}, current "
              f"{row['current_profile_device_ms']}; bound {row['bound_ms']:.4f} ms; "
              f"outputs identical {same}")
    print(json.dumps({"card": smi, "rows": rows, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
