"""The kernels' build and ``chip_smoke.py``'s tp phase alone, on the card.

    python3 tools/tp_alone.py [--jobs tp_xlstm,tp_jamba_fsdp] \\
        [--optimizer adamw] [--pattern 3]

``--jobs`` picks TP_JOBS entries (default all); ``--optimizer`` and
``--pattern`` (pattern positions, comma-separated) override the picked
jobs' own, to measure a variant (a rank that outgrows its cap fails its
job with the allocator's numbers on stderr).  Each job runs as the phase
runs it; a failed job is reported and the next one still runs.  Exits 1
if any job failed.
"""
import argparse
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", default=",".join(cs.TP_JOBS))
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--pattern", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch import kernels

    dev = kernels.resolve_device("cuda")
    cs.phase_build(kernels, torch)
    bw = cs.card_bandwidth(torch.cuda.get_device_name(0))
    jobs, failed = dict(cs.TP_JOBS), []
    for tag in args.jobs.split(","):
        job = dict(jobs[tag])
        if args.optimizer:
            job["optimizer"] = args.optimizer
        if args.pattern:
            job["pattern"] = tuple(int(i) for i in args.pattern.split(","))
        cs.TP_JOBS = {tag: job}
        t = time.perf_counter()
        try:
            res = cs.phase_tp(dev, torch, np, bw)
            print(f"tp_alone {tag} ok {time.perf_counter() - t:.1f} s {res['launches']}",
                  flush=True)
        except Exception:
            traceback.print_exc()
            print(f"tp_alone {tag} FAILED {time.perf_counter() - t:.1f} s", flush=True)
            failed.append(tag)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
