#!/usr/bin/env python3
"""Where a compressed FSDP step's time goes, on one CUDA card.

    python3 tools/profile_fsdp.py [--steps N] [--smoke --device cpu]

Builds the launcher's FSDP run of smollm-135m at full width
(``launch/train.build``: ``partition="fsdp"``, 2 microbatches, remat, batch
8 x seq 512, random weights from seed 0) compressed and raw, takes 2
warm-up steps of each, then times ``--steps`` steps (host clock to a
device sync, median) with PyTorch's deterministic algorithms on, as the
launcher runs, and off; then traces one compressed step with
``torch.profiler``: the step's wall time, the sum of its kernels' device
time and so the device's idle share (one stream's view: NCCL's kernels on
their own stream count in the sum), and the ops with the most host time
(self CPU) and the most device time.  Prints one JSON line, and the card's
name and power limit.  ``--smoke --device cpu`` rehearses it (host time
only).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
ARCH, BATCH, SEQ, MICRO, TOP = "smollm_135m", 8, 512, 2, 12


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _median_ms(fn, steps, torch, dev) -> float:
    times = []
    for _ in range(steps):
        _sync(torch, dev)
        t0 = time.perf_counter()
        fn()
        _sync(torch, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _top(rows, key, n):
    rows = sorted(rows, key=lambda r: -getattr(r, key, 0))[:n]
    return [{"op": r.key, "calls": r.count, "ms": getattr(r, key, 0) / 1e3} for r in rows]


def _profile(fn, torch, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    for _ in range(2):  # the first trace of a process can drop device time
        _sync(torch, dev)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            _sync(torch, dev)
            wall = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    dkey = ("self_device_time_total" if hasattr(rows[0], "self_device_time_total")
            else "self_cuda_time_total")
    device_ms = sum(getattr(r, dkey, 0) for r in rows) / 1e3
    return {"wall_ms": wall, "kernel_ms": device_ms,
            "idle_share": max(0.0, 1 - device_ms / wall) if dev.type == "cuda" else None,
            "top_host": _top(rows, "self_cpu_time_total", TOP),
            "top_device": _top(rows, dkey, TOP) if dev.type == "cuda" else []}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import kernels
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.fault_tolerance import RunnerConfig
    from repro_torch.train import step as step_lib

    dev = kernels.resolve_device(args.device)
    out = {"arch": ARCH, "smoke": args.smoke, "batch": BATCH, "seq": SEQ,
           "microbatches": MICRO}
    with launch_train.single_process_group(dev) as group, \
            tempfile.TemporaryDirectory() as tmp:
        for compress in (True, False):
            tag = "compressed" if compress else "raw"
            state, tcfg, _, cache = launch_train.build(
                ARCH, batch=BATCH, seq=SEQ, rcfg=RunnerConfig(ckpt_dir=tmp),
                compress=compress, smoke=args.smoke, device=dev, partition="fsdp",
                microbatches=MICRO, group=group)
            batch = DataPipeline(DataConfig(vocab=state.model.cfg.vocab, global_batch=BATCH,
                                            seq_len=SEQ)).tensors_at(0, dev)

            def step():
                step_lib.fsdp_train_step(state, batch, tcfg, group=group, cache=cache)

            with launch_train.deterministic():
                _median_ms(step, 2, torch, dev)  # warm-up
                out[f"{tag}_step_ms"] = _median_ms(step, args.steps, torch, dev)
            out[f"{tag}_step_ms_nondeterministic"] = _median_ms(step, args.steps, torch, dev)
            if compress:
                with launch_train.deterministic():
                    out["profile"] = _profile(step, torch, dev)
            del state
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
