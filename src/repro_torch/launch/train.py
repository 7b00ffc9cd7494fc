"""Training driver (torch port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
        --steps 3 --batch 8 --seq 512 [--no-compress] [--smoke] [--device cpu]

Wires together: config registry -> data pipeline -> ZeRO-1 train step over
the compressed two-shot wire, each step replaying the run's ``zero1`` plan
(compiled on the first step, a plan-cache hit on every later one).  A
compressed step whose overflow flag fires is rerun with
``CompressionPolicy.disabled()`` over the plan of that policy (the
reference's StepRunner retry); the retries are counted.  Under
``torchrun`` the process group comes from the environment; otherwise a
single-process group is made (NCCL on the GPU, gloo on the CPU).
Checkpointing, heartbeat and straggler detection are not ported yet.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import configs, kernels
from repro_torch.core.policy import CompressionPolicy, capture_wire_reports
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.optim.optimizers import OptimConfig
from repro_torch.sched.cache import PlanCache
from repro_torch.train import step as step_lib

@contextlib.contextmanager
def single_process_group(device="cuda"):
    """A world of one rank (NCCL on CUDA, gloo on the CPU) over a FileStore
    in a temporary directory; destroyed on exit."""
    dev = kernels.resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=store, rank=0, world_size=1)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def launcher_group(device="cuda"):
    """The world group of a launcher's process: from the environment under
    ``torchrun`` (NCCL on CUDA, each rank on its ``LOCAL_RANK`` card; gloo on
    the CPU), else :func:`single_process_group`.  Yields the device to run
    on; the group is destroyed on exit."""
    if "WORLD_SIZE" not in os.environ:
        with single_process_group(device):
            yield device
        return
    dev = kernels.resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        yield dev
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms for the duration (the caller's
    setting is restored): the compressed and raw twins are bit-comparable
    only if the model's own forward and backward are.  No code here reads
    memory before writing it, so ``torch.empty`` is not filled."""
    import torch.utils.deterministic as det

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        det.fill_uninitialized_memory = was[2]


@dataclasses.dataclass
class TrainRun:
    state: step_lib.TrainState
    tcfg: step_lib.TrainConfig
    losses: list
    step_ms: list
    retries: int
    wire_reports: list
    plan_cache: PlanCache  # the run's zero1 plans: one miss a policy, then hits


def train(arch: str, *, steps: int, batch: int, seq: int, compress: bool = True,
          smoke: bool = False, device="cuda", seed: int = 0, lr: float = 3e-4,
          warmup: int = 20, optimizer: str = "adamw",
          compress_min_bytes: int = 0, group=None, log=None) -> TrainRun:
    """Train ``steps`` ZeRO-1 steps from a random init made from ``seed``.
    ``group`` is the data-parallel process group (default: the world)."""
    dev = kernels.resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    policy = (CompressionPolicy(min_bytes=compress_min_bytes) if compress
              else CompressionPolicy.disabled())
    tcfg = step_lib.TrainConfig(
        loss_chunk=min(1024, seq), policy=policy,
        optim=OptimConfig(name=optimizer, lr=lr, warmup_steps=warmup))
    raw_tcfg = dataclasses.replace(tcfg, policy=CompressionPolicy.disabled())
    state = step_lib.build_train_state(
        cfg, tcfg, generator=torch.Generator().manual_seed(seed), group=group,
        device=dev)
    pipe = DataPipeline(
        DataConfig(vocab=cfg.vocab, global_batch=batch, seq_len=seq, seed=seed),
        process_index=dist.get_rank(group),
        process_count=dist.get_world_size(group))
    run = TrainRun(state=state, tcfg=tcfg, losses=[], step_ms=[], retries=0,
                   wire_reports=[], plan_cache=PlanCache())
    with deterministic(), capture_wire_reports() as reports:
        for s in range(steps):
            b = pipe.tensors_at(s, dev)
            t0 = time.perf_counter()
            plan = step_lib.zero1_plan(state, tcfg, group, cache=run.plan_cache)
            m = step_lib.train_step(state, b, tcfg, group=group, plan=plan)
            # on overflow the guard kept the old state: rerun the step raw,
            # which cannot overflow
            tries = int(m["overflow"] != 0)
            if tries:
                raw_plan = step_lib.zero1_plan(state, raw_tcfg, group,
                                               cache=run.plan_cache)
                m = step_lib.train_step(state, b, raw_tcfg, group=group, plan=raw_plan)
            loss = float(m["loss"])  # waits for the step to finish
            run.step_ms.append((time.perf_counter() - t0) * 1e3)
            run.losses.append(loss)
            run.retries += tries
            if log:
                log(f"step {s} loss {loss:.6f} gnorm {float(m['gnorm']):.4f} "
                    f"retries {tries} {run.step_ms[-1]:.1f} ms")
    run.wire_reports = list(reports)
    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--compress-min-bytes", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with launcher_group(args.device) as dev:
        run = train(args.arch, steps=args.steps, batch=args.batch,
                    seq=args.seq, compress=not args.no_compress,
                    smoke=args.smoke, device=dev, seed=args.seed,
                    lr=args.lr, warmup=args.warmup, optimizer=args.optimizer,
                    compress_min_bytes=args.compress_min_bytes, log=print)
    print(f"final loss {run.losses[-1]:.4f} | retries {run.retries} | "
          f"compressed={not args.no_compress}")


if __name__ == "__main__":
    main()
