"""Training driver (torch port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
        --steps 3 --batch 8 --seq 512 [--no-compress] [--smoke] [--device cpu] \\
        [--ckpt-dir DIR] [--ckpt-every N] [--heartbeat FILE] [--sigterm] [--resume]

Wires together: config registry -> data pipeline -> ZeRO-1 train step over
the compressed two-shot wire (+ its compression-disabled twin) -> the
fault-tolerant ``runtime/fault_tolerance.StepRunner``.  Each step replays
the run's ``zero1`` plan (compiled on the first step, a plan-cache hit on
every later one).  The runner reruns a compressed step whose overflow flag
fires with ``CompressionPolicy.disabled()``, over the plan of that policy,
and counts the retry; it also writes asynchronous checkpoints of the train
state every ``--ckpt-every`` steps, a heartbeat file, counts stragglers,
flushes a checkpoint on SIGTERM (``--sigterm``) and resumes from the newest
good checkpoint (``--resume``).  Under ``torchrun`` the process group comes
from the environment; otherwise a single-process group is made (NCCL on the
GPU, gloo on the CPU).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import configs, kernels
from repro_torch.core.policy import CompressionPolicy, capture_wire_reports
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.optim.optimizers import OptimConfig
from repro_torch.runtime.fault_tolerance import RunnerConfig, StepRunner
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


DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainRun:
    state: step_lib.TrainState
    tcfg: step_lib.TrainConfig
    losses: list
    step_ms: list
    retries: int
    wire_reports: list
    plan_cache: PlanCache  # the run's zero1 plans: one miss a policy, then hits
    runner: StepRunner
    start_step: int = 0  # > 0 when the run resumed from a checkpoint


def _plan_step(tcfg: step_lib.TrainConfig, group, dev, plan_cache: PlanCache):
    """The StepRunner's step: the batch to ``dev``, then one ZeRO-1 step
    replaying ``tcfg``'s zero1 plan from ``plan_cache``.  The train state is
    updated in place (the overflow guard leaves it as it was)."""
    def step(state, batch):
        batch = {k: v.to(device=dev, dtype=torch.int64) for k, v in batch.items()}
        plan = step_lib.zero1_plan(state, tcfg, group, cache=plan_cache)
        return state, step_lib.train_step(state, batch, tcfg, group=group, plan=plan)
    return step


def build(arch: str, *, batch: int, seq: int, rcfg: RunnerConfig, compress: bool = True,
          smoke: bool = False, device="cuda", seed: int = 0, lr: float = 3e-4,
          warmup: int = 20, optimizer: str = "adamw", compress_min_bytes: int = 0,
          group=None) -> tuple:
    """``(state, tcfg, runner, plan_cache)``: the random init made from
    ``seed``, its train config, and a ``rcfg`` StepRunner over the data
    pipeline whose step is the compressed ZeRO-1 step and whose fallback is
    the compression-disabled one (none when the run is uncompressed); both
    replay their zero1 plans from ``plan_cache``.  ``group`` is the
    data-parallel process group (default: the world)."""
    dev = kernels.resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    policy = (CompressionPolicy(min_bytes=compress_min_bytes) if compress
              else CompressionPolicy.disabled())
    tcfg = step_lib.TrainConfig(
        loss_chunk=min(1024, seq), policy=policy,
        optim=OptimConfig(name=optimizer, lr=lr, warmup_steps=warmup))
    plan_cache = PlanCache()
    fallback = None
    if policy.enabled:
        raw_tcfg = dataclasses.replace(tcfg, policy=CompressionPolicy.disabled())
        fallback = _plan_step(raw_tcfg, group, dev, plan_cache)
    state = step_lib.build_train_state(
        cfg, tcfg, generator=torch.Generator().manual_seed(seed), group=group,
        device=dev)
    pipe = DataPipeline(
        DataConfig(vocab=cfg.vocab, global_batch=batch, seq_len=seq, seed=seed),
        process_index=dist.get_rank(group),
        process_count=dist.get_world_size(group))
    runner = StepRunner(_plan_step(tcfg, group, dev, plan_cache), fallback, rcfg,
                        pipeline=pipe)
    return state, tcfg, runner, plan_cache


def train(arch: str, *, steps: int, batch: int, seq: int, compress: bool = True,
          smoke: bool = False, device="cuda", seed: int = 0, lr: float = 3e-4,
          warmup: int = 20, optimizer: str = "adamw", compress_min_bytes: int = 0,
          group=None, rcfg: RunnerConfig = None, resume: bool = False,
          log=None) -> TrainRun:
    """Train ``steps`` ZeRO-1 steps through the StepRunner of :func:`build`
    (``rcfg``: its checkpoint, heartbeat and straggler settings; by default
    checkpoints go to a temporary directory that the run removes).
    ``resume`` first restores the newest good checkpoint of
    ``rcfg.ckpt_dir`` and continues after its step.  ``log`` gets one line
    a step."""
    with contextlib.ExitStack() as stack:
        if rcfg is None:
            rcfg = RunnerConfig(ckpt_dir=stack.enter_context(tempfile.TemporaryDirectory()))
        state, tcfg, runner, plan_cache = build(
            arch, batch=batch, seq=seq, rcfg=rcfg, compress=compress, smoke=smoke,
            device=device, seed=seed, lr=lr, warmup=warmup, optimizer=optimizer,
            compress_min_bytes=compress_min_bytes, group=group)
        start = 0
        if resume:
            resumed, start = runner.try_resume(state, device=device)
            if resumed is not None:
                state = resumed
                if log:
                    log(f"resumed from step {start}")
        with deterministic(), capture_wire_reports() as reports:
            state, losses = runner.train(state, start_step=start, num_steps=steps,
                                         log_every=1 if log else 0, log_fn=log)
    return TrainRun(state=state, tcfg=tcfg, losses=losses,
                    step_ms=[t * 1e3 for t in runner.times], retries=runner.retries,
                    wire_reports=list(reports), plan_cache=plan_cache, runner=runner,
                    start_step=start)


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
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--sigterm", action="store_true")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    rcfg = RunnerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        heartbeat_path=args.heartbeat, install_sigterm=args.sigterm)
    with launcher_group(args.device) as dev:
        run = train(args.arch, steps=args.steps, batch=args.batch,
                    seq=args.seq, compress=not args.no_compress,
                    smoke=args.smoke, device=dev, seed=args.seed,
                    lr=args.lr, warmup=args.warmup, optimizer=args.optimizer,
                    compress_min_bytes=args.compress_min_bytes, rcfg=rcfg,
                    resume=args.resume, log=print)
    print(f"final loss {run.losses[-1]:.4f} | stragglers {run.runner.stragglers} | "
          f"retries {run.retries} | compressed={not args.no_compress}")


if __name__ == "__main__":
    main()
