"""Training driver (torch port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
        --steps 3 --batch 8 --seq 512 [--partition {zero1,fsdp}] [--microbatches K] \\
        [--no-compress] [--smoke] [--device cpu] [--pods P] \\
        [--ckpt-dir DIR] [--ckpt-every N] [--heartbeat FILE] [--sigterm] [--resume]

Wires together: config registry -> data pipeline -> the train step of the
partition over the compressed wires (ZeRO-1's two-shot, or FSDP's gathers
and their reduce-scatters; + its compression-disabled twin) -> the
fault-tolerant ``runtime/fault_tolerance.StepRunner``.  Each step replays
the run's plans (``zero1``, or one ``fsdp_gather`` plan a leaf signature:
compiled on first sight, a plan-cache hit every later time).  The runner
reruns a compressed step whose overflow flag fires with
``CompressionPolicy.disabled()``, over the plans of that policy (the FSDP
step reports no overflow, as the reference's), and counts the retry; it
also writes asynchronous checkpoints of the train
state every ``--ckpt-every`` steps, a heartbeat file, counts stragglers,
flushes a checkpoint on SIGTERM (``--sigterm``) and resumes from the newest
good checkpoint (``--resume``).  Under ``torchrun`` the process group comes
from the environment; otherwise a single-process group is made (NCCL on the
GPU, gloo on the CPU).  ZeRO-1 and FSDP run over the reference's smoke
mesh (``launch.mesh.make_smoke_mesh(pods=)``: at 4 ranks (data, model) =
(2, 2), at 4 ranks and ``--pods 2`` (2, 1, 2); :func:`cli_mesh`), tensor
and expert parallel over 'model'.  The steps sync over the DP axes in
pod-major rank order, and each rank reads the batch rows of its DP index
in that order (the model ranks of a DP row read the same rows).
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
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.config import ArchConfig
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
    plan_cache: PlanCache  # the run's plans: one miss a signature and policy, then hits
    runner: StepRunner
    start_step: int = 0  # > 0 when the run resumed from a checkpoint


def dp_rows(batch: dict, index: int, count: int) -> dict:
    """Rows ``index * b / count`` on of a global batch: the rows that
    ``P(("pod", "data"), None)`` places on DP index ``index`` of ``count``
    (on every model rank of that index alike: 'model' replicates the
    batch)."""
    m = len(batch["tokens"]) // count
    return {k: v[index * m:(index + 1) * m] for k, v in batch.items()}


def _plan_step(tcfg: step_lib.TrainConfig, group, dev, plan_cache: PlanCache, rows=None):
    """The StepRunner's step: the batch (its ``rows = (index, count)``
    part, when given) to ``dev``, then one step of ``tcfg.partition``
    replaying its plans from ``plan_cache`` over ``group`` (None: the
    state's own).  The train state is updated in place (the overflow guard
    leaves it as it was)."""
    def step(state, batch):
        if rows is not None:
            batch = dp_rows(batch, *rows)
        batch = {k: v.to(device=dev, dtype=torch.int64) for k, v in batch.items()}
        if tcfg.partition == "fsdp":
            return state, step_lib.fsdp_train_step(state, batch, tcfg, group=group,
                                                   cache=plan_cache)
        plan = step_lib.zero1_plan(state, tcfg, group, cache=plan_cache)
        return state, step_lib.train_step(state, batch, tcfg, group=group, plan=plan)
    return step


def build(arch: str | ArchConfig, *, batch: int, seq: int, rcfg: RunnerConfig,
          compress: bool = True, smoke: bool = False, device="cuda", seed: int = 0,
          lr: float = 3e-4, warmup: int = 20, optimizer: str = "adamw",
          compress_min_bytes: int = 0, partition: str = "zero1", microbatches: int = 1,
          group=None, mesh=None, data_path: str | None = None, generator=None,
          dp_only: bool = False) -> tuple:
    """``(state, tcfg, runner, plan_cache)``: the random init of ``arch``
    (a name: its config, or with ``smoke`` its SMOKE config; or an
    ``ArchConfig`` as it is) made from ``seed``, its train config, and a
    ``rcfg`` StepRunner over the data pipeline whose step is the compressed
    step of ``partition`` ("zero1" or "fsdp", over ``microbatches``
    microbatches) and whose fallback is the compression-disabled one (none
    when the run is uncompressed); both replay their plans from
    ``plan_cache``.  ``group`` is the data-parallel process group (default:
    the world), each rank drawing its own rows (``process_index``); a
    ``mesh`` (``launch/mesh``) replaces it by the mesh's sync group
    (``train.step.sync_group``), and each rank takes the rows of its DP
    index in the global batch (:func:`dp_rows`), as the reference's
    launcher places them; a batch that does not split evenly over those
    indices raises ValueError.  ``data_path`` reads the batches from a token file (the
    pipeline's ``file`` backend) in place of synthetic tokens.  ``generator``:
    the init's draws (default a CPU generator seeded ``seed``; a CUDA one
    draws a billion weights in seconds).  An encoder-decoder config raises
    ValueError: the pipeline makes no frames (the reference's launcher
    feeds none either).  ``dp_only``: the mesh's 'model' axis carries batch
    rows, not tensor parallelism (``TrainConfig.dp_only``)."""
    dev = kernels.resolve_device(device)
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if cfg.enc_dec:  # the data pipeline makes tokens and labels, no frames
        raise ValueError(f"{cfg.name} is an encoder-decoder model: the launcher feeds "
                         f"no frames; train it through train.step.train_step on "
                         f"models.registry.make_batch batches")
    policy = (CompressionPolicy(min_bytes=compress_min_bytes) if compress
              else CompressionPolicy.disabled())
    tcfg = step_lib.TrainConfig(
        microbatches=microbatches, partition=partition, loss_chunk=min(1024, seq),
        policy=policy, dp_only=dp_only,
        optim=OptimConfig(name=optimizer, lr=lr, warmup_steps=warmup))
    if mesh is not None:
        n_dp = dist.get_world_size(step_lib.sync_group(mesh, tcfg)[0])
        if batch % n_dp:
            raise ValueError(f"a batch of {batch} rows does not split over the mesh's "
                             f"{n_dp} data-parallel ranks")
    state = step_lib.build_train_state(
        cfg, tcfg, generator=torch.Generator().manual_seed(seed) if generator is None
        else generator, group=group, mesh=mesh, device=dev)
    place = (dist.get_rank(state.group), dist.get_world_size(state.group))
    rows = place if mesh is not None else None
    plan_cache = PlanCache()
    fallback = None
    if policy.enabled:
        raw_tcfg = dataclasses.replace(tcfg, policy=CompressionPolicy.disabled())
        fallback = _plan_step(raw_tcfg, group, dev, plan_cache, rows)
    pipe = DataPipeline(
        DataConfig(vocab=cfg.vocab, global_batch=batch, seq_len=seq, seed=seed,
                   kind="synthetic" if data_path is None else "file", path=data_path),
        **({} if mesh is not None else dict(process_index=place[0], process_count=place[1])))
    runner = StepRunner(_plan_step(tcfg, group, dev, plan_cache, rows), fallback, rcfg,
                        pipeline=pipe)
    return state, tcfg, runner, plan_cache


def train(arch: str | ArchConfig, *, steps: int, batch: int, seq: int,
          compress: bool = True, smoke: bool = False, device="cuda", seed: int = 0,
          lr: float = 3e-4, warmup: int = 20, optimizer: str = "adamw",
          compress_min_bytes: int = 0, partition: str = "zero1", microbatches: int = 1,
          group=None, mesh=None, rcfg: RunnerConfig = None, resume: bool = False, log=None,
          data_path: str | None = None, generator=None, dp_only: bool = False) -> TrainRun:
    """Train ``steps`` steps of ``partition`` through the StepRunner of :func:`build`
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
            compress_min_bytes=compress_min_bytes, partition=partition,
            microbatches=microbatches, group=group, mesh=mesh, data_path=data_path,
            generator=generator, dp_only=dp_only)
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


def cli_mesh(world: int, pods: int = 1, device="cuda"):
    """The mesh of a CLI run of ``world`` ranks, either partition: the
    reference's smoke mesh (``make_smoke_mesh(pods=)``), tensor and expert
    parallel over its 'model' axis, as the reference's CLI builds it for
    both."""
    if world % pods:
        raise SystemExit(f"{world} ranks do not split into {pods} pods")
    return mesh_lib.make_smoke_mesh(world, pods=pods, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--partition", default="zero1", choices=["zero1", "fsdp"])
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--compress-min-bytes", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--sigterm", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data-path", default=None,
                    help="token file (raw uint16, uint32 above a 65535 vocabulary)")
    args = ap.parse_args(argv)

    rcfg = RunnerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        heartbeat_path=args.heartbeat, install_sigterm=args.sigterm)
    with launcher_group(args.device) as dev:
        mesh = cli_mesh(dist.get_world_size(), args.pods, dev)
        run = train(args.arch, steps=args.steps, batch=args.batch,
                    seq=args.seq, compress=not args.no_compress,
                    smoke=args.smoke, device=dev, seed=args.seed,
                    lr=args.lr, warmup=args.warmup, optimizer=args.optimizer,
                    compress_min_bytes=args.compress_min_bytes,
                    partition=args.partition, microbatches=args.microbatches, mesh=mesh,
                    rcfg=rcfg,
                    resume=args.resume, log=print, data_path=args.data_path)
    print(f"final loss {run.losses[-1]:.4f} | stragglers {run.runner.stragglers} | "
          f"retries {run.retries} | compressed={not args.no_compress} | "
          f"partition={args.partition} | mesh={mesh_lib.axis_sizes(mesh)}")


if __name__ == "__main__":
    main()
