"""RL weight synchronization from the ZeRO-1 trainer to serving replicas (the
port's twin of ``examples/rl_weight_sync.py``; paper §5.3.1, Fig. 10).

    PYTHONPATH=src python -m repro_torch.launch.rl_weight_sync --arch smollm_135m \\
        [--smoke] [--device cpu] [--batch 8 --seq 512]

The sequence of the reference example:

  * the trainer (ZeRO-1 over the compressed two-shot wire, lr 1e-5 with a
    3-step warm-up, at which most bf16 weights move less than one ULP per
    step) burns through the warm-up, then calibrates the XOR-delta widths
    (``calibrate.choose_delta_widths``) on one 2-step publish cadence;
  * 3 iterations of 2 steps, each followed by a publish
    (``train/step.make_publish_hook``) and one update per replica from a
    ``WeightSyncEngine`` whose kind-"wsync" plan compiles once;
  * "rollout-0" is a ``ServeEngine`` that ingests every update; "rollout-1"
    holds a plain tree and joins at iteration 1 (a full send, then deltas);
  * every reconstruction is compared bit for bit with the trainer's
    weights; after the last iteration rollout-0 answers ``--requests``
    greedy requests, which must give the tokens of a fresh engine built from
    the trainer's weights;
  * finally ``advance_epoch()`` fences the acks (a trainer restart) and the
    next update to rollout-0 must be full.

Random weights from ``--seed``; batches from ``DataPipeline(seed)``.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, kernels
from repro_torch.core import calibrate, codec
from repro_torch.core.policy import CompressionPolicy
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.launch.train import deterministic, launcher_group
from repro_torch.models import transformer
from repro_torch.optim.optimizers import OptimConfig
from repro_torch.sched.cache import PlanCache
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
from repro_torch.sync import WeightSyncEngine, apply_update
from repro_torch.train import step as step_lib
from repro_torch.tree_util import bits_equal

WARMUP_STEPS, CADENCE, ITERS = 3, 2, 3



def _flat(model: transformer.Transformer) -> torch.Tensor:
    return codec.concat_bits([p.detach().reshape(-1) for p in model.leaves()])


@dataclasses.dataclass
class SyncRun:
    """What a run did: per update ``records`` (iteration, replica, mode,
    wire and raw bytes, ratio, the update itself), the delta widths, the
    plan cache, the kernel launches of the sync sections (publish, encode,
    apply; counted just before and after each), also by shape where the
    wrapper tallies one (``kernels.launch_shapes``), and the serve check."""

    state: step_lib.TrainState
    engine: WeightSyncEngine
    rollout0: ServeEngine
    widths: tuple
    plan_cache: PlanCache
    records: list
    losses: list
    sync_launches: dict
    sync_shapes: dict  # {kernel: {shape: launches}} of the sync sections
    n_publishes: int
    tokens: list  # rollout-0's greedy tokens after its last delta
    fresh_tokens: list  # a fresh engine's, from the trainer's weights


def run(arch: str, *, smoke: bool = False, device="cuda", batch: int = 8,
        seq: int = 512, seed: int = 0, slots: int = 4, max_len: int = 1024,
        requests: int = 2, prompt_len: int = 512, max_new: int = 32,
        group=None, log=print) -> SyncRun:
    dev = kernels.resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    tcfg = step_lib.TrainConfig(
        loss_chunk=min(1024, seq), policy=CompressionPolicy(min_bytes=0),
        optim=OptimConfig(lr=1e-5, warmup_steps=WARMUP_STEPS))
    raw_tcfg = dataclasses.replace(tcfg, policy=CompressionPolicy.disabled())
    state = step_lib.build_train_state(
        cfg, tcfg, generator=torch.Generator().manual_seed(seed), group=group, device=dev)
    pipe = DataPipeline(
        DataConfig(vocab=cfg.vocab, global_batch=batch, seq_len=seq, seed=seed),
        process_index=dist.get_rank(group), process_count=dist.get_world_size(group))
    losses: list = []

    def train(n):
        for _ in range(n):
            b = pipe.tensors_at(state.step, dev)
            m = step_lib.train_step(state, b, tcfg, group=group)
            if m["overflow"]:  # the guard kept the state: rerun the step raw
                m = step_lib.train_step(state, b, raw_tcfg, group=group)
            losses.append(float(m["loss"]))

    # calibrate on one publish cadence after the lr warm-up: the warm-up's
    # tiny steps would pick widths that later deltas overflow
    train(WARMUP_STEPS)
    v_prev = _flat(state.model).clone()
    train(CADENCE)
    w_d, w_lo = calibrate.choose_delta_widths(_flat(state.model), v_prev)
    del v_prev
    prof = calibrate.CompressionProfile(widths={
        "gradient": 5, "weight": 5, "activation": 5, "delta": w_d, "delta_lo": w_lo})
    plan_cache = PlanCache()
    engine = WeightSyncEngine(policy=CompressionPolicy(min_bytes=0, profile=prof),
                              plan_cache=plan_cache)
    publish = step_lib.make_publish_hook(engine)
    scfg = ServeConfig(batch_slots=slots, max_len=max_len, prefill_chunk=prompt_len)
    rollout0 = ServeEngine(cfg, transformer.init(
        cfg, generator=torch.Generator().manual_seed(seed + 1), device=dev), scfg)
    held = {"rollout-0": None}  # rollout-1's tree; rollout-0 holds its own
    records: list = []
    sync_launches = dict.fromkeys(kernels.KERNELS, 0)
    sync_shapes: dict = {k: {} for k in kernels.KERNELS}
    n_publishes = 0

    def sync(it, names):
        nonlocal n_publishes
        before = kernels.launch_counts()
        before_shapes = {k: kernels.launch_shapes(k) for k in kernels.KERNELS}
        publish(state)
        n_publishes += 1
        for name in names:
            upd = engine.update_for(name)
            if name == "rollout-0":
                rollout0.ingest_weights(upd)
                got = rollout0.model.tree()
            else:
                got = apply_update(upd, base_params=held[name] if upd.base_version
                                   else None, device=dev)
                held[name] = got
            engine.ack(name, upd.version, upd.epoch)
            exact = bits_equal(got, state.model.tree())
            records.append({"iter": it, "replica": name, "version": upd.version,
                            "mode": upd.mode, "wire_bytes": upd.wire_bytes,
                            "raw_bytes": upd.raw_bytes, "ratio": upd.ratio,
                            "exact": exact, "update": upd})
            log(f"  {it!s:>5} | {losses[-1]:.6f} | {name} | {upd.mode:5s} | "
                f"{upd.wire_bytes / 2**20:9.3f} | {upd.ratio:.4f} | {exact}")
            if not exact:
                raise AssertionError(f"{name} diverged at v{upd.version}")
        for k, v in kernels.launch_counts().items():
            sync_launches[k] += v - before[k]
            for shape, n in kernels.launch_shapes(k).items():
                if n != before_shapes[k].get(shape, 0):
                    sync_shapes[k][shape] = (sync_shapes[k].get(shape, 0) + n
                                             - before_shapes[k].get(shape, 0))

    log(f"{cfg.name}: delta widths exp={w_d} lo={w_lo}; rollout-1 joins at "
        f"iteration 1")
    log(" iter | loss     | replica   | mode  | wire MiB  | ratio  | exact")
    for it in range(ITERS):
        train(CADENCE)
        if it == 1:
            held["rollout-1"] = None  # the late joiner
        sync(it, sorted(held))

    # rollout-0 answers requests with the synced weights, as a fresh engine
    # built from the trainer's weights does
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
               for _ in range(requests)]
    fresh = ServeEngine(cfg, transformer.Transformer(cfg, {
        path: p.detach().clone() for path, p in state.model.params.items()}), scfg)
    tokens = []
    for eng in (rollout0, fresh):
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=max_new))
        tokens.append(sorted((r.rid, tuple(r.out)) for r in eng.run()))
        eng.finished.clear()
    log(f"rollout-0 served {requests} requests x ({prompt_len} + {max_new}) tokens: "
        f"{'identical to' if tokens[0] == tokens[1] else 'DIFFERENT from'} a fresh "
        f"engine on the trainer's weights")
    if tokens[0] != tokens[1]:
        raise AssertionError(f"rollout-0 tokens {tokens[0]} != fresh {tokens[1]}")

    # a trainer restart: the epoch fence drops every ack, the next send is full
    engine.advance_epoch()
    sync("fence", ["rollout-0"])
    if records[-1]["mode"] != "full" or records[-1]["update"].base_version is not None:
        raise AssertionError(f"the update after the fence is {records[-1]['mode']}")
    info = plan_cache.cache_info()
    log(f"wsync plan cache: {info['misses']} miss, {info['hits']} hits; epoch "
        f"fence: the next update to rollout-0 was full, bit-exact")
    return SyncRun(state=state, engine=engine, rollout0=rollout0, widths=(w_d, w_lo),
                   plan_cache=plan_cache, records=records, losses=losses,
                   sync_launches=sync_launches, sync_shapes=sync_shapes,
                   n_publishes=n_publishes,
                   tokens=tokens[0], fresh_tokens=tokens[1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with launcher_group(args.device) as dev, deterministic():
        run(args.arch, smoke=args.smoke, device=dev, batch=args.batch, seq=args.seq,
            seed=args.seed, requests=args.requests, prompt_len=args.prompt_len,
            max_new=args.max_new)

if __name__ == "__main__":
    main()
