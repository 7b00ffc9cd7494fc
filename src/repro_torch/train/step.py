"""ZeRO-1 training step over the compressed two-shot wire (torch port of
``repro.train.step``, partition ``zero1``).

One step: forward + sequence-chunked cross-entropy, backward (each rank's
local gradient), then ``optim/zero1.zero1_step``: compressed reduce-scatter
of the gradient bucket, f32 shard update, compressed all-gather of the new
parameters, replaying the step signature's ``zero1`` plan
(:func:`zero1_plan`: compiled once per signature and policy, then a cache
hit).

Losslessness: every compressed wire carries an overflow flag.  With
``guard_overflow`` a step whose flag fires keeps the old parameters and
optimizer state and does not advance the step counter; the launcher's
``runtime/fault_tolerance.StepRunner`` then reruns it uncompressed.
:func:`make_publish_hook` hands the weights to the weight-sync engine after
a step.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.policy import CompressionPolicy
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig
from repro_torch.optim import optimizers as opt
from repro_torch.optim import zero1 as zero1_lib
from repro_torch.sched import compile as sched_compile


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    loss_chunk: int = 1024
    optim: opt.OptimConfig = dataclasses.field(default_factory=opt.OptimConfig)
    policy: CompressionPolicy = dataclasses.field(default_factory=CompressionPolicy)
    guard_overflow: bool = True


@dataclasses.dataclass
class TrainState:
    model: transformer.Transformer
    opt: dict  # this rank's ZeRO-1 shard state (zero1_init_local)
    meta: zero1_lib.BucketMeta
    step: int = 0

    def tree(self) -> dict:
        """The state as the reference's train-state tree ``{"params",
        "opt", "step"}`` (what a checkpoint saves); the parameters share
        the model's storage."""
        return {"params": self.model.tree(), "opt": self.opt,
                "step": torch.tensor(self.step, dtype=torch.int32)}

    def from_tree(self, tree: dict) -> "TrainState":
        """A new state holding ``tree`` (a restored :meth:`tree`), with this
        state's config and bucket layout."""
        model = transformer.Transformer(self.model.cfg,
                                        dict(transformer.tree_paths(tree["params"])))
        return TrainState(model=model, opt=tree["opt"], meta=self.meta,
                          step=int(tree["step"]))


def chunked_ce_loss(head: torch.Tensor, hidden: torch.Tensor,
                    labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean token cross-entropy with logits materialised ``chunk`` positions
    at a time, in f32 (the reference's ``chunked_ce_loss``)."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    total = hidden.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, chunk):
        logits = (hidden[:, s0:s0 + chunk] @ head.T).to(torch.float32)
        gold = torch.gather(logits, -1, labels[:, s0:s0 + chunk, None])[..., 0]
        total = total + torch.sum(torch.logsumexp(logits, dim=-1) - gold)
    return total / (B * S)


def loss_fn(model: transformer.Transformer, batch: dict, tcfg: TrainConfig):
    hidden = model(batch["tokens"])
    return chunked_ce_loss(model.head(), hidden, batch["labels"], tcfg.loss_chunk)


def train_state_for(model: transformer.Transformer, tcfg: TrainConfig,
                    group=None) -> TrainState:
    """ZeRO-1 train state around existing weights (this rank's shard)."""
    n_dp = dist.get_world_size(group)
    meta = zero1_lib.plan_buckets(model.leaves(), n_dp,
                                  block=tcfg.policy.profile.block)
    ost = zero1_lib.zero1_init_local(tcfg.optim, meta, model.leaves(),
                                     dp_index=dist.get_rank(group))
    return TrainState(model=model, opt=ost, meta=meta)


def build_train_state(cfg: ArchConfig, tcfg: TrainConfig, *,
                      generator: torch.Generator, group=None,
                      device="cuda") -> TrainState:
    """Randomly initialised model + ZeRO-1 state on ``device``."""
    model = transformer.init(cfg, generator=generator, device=device)
    return train_state_for(model, tcfg, group)


def zero1_plan(state: TrainState, tcfg: TrainConfig, group=None, *,
               axis_name="data", cache=None):
    """The ``zero1`` plan of this train state's step signature (bucket
    layout, policy, group size, device): compiled on first sight, then a
    hit in ``cache`` (default: the process cache)."""
    return sched_compile.cached_zero1_plan(
        state.meta, policy=tcfg.policy, axis_name=axis_name,
        n_dev=dist.get_world_size(group), device=state.model.leaves()[0].device,
        cache=cache)


def train_step(state: TrainState, batch: dict, tcfg: TrainConfig, *,
               group=None, plan=None) -> dict:
    """One ZeRO-1 step over ``plan`` (default: :func:`zero1_plan`); updates
    ``state`` in place unless the overflow guard fires.  Returns ``{"loss"
    (mean over ranks), "gnorm": f32 tensors, "overflow": int}``."""
    if plan is None:
        plan = zero1_plan(state, tcfg, group)
    leaves = state.model.leaves()
    for p in leaves:
        p.grad = None
    loss = loss_fn(state.model, batch, tcfg)
    loss.backward()
    grads = [p.grad for p in leaves]
    with torch.no_grad():
        new_params, new_opt, flag, gnorm = zero1_lib.zero1_step(
            tcfg.optim, state.meta, leaves, grads, state.opt, group=group,
            policy=tcfg.policy, plan=plan)
        loss = loss.detach()
        dist.all_reduce(loss, group=group)
        loss = loss / dist.get_world_size(group)
        overflow = int(flag)  # the guard needs the flag on the host
        if overflow == 0 or not tcfg.guard_overflow:
            for p, new in zip(leaves, new_params):
                p.copy_(new)
            state.opt = new_opt
            state.step += 1
    for p in leaves:
        p.grad = None
    return {"loss": loss, "gnorm": gnorm, "overflow": overflow}


def make_publish_hook(sync_engine, *, every: int = 1):
    """Bridge the train loop to a ``sync.WeightSyncEngine``: returns
    ``hook(state) -> version | None``, to call after each optimizer step.
    Every ``every`` steps (read from the train state's own counter, so the
    cadence survives a restore) it publishes the model's parameter tree,
    whose signature is step-stable, so every publish after the first hits
    the cached kind-"wsync" plan.  After restoring a trainer, call
    ``sync_engine.advance_epoch()`` before the first publish."""
    def hook(state: TrainState):
        step = int(state.step)
        if every > 1 and step % every != 0:
            return None
        return sync_engine.publish(state.model.tree())
    return hook
