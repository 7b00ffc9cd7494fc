"""Training steps over the compressed wires (torch port of
``repro.train.step``): partitions ``zero1`` and ``fsdp``.

Both take the gradients of ``TrainConfig.microbatches`` microbatches
(:func:`_microbatch_grads`), each layer rematerialised in the backward when
``remat`` (``torch.utils.checkpoint``).

* ``zero1`` (:func:`train_step`): forward + sequence-chunked cross-entropy,
  backward (each rank's local gradient), then ``optim/zero1.zero1_step``:
  compressed reduce-scatter of the gradient bucket, f32 shard update,
  compressed all-gather of the new parameters, replaying the step
  signature's ``zero1`` plan (:func:`zero1_plan`: compiled once per
  signature and policy, then a cache hit).
* ``fsdp`` (:func:`fsdp_train_step`): the parameters stay sharded
  (:func:`plan_fsdp_tree`); the forward gathers the top-level leaves once
  and each layer's leaves inside the layer (``optim/fsdp``: a compressed
  all-gather whose backward is the compressed reduce-scatter of the
  gradient, each leaf signature a cached ``fsdp_gather`` plan); the
  replicated leaves' gradients are summed with ``psum_safe``, clipped by
  the global norm over the disjoint shards, and the optimizer
  (``optim/optimizers``) updates the local shards.

Losslessness: every compressed wire carries an overflow flag.  With
``guard_overflow`` a ZeRO-1 step whose flag fires keeps the old parameters
and optimizer state and does not advance the step counter; the launcher's
``runtime/fault_tolerance.StepRunner`` then reruns it uncompressed.  The
FSDP step reports ``overflow = 0`` and drops the forward gathers' flags, as
the reference's does (``optim/fsdp.gather_tree`` returns the flag).
:func:`make_publish_hook` hands the weights to the weight-sync engine after
a step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.core import codec
from repro_torch.core.compressed_collectives import psum_safe
from repro_torch.core.policy import CompressionPolicy, current_sinks, report_into
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig
from repro_torch.optim import fsdp as fsdp_lib
from repro_torch.optim import optimizers as opt
from repro_torch.optim import zero1 as zero1_lib
from repro_torch.sched import compile as sched_compile
from repro_torch.sched.plan import dtype_name
from repro_torch.tree_util import (tree_flatten, tree_flatten_up_to, tree_leaves, tree_map,
                                   tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: bool = True
    loss_chunk: int = 1024
    partition: str = "zero1"  # zero1 | fsdp
    optim: opt.OptimConfig = dataclasses.field(default_factory=opt.OptimConfig)
    policy: CompressionPolicy = dataclasses.field(default_factory=CompressionPolicy)
    guard_overflow: bool = True
    fsdp_min_bytes: int = 1 << 20


@dataclasses.dataclass
class TrainState:
    """``zero1``: the model holds the whole weights, ``opt`` this rank's
    shard state (``zero1_init_local``) and ``meta`` its bucket layout.
    ``fsdp``: the model holds this rank's shards, ``opt`` the optimizer
    state of those shards (``optimizers.init``) and ``fsdp_dims`` the
    sharded dim of every leaf (:func:`plan_fsdp_tree`)."""

    model: transformer.Transformer
    opt: dict
    meta: zero1_lib.BucketMeta | None
    step: int = 0
    fsdp_dims: dict | None = None

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
                          step=int(tree["step"]), fsdp_dims=self.fsdp_dims)


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
    hidden = model(batch["tokens"], vision_embeds=batch.get("vision_embeds"),
                   frames=batch.get("frames"), remat=tcfg.remat)
    return chunked_ce_loss(model.head(), hidden, batch["labels"], tcfg.loss_chunk)


def _microbatch_grads(loss_of, batch: dict, n_micro: int) -> torch.Tensor:
    """Gradient accumulation: one backward per microbatch ``i`` (rows ``i *
    b / n_micro`` on) of ``loss_of(mb_i) / n_micro``, so only one
    microbatch's activations are live at a time (the reference's rematted
    scan).  ``.grad`` accumulates in the parameters' dtype, microbatch 0
    first (two microbatches give the reference's bits: a two-term sum
    commutes).  Returns the mean loss over the microbatches, summed in f32
    in microbatch order, detached."""
    if n_micro == 1:
        loss = loss_of(batch)
        loss.backward()
        return loss.detach()
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    m = b // n_micro
    total = None
    for i in range(n_micro):
        loss = loss_of({k: v[i * m:(i + 1) * m] for k, v in batch.items()})
        (loss / n_micro).backward()
        total = loss.detach() if total is None else total + loss.detach()
    return total / n_micro


def _grads_of(leaves) -> list:
    """Each parameter's gradient; zeros for a parameter the loss never
    reads (sLSTM's ``wk``), whose ``.grad`` autograd leaves None, as
    ``jax.grad`` gives zeros."""
    return [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]


def train_state_for(model: transformer.Transformer, tcfg: TrainConfig,
                    group=None) -> TrainState:
    """The train state of ``tcfg.partition`` around existing weights (this
    rank's ZeRO-1 shard state, or this rank's FSDP shards)."""
    if tcfg.partition == "fsdp":
        return fsdp_state_for(model, tcfg, group)
    if tcfg.partition != "zero1":
        raise ValueError(f"unknown partition {tcfg.partition!r}")
    n_dp = dist.get_world_size(group)
    meta = zero1_lib.plan_buckets(model.leaves(), n_dp,
                                  block=tcfg.policy.profile.block)
    ost = zero1_lib.zero1_init_local(tcfg.optim, meta, model.leaves(),
                                     dp_index=dist.get_rank(group))
    return TrainState(model=model, opt=ost, meta=meta)


def build_train_state(cfg: ArchConfig, tcfg: TrainConfig, *,
                      generator: torch.Generator, group=None,
                      device="cuda") -> TrainState:
    """Randomly initialised model + its ``tcfg.partition`` state on
    ``device``."""
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
    loss = _microbatch_grads(lambda mb: loss_fn(state.model, mb, tcfg), batch,
                             tcfg.microbatches)
    grads = _grads_of(leaves)
    with torch.no_grad():
        new_params, new_opt, flag, gnorm = zero1_lib.zero1_step(
            tcfg.optim, state.meta, leaves, grads, state.opt, group=group,
            policy=tcfg.policy, plan=plan)
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


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------

def plan_fsdp_tree(cfg: ArchConfig, tcfg: TrainConfig, n_dp: int) -> dict:
    """The sharded dim of every parameter leaf (-1 = replicated), as a tree
    like the parameters': a leaf under ``fsdp_min_bytes`` or outside the
    codec stays replicated; else its last dim that divides ``n_dp`` and that
    the reference's tensor-parallel layout leaves alone
    (``transformer.model_axis_dims``), going down, never dim 0 (the blocks'
    stacked dim)."""
    shapes = transformer.abstract_params(cfg)

    def choose(leaf, taken):
        if leaf.numel() * leaf.element_size() < tcfg.fsdp_min_bytes:
            return -1
        if dtype_name(leaf.dtype) not in codec.LAYOUTS:
            return -1
        for d in range(leaf.ndim - 1, 0, -1):
            if d not in taken and leaf.shape[d] % n_dp == 0:
                return d
        return -1

    leaves, treedef = tree_flatten(shapes)
    taken = tree_flatten_up_to(treedef, transformer.model_axis_dims(cfg))
    return tree_unflatten(treedef, [choose(t, k) for t, k in zip(leaves, taken)])


def fsdp_local_shapes(params_shape, plan: dict, n_dp: int):
    """The per-rank shards of a tree of (``meta``) tensors: each sharded
    dim divided by ``n_dp``."""
    leaves, treedef = tree_flatten(params_shape)
    out = []
    for t, d in zip(leaves, tree_leaves(plan), strict=True):
        shape = list(t.shape)
        if d >= 0:
            shape[d] //= n_dp
        out.append(torch.empty(shape, dtype=t.dtype, device="meta"))
    return tree_unflatten(treedef, out)


def _fsdp_state(model_tree: dict, cfg: ArchConfig, tcfg: TrainConfig, dims: dict,
                opt_state=None, step: int = 0) -> TrainState:
    model = transformer.Transformer(
        cfg, {p: t.contiguous() for p, t in transformer.tree_paths(model_tree)})
    if opt_state is None:
        opt_state = opt.init(tcfg.optim, model.tree())
    return TrainState(model=model, opt=opt_state, meta=None, step=step, fsdp_dims=dims)


def fsdp_state_for(model: transformer.Transformer, tcfg: TrainConfig,
                   group=None) -> TrainState:
    """FSDP train state around existing weights: this rank's shards
    (``fsdp.shard_tree_by_plan``) and the optimizer state of the shards."""
    n_dp = dist.get_world_size(group)
    dims = plan_fsdp_tree(model.cfg, tcfg, n_dp)
    local = fsdp_lib.shard_tree_by_plan(dims, model.tree(), dist.get_rank(group), n_dp)
    return _fsdp_state(local, model.cfg, tcfg, dims)


def load_reference_fsdp_state(tree: dict, cfg: ArchConfig, tcfg: TrainConfig, *,
                              n_dp: int = 1, dp_index: int = 0,
                              device="cuda") -> TrainState:
    """Rank ``dp_index``'s FSDP train state from the reference's:
    ``tree = jax.tree_util.tree_map(np.asarray, state)`` of its
    ``build_train_state`` at ``partition="fsdp"`` over ``n_dp`` data ranks.
    Its parameters are global (this rank's shards are cut here); its
    optimizer leaves carry a leading data-rank dim, which is indexed away
    as the reference's ``_opt_local`` does; ``count`` and ``step`` are
    scalars."""
    dev = kernels.resolve_device(device)
    dims = plan_fsdp_tree(cfg, tcfg, n_dp)
    dts, arrays = transformer.leaf_dtypes(cfg), dict(transformer.tree_paths(tree["params"]))
    full = transformer._map_paths(
        tree["params"], lambda p: transformer.numpy_to_torch(np.asarray(arrays[p]), dts[p]))
    local = tree_map(lambda t: t.contiguous().to(dev),
                     fsdp_lib.shard_tree_by_plan(dims, full, dp_index, n_dp))
    ost = tree_map(lambda a: torch.from_numpy(np.array(a if a.ndim == 0 else a[dp_index]))
                   .to(dev), tree["opt"])
    return _fsdp_state(local, cfg, tcfg, dims, ost, int(tree["step"]))


def _gather_leaves(tree, dims, tcfg: TrainConfig, group, cache):
    """Gather the sharded leaves of ``tree`` (``dims``: a tree like it of
    sharded dims, -1 = replicated): each sharded dim moved last, gathered
    (``fsdp.gather_leaf``) and moved back.  The gathers' overflow flags are
    dropped, as the reference's step drops them."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for t, d in zip(leaves, tree_leaves(dims), strict=True):
        if d < 0:
            out.append(t)
            continue
        full, _flag = fsdp_lib.gather_leaf(t.movedim(d, -1), group, policy=tcfg.policy,
                                           cache=cache)
        out.append(full.movedim(-1, d))
    return tree_unflatten(treedef, out)


def fsdp_loss_fn(state: TrainState, batch: dict, tcfg: TrainConfig, *, group=None,
                 cache=None) -> torch.Tensor:
    """Mean token cross-entropy of the sharded model: the top-level leaves
    (the embeddings, the final norm, the prefix layers and the encoder's
    leaves, by path) gathered once, each stacked layer's leaves gathered inside the layer (with the
    layer under ``remat``, so its backward gathers them again)."""
    model = state.model
    dims = dict(transformer.tree_paths(state.fsdp_dims))
    top = {k: p for k, p in model.params.items() if not k.startswith("blocks/")}
    top_full = _gather_leaves(top, {k: dims[k] for k in top}, tcfg, group, cache)
    # a layer's slice of a stacked leaf: its sharded dim less the stacked one
    layer_dims = [tree_map(lambda d: d - 1 if d > 0 else -1, b)
                  for b in state.fsdp_dims["blocks"]]
    sinks = current_sinks()

    def gather_layer(p, idx):
        if idx < 0:  # a prefix layer: gathered with the top-level leaves
            return p
        # a rematerialised layer gathers again on the autograd engine's
        # thread (on CUDA): its wires report into this caller's capture
        with report_into(sinks):
            return _gather_leaves(p, layer_dims[idx], tcfg, group, cache)

    hidden = model(batch["tokens"], vision_embeds=batch.get("vision_embeds"),
                   frames=batch.get("frames"), top=top_full, remat=tcfg.remat,
                   block_param_fn=gather_layer)
    head = top_full["embed" if model.cfg.tie_embeddings else "lm_head"]
    return chunked_ce_loss(head, hidden, batch["labels"], tcfg.loss_chunk)


def fsdp_train_step(state: TrainState, batch: dict, tcfg: TrainConfig, *, group=None,
                    cache=None) -> dict:
    """One FSDP step; updates ``state`` in place.  The loss is scaled by
    1/n_dp (a gather's backward SUMS over ranks); the replicated leaves'
    gradients are summed with ``psum_safe``; the global norm adds the
    shards' squares over the group to the replicated leaves' own; the
    optimizer updates the local shards.  Returns ``{"loss" (mean over
    ranks), "gnorm", "overflow": 0}``: the reference's step reports no
    overflow."""
    n_dp = dist.get_world_size(group)
    leaves = state.model.leaves()
    for p in leaves:
        p.grad = None
    loss = _microbatch_grads(
        lambda mb: fsdp_loss_fn(state, mb, tcfg, group=group, cache=cache) / n_dp,
        batch, tcfg.microbatches)
    dims = tree_leaves(state.fsdp_dims)
    with torch.no_grad():
        grads = [g if d >= 0 else psum_safe(g, group)
                 for g, d in zip(_grads_of(leaves), dims, strict=True)]
        sq_all = sq_shard = torch.zeros((), dtype=torch.float32, device=loss.device)
        for g, d in zip(grads, dims):
            sq = torch.sum(torch.square(g.to(torch.float32)))
            sq_all = sq_all + sq
            if d >= 0:
                sq_shard = sq_shard + sq
        sq_rep = sq_all - sq_shard
        dist.all_reduce(sq_shard, group=group)  # the shards are disjoint
        gnorm = torch.sqrt(sq_shard + sq_rep)
        scale = torch.clamp(tcfg.optim.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = [(g.to(torch.float32) * scale).to(g.dtype) for g in grads]
        params = state.model.tree()
        treedef = tree_flatten(params)[1]
        new_params, state.opt = opt.update(tcfg.optim, tree_unflatten(treedef, grads),
                                           state.opt, params)
        for p, new in zip(leaves, tree_leaves(new_params)):
            p.copy_(new)
        state.step += 1
        loss = loss * n_dp
        dist.all_reduce(loss, group=group)
        loss = loss / n_dp
    for p in leaves:
        p.grad = None
    return {"loss": loss, "gnorm": gnorm, "overflow": 0}


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
