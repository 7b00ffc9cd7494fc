"""Compressed FSDP (ZeRO-3): parameters sharded over the data-parallel group,
gathered on demand by the *compressed all-gather* and grad-synced by its
transpose, the *compressed reduce-scatter* (torch port of
``repro.optim.fsdp``).

The parameter all-gather is a weight transfer, the tensor class whose
compression the paper shows on the RL weight-sync path, so the forward wire
runs at the weight-class width and the backward reduce-scatter at the
gradient-class width.

Mechanics:
  * a leaf is sharded iff its last dim divides ``n_dp``, its payload is at
    least ``min_shard_bytes`` and its dtype is a codec float
    (:func:`plan_fsdp`; the train step's own rule is
    ``train/step.plan_fsdp_tree``); other leaves stay replicated and the
    caller sums their gradients;
  * a sharded leaf is stored as this rank's slice of the sharded dim; its
    gather (:class:`GatherWire`, a ``torch.autograd.Function`` underneath)
    is the compressed all-gather forward, with the overflow flag as a second
    output that carries no gradient, and the compressed reduce-scatter of
    the cotangent backward (a SUM over ranks: the 1/n_dp of a mean is the
    loss's job);
  * losslessness: both wires carry the exception region, so every block is
    exact unless the exception capacity overflows; :func:`gather_tree`
    returns the forward flag.

Every wire is the ``core/compressed_collectives`` primitive with the plan's
arguments (``sched/compile.compile_fsdp_gather_plan``, replayed by
``sched/executor.gather_from_plan``); the raw twin reduces in f32 in rank
order, as the fused receive does, so compressed and raw agree bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import codec
from repro_torch.core.compressed_collectives import (_no_flag, _pad_rows, _seq_sum,
                                                     all_gather_compressed, raw_all_gather,
                                                     raw_all_to_all,
                                                     reduce_scatter_compressed)
from repro_torch.core.policy import CompressionPolicy, current_sinks, report_into
from repro_torch.sched.plan import dtype_name
from repro_torch.tree_util import tree_flatten, tree_unflatten


@dataclasses.dataclass(frozen=True)
class FsdpPlan:
    """Static per-leaf decision: True = sharded on the last dim."""

    mask_leaves: tuple  # booleans, in tree_flatten order
    n_dp: int
    min_shard_bytes: int = 1 << 20


def plan_fsdp(params, n_dp: int, *, min_shard_bytes: int = 1 << 20) -> FsdpPlan:
    """Shard a leaf iff it has a dim, its last dim divides ``n_dp``, it holds
    ``min_shard_bytes`` and its dtype is a codec float."""
    mask = []
    for t in tree_flatten(params)[0]:
        mask.append(bool(t.ndim >= 1 and t.shape[-1] % n_dp == 0
                         and t.numel() * t.element_size() >= min_shard_bytes
                         and dtype_name(t.dtype) in codec.LAYOUTS))
    return FsdpPlan(tuple(mask), n_dp, min_shard_bytes)


def mask_tree(plan: FsdpPlan, tree):
    """The boolean mask as a tree shaped like ``tree``."""
    return tree_unflatten(tree_flatten(tree)[1], list(plan.mask_leaves))


def shard_leaf(leaf: torch.Tensor, n_dp: int, idx: int) -> torch.Tensor:
    """Rank ``idx``'s slice of the last dim: (..., F) -> (..., F / n_dp)."""
    sl = leaf.shape[-1] // n_dp
    return leaf.narrow(leaf.ndim - 1, idx * sl, sl)


def shard_tree(plan: FsdpPlan, tree, idx: int):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [shard_leaf(t, plan.n_dp, idx) if m else t
                                    for t, m in zip(leaves, plan.mask_leaves, strict=True)])


def shard_tree_by_plan(plan_tree, tree, idx: int, n_dp: int):
    """Shard per the train step's plan, a tree of dims (-1 = replicated):
    rank ``idx``'s slice of each sharded leaf's dim, as a view."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for t, d in zip(leaves, tree_flatten(plan_tree)[0], strict=True):
        sl = t.shape[d] // n_dp if d >= 0 else 0
        out.append(t if d < 0 else t.narrow(d, idx * sl, sl))
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# the compressed gather and its transpose (the FSDP wire)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GatherWire:
    """One leaf signature's gather over the last dim (the reference's
    ``_make_gather``): forward the all-gather at ``w_fwd``, backward the
    reduce-scatter of the cotangent at ``w_bwd`` with the fused receive
    when ``use_fused``; both encode in one pass when ``fused_encode``.
    ``compressed=False`` is the raw twin.  Call it as ``wire(local, group)
    -> (full, flag)``; autograd differentiates through it."""

    axes: tuple
    w_fwd: int
    w_bwd: int
    block: int
    exc_frac: float
    compressed: bool
    local_shape: tuple
    dtype_name: str
    use_fused: bool = True
    fused_encode: bool = True

    def __call__(self, local: torch.Tensor, group=None) -> tuple:
        return _Gather.apply(local, self, group)

    def all_gather(self, local: torch.Tensor, group) -> tuple:
        """(..., f) -> ((..., n_dp * f), flag): rank j's shard is the j-th
        slice of the last dim."""
        nd = dist.get_world_size(group)
        flat = local.reshape(-1)  # row-major: last dim minor
        if self.compressed:
            stacked, flag = all_gather_compressed(
                flat, group, width=self.w_fwd, block=self.block, exc_frac=self.exc_frac,
                fused_encode=self.fused_encode, axis_name=self.axes)
            stacked = stacked[:, :flat.shape[0]]
        else:
            stacked, flag = _raw_ag(flat, group), _no_flag(local)
        # (n_dp, ..., f) -> (..., n_dp, f) -> (..., n_dp * f)
        stacked = stacked.reshape((nd,) + tuple(local.shape))
        perm = tuple(range(1, local.ndim)) + (0, local.ndim)
        full = stacked.permute(perm).reshape(tuple(local.shape[:-1])
                                             + (nd * local.shape[-1],))
        return full.to(local.dtype), flag

    def reduce_scatter(self, ct_full: torch.Tensor, group) -> torch.Tensor:
        """Cotangent (..., n_dp * f) -> this rank's (..., f): the sum over
        ranks of their cotangents' slice for this rank, in the leaf's dtype."""
        nd = dist.get_world_size(group)
        dtype = codec.LAYOUTS[self.dtype_name].dtype
        f = self.local_shape[-1]
        # (..., nd, f) -> (nd, ..., f) -> one flat row per destination
        ct = ct_full.reshape(self.local_shape[:-1] + (nd, f))
        perm = (ct.ndim - 2,) + tuple(range(ct.ndim - 2)) + (ct.ndim - 1,)
        rows = ct.permute(perm).reshape(nd, -1)
        ln = rows.shape[1]
        # pad each destination row to a block multiple BEFORE flattening, so
        # that the wire's (n_dev, chunk) rows land on destination boundaries
        rows = _pad_rows(rows.to(dtype), self.block)
        if self.compressed:
            red, _ = reduce_scatter_compressed(
                rows.reshape(-1), group, width=self.w_bwd, block=self.block,
                exc_frac=self.exc_frac, use_fused=self.use_fused,
                fused_encode=self.fused_encode, axis_name=self.axes)
            red = red[:ln]
        else:
            red = _raw_rs(rows, group)[:ln]
        # the transpose of "replicate my shard to every rank" is the SUM over
        # ranks; the 1/n_dp of a mean is the loss's job
        return red.reshape(self.local_shape).to(dtype)


class _Gather(torch.autograd.Function):
    """The gather as an autograd node: its backward is the wire's
    reduce-scatter; the overflow flag is an output without a gradient."""

    @staticmethod
    def forward(ctx, local, wire: GatherWire, group):
        ctx.wire, ctx.group, ctx.sinks = wire, group, current_sinks()
        full, flag = wire.all_gather(local, group)
        ctx.mark_non_differentiable(flag)
        return full, flag

    @staticmethod
    def backward(ctx, ct_full, _ct_flag):
        # on CUDA this runs on the autograd engine's device thread: report
        # the reduce-scatter's wire into the forward caller's capture
        with report_into(ctx.sinks):
            return ctx.wire.reduce_scatter(ct_full, ctx.group), None, None


def _raw_ag(flat: torch.Tensor, group) -> torch.Tensor:
    """Uncompressed all-gather of a flat shard: (n_dp, n), rank order."""
    return raw_all_gather(flat, group).reshape(dist.get_world_size(group), -1)


def _raw_rs(rows: torch.Tensor, group) -> torch.Tensor:
    """Uncompressed reduce-scatter as all_to_all + f32 sum in rank order (the
    fused compressed receive's order), cast back to the rows' dtype."""
    return _seq_sum(raw_all_to_all(rows, group), torch.float32).to(rows.dtype)


def gather_leaf(leaf: torch.Tensor, group=None, *, policy: CompressionPolicy,
                axis_name="data", cache=None) -> tuple:
    """Gather one shard over its last dim on its signature's cached
    ``fsdp_gather`` plan (``cache``: default the process cache).  Returns
    (full leaf, overflow flag)."""
    from repro_torch.sched import compile as sched_compile
    from repro_torch.sched.executor import gather_from_plan

    gplan = sched_compile.cached_fsdp_gather_plan(
        tuple(leaf.shape), dtype_name(leaf.dtype), axis_name, policy=policy,
        n_dev=dist.get_world_size(group), device=leaf.device, cache=cache)
    return gather_from_plan(gplan, group)(leaf)


def gather_tree(plan: FsdpPlan, tree, *, group=None, policy: CompressionPolicy,
                axis_name="data", cache=None) -> tuple:
    """Gather every sharded leaf of ``tree`` (``plan.mask_leaves``).
    Returns (full tree, flag): the flag is the max of the gathers' overflow
    flags.  Differentiable: the gradient of a gather is its compressed
    reduce-scatter, so ``backward`` through it leaves reduced sharded
    gradients."""
    leaves, treedef = tree_flatten(tree)
    flag = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    out = []
    for t, m in zip(leaves, plan.mask_leaves, strict=True):
        if not m:
            out.append(t)
            continue
        full, f = gather_leaf(t, group, policy=policy, axis_name=axis_name, cache=cache)
        flag = torch.maximum(flag, f)
        out.append(full)
    return tree_unflatten(treedef, out), flag
