"""Tensor and expert parallelism over the mesh's 'model' axis: the port's
explicit form of what GSPMD inserts around the reference's layers when
their leaves are laid out by ``transformer.specs``.

A rank holds its block of every leaf that the layout splits over 'model'
(``launch/mesh.block_of``) and runs the layer on it; the activations
between layers (the residual stream) are replicated over 'model'.  Three
``torch.autograd.Function``\\ s move them in and out of a split region:

* :func:`copy` enters a column-parallel region: identity forward, its
  backward sums the ranks' partial input gradients (each rank's block of
  the columns sees only its part of the input's uses);
* :func:`reduce` leaves a row-parallel region: the ranks' partial outputs
  summed forward, identity backward;
* :func:`gather` joins the ranks' blocks of an activation along a dim
  (where a block of columns is not whole attention heads), and its
  backward reduce-scatters the gradient along that dim.

Every sum is the raw two-shot of ``core/compressed_collectives``
(``psum_raw_twoshot``: an all-to-all, a sum in rank order in f32 cast back
to the tensor's dtype once, an all-gather): the same bits on every rank of
the group and on every backend, and the same order from one step to the
next.  A max is an all-gather and ``amax``.  At a model group of one rank
(or none) each of them is the identity, so a model on one rank computes
what it computed before.

:func:`vocab_embed` and :func:`vocab_ce_sum` are the vocabulary-parallel
embedding and cross-entropy that the ``("model", None)`` layout of
``embed`` and ``lm_head`` implies."""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import compressed_collectives as cc


class ModelGroup:
    """This rank's process group over the mesh's 'model' axis, its size and
    its index in it (the rank's coordinate on the axis)."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def __repr__(self) -> str:
        return f"ModelGroup(rank {self.rank} of {self.size})"


def model_group(mesh) -> ModelGroup | None:
    """The 'model' group of ``mesh`` (``launch.mesh.axis_group``), made once
    a mesh and cached on it; None where the axis is missing or has one
    rank (no tensor parallelism)."""
    from repro_torch.launch import mesh as mesh_lib

    if mesh is None or mesh_lib.axis_sizes(mesh).get("model", 1) == 1:
        return None
    cache = mesh.__dict__
    if "_model_group" not in cache:
        cache["_model_group"] = ModelGroup(mesh_lib.axis_group(mesh, ("model",)))
    return cache["_model_group"]


def active(mg: ModelGroup | None) -> bool:
    return mg is not None and mg.size > 1


def _stacked(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading dim, in rank order."""
    return cc.raw_all_gather(x.reshape(-1), mg.group).reshape(mg.size, *x.shape)


def all_sum(x: torch.Tensor, mg: ModelGroup | None) -> torch.Tensor:
    """The sum of ``x`` over the group (``psum_raw_twoshot``: in rank order,
    accumulated in f32 and cast back to ``x``'s dtype); identical on every
    rank."""
    if not active(mg):
        return x
    return cc.psum_raw_twoshot(x, mg.group)


def all_max(x: torch.Tensor, mg: ModelGroup | None) -> torch.Tensor:
    """The elementwise max of ``x`` over the group."""
    if not active(mg):
        return x
    return _stacked(x, mg).amax(0)


def _gather_dim(x: torch.Tensor, mg: ModelGroup, dim: int) -> torch.Tensor:
    return torch.cat(list(_stacked(x, mg)), dim=dim)


def _reduce_scatter_dim(g: torch.Tensor, mg: ModelGroup, dim: int) -> torch.Tensor:
    """Block ``rank`` of ``g`` along ``dim`` summed over the group (rank
    order, f32): an all-to-all of the blocks, then the sum."""
    blocks = torch.stack(g.chunk(mg.size, dim=dim))
    return cc._seq_sum(cc.raw_all_to_all(blocks, mg.group)).to(g.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.mg), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return all_sum(x, mg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim = mg, dim
        return _gather_dim(x, mg, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.mg, ctx.dim), None, None


def copy(x: torch.Tensor, mg: ModelGroup | None) -> torch.Tensor:
    """Enter a column-parallel region: ``x`` as it is, its gradient summed
    over the group."""
    return _Copy.apply(x, mg) if active(mg) else x


def reduce(x: torch.Tensor, mg: ModelGroup | None) -> torch.Tensor:
    """Leave a row-parallel region: ``x`` summed over the group (f32, rank
    order), its gradient passed through."""
    return _Reduce.apply(x, mg) if active(mg) else x


def gather(x: torch.Tensor, mg: ModelGroup | None, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of ``x`` joined along ``dim`` in rank order; the
    backward sums the gradient over the group and keeps this rank's block."""
    if not active(mg):
        return x
    return _Gather.apply(x, mg, dim % x.ndim)


# ---------------------------------------------------------------------------
# the vocabulary split over 'model': embedding and cross-entropy
# ---------------------------------------------------------------------------

def _own(labels: torch.Tensor, rows: int, mg: ModelGroup) -> tuple:
    """(whether this rank's block of ``rows`` vocabulary rows holds each
    id, the id's row in the block, 0 where it is not there)."""
    local = labels - mg.rank * rows
    own = (local >= 0) & (local < rows)
    return own, torch.where(own, local, 0)


def vocab_embed(tokens: torch.Tensor, table: torch.Tensor,
                mg: ModelGroup | None) -> torch.Tensor:
    """Embeddings of ``tokens`` from ``table``, this rank's block of the
    vocabulary's rows: each rank looks up the tokens in its rows (zeros
    for the others), and the lookups are summed over the group."""
    if not active(mg):
        return F.embedding(tokens, table)
    own, local = _own(tokens, table.shape[0], mg)
    e = F.embedding(local, table)
    return reduce(torch.where(own[..., None], e, e.new_zeros(())), mg)


def vocab_ce_sum(logits: torch.Tensor, labels: torch.Tensor,
                 mg: ModelGroup | None) -> torch.Tensor:
    """The summed token cross-entropy of f32 ``logits`` (..., V) whose last
    dim is this rank's block of the vocabulary: logsumexp over the whole
    vocabulary (the max over the group, then the sum of exponentials over
    it) less the gold logit (from the rank whose block holds the label),
    each all-reduced over the group.  The same value on every rank; its
    gradient is each rank's block of the softmax less the one-hot label."""
    if not active(mg):
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.sum(torch.logsumexp(logits, dim=-1) - gold)
    m = all_max(logits.detach().amax(-1), mg)
    sum_exp = reduce(torch.exp(logits - m[..., None]).sum(-1), mg)
    own, local = _own(labels, logits.shape[-1], mg)
    gold = torch.gather(logits, -1, local[..., None])[..., 0]
    gold = reduce(torch.where(own, gold, gold.new_zeros(())), mg)
    return torch.sum(torch.log(sum_exp) + m - gold)
