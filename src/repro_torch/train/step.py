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
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.core import codec
from repro_torch.core.compressed_collectives import psum_safe
from repro_torch.core.policy import CompressionPolicy, current_sinks, report_into
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import tp, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.optim import fsdp as fsdp_lib
from repro_torch.optim import optimizers as opt
from repro_torch.optim import zero1 as zero1_lib
from repro_torch.sched import compile as sched_compile
from repro_torch.sched.plan import dtype_name
from repro_torch.tree_util import (tree_flatten, tree_flatten_up_to, tree_leaves, tree_map,
                                   tree_map_up_to, tree_unflatten)


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
    # pure data parallelism: the parameters replicated over 'model', which
    # carries batch rows as the data axes do, and the ZeRO-1 sync runs over
    # (pod, data, model) as one exchange
    dp_only: bool = False


@dataclasses.dataclass
class TrainState:
    """``zero1``: the model holds the whole weights, ``opt`` this rank's
    shard state (``zero1_init_local``) and ``meta`` its bucket layout.
    ``fsdp``: the model holds this rank's shards, ``opt`` the optimizer
    state of those shards (``optimizers.init``) and ``fsdp_dims`` the
    sharded dim of every leaf (:func:`plan_fsdp_tree`).  ``group`` is the
    process group the steps sync over (None: the world) and ``axes`` the
    mesh axes it spans, the label the wires are gated and planned under.
    With tensor parallelism (ZeRO-1 at model > 1) the model holds this
    rank's blocks and its model group (``model.mg``), and ``meta`` lays
    out the buckets of those blocks, one set a model rank, as the
    reference's ``zero1_meta`` on ``local_param_struct``.  FSDP at model > 1
    holds this rank's DP shard of its model block of each leaf, and its
    optimizer state is that of those shards."""

    model: transformer.Transformer
    opt: dict
    meta: zero1_lib.BucketMeta | None
    step: int = 0
    fsdp_dims: dict | None = None
    group: object = None
    axes: object = "data"

    def tree(self) -> dict:
        """The state as the reference's train-state tree ``{"params",
        "opt", "step"}``, this rank's part of it (a ZeRO-1 state's shard
        leaves ``(shard_len,)``); the parameters share the model's
        storage."""
        return {"params": self.model.tree(), "opt": self.opt,
                "step": torch.tensor(self.step, dtype=torch.int32)}

    def _place(self) -> tuple:
        """(this rank's index, the sync group's size); (0, 1) outside a
        process group."""
        if not dist.is_initialized():
            return 0, 1
        return dist.get_rank(self.group), dist.get_world_size(self.group)

    def _model_dims(self) -> list:
        """Per parameter leaf, its dim split over the model group (-1 where
        it is whole); None without a model group."""
        mg = self.model.mg
        if mg is None:
            return None
        dims = model_dims(self.model.cfg, mg.size)
        return [dims[path] for path in self.model.params]

    def _opt_model_dims(self) -> list:
        """Per optimizer leaf of an FSDP state with a model group (tree
        order), its dim split over the model group, -1 where it is whole:
        a moment's is its parameter's; Adafactor's row factor ``vr`` drops
        the last dim and its column factor ``vc`` the one before (a factor
        whose mean ran over the split dim is whole on every rank)."""
        dims = self._model_dims()
        params, treedef = tree_flatten(self.model.tree())
        if "f" not in self.opt:
            t = tree_unflatten(treedef, dims)
            return tree_leaves({"m": t, "v": t, "count": -1})
        per = []
        for p, d, f in zip(params, dims, tree_flatten_up_to(treedef, self.opt["f"]),
                           strict=True):
            nd = p.ndim
            per.append({"v": d} if "v" in f else
                       {"vr": d if d < nd - 1 else -1,
                        "vc": d if d < nd - 2 else nd - 2 if d == nd - 1 else -1})
        return tree_leaves({"f": tree_unflatten(treedef, per), "count": -1})

    def _global_shapes(self) -> tuple:
        """(parameter shapes, optimizer leaf shapes) of the reference's
        global layout: a ZeRO-1 bucket leaf ``(n_dp, n_model * shard_len)``
        (n_model 1 without tensor parallelism), a parameter block's split
        dim times n_model; an FSDP shard's sharded dim times n_dp, an FSDP
        optimizer leaf ``(n_dp,) + its shard's shape``; every other leaf as
        this rank holds it."""
        _, n = self._place()
        params = [tuple(p.shape) for p in self.model.leaves()]
        ost = [tuple(t.shape) for t in tree_leaves(self.opt)]
        dims, mg = self._model_dims(), self.model.mg
        if dims is not None:
            params = [sh if d < 0 else sh[:d] + (sh[d] * mg.size,) + sh[d + 1:]
                      for sh, d in zip(params, dims, strict=True)]
        if self.meta is not None:
            n_model = 1 if mg is None else mg.size
            ost = [(self.meta.n_dp, n_model * sh[0]) if len(sh) else sh for sh in ost]
        elif self.fsdp_dims is not None:
            params = [sh if d < 0 else sh[:d] + (sh[d] * n,) + sh[d + 1:]
                      for sh, d in zip(params, tree_leaves(self.fsdp_dims), strict=True)]
            odims = [-1] * len(ost) if mg is None else self._opt_model_dims()
            ost = [(n, *(s * mg.size if i == od else s for i, s in enumerate(sh)))
                   if len(sh) else sh for sh, od in zip(ost, odims, strict=True)]
        return params, ost

    def global_like(self) -> dict:
        """The tree a checkpoint holds (:meth:`checkpoint_tree`), as
        ``meta`` tensors of the reference's global shapes."""
        params, ost = self._global_shapes()
        meta = lambda shapes, like: tree_unflatten(tree_flatten(like)[1], [  # noqa: E731
            torch.empty(sh, dtype=t.dtype, device="meta")
            for sh, t in zip(shapes, tree_leaves(like), strict=True)])
        return {"params": meta(params, self.model.tree()), "opt": meta(ost, self.opt),
                "step": torch.empty((), dtype=torch.int32, device="meta")}

    def checkpoint_tree(self) -> dict | None:
        """The tree a checkpoint writes, in the reference's global layout
        (collective over ``group``): the optimizer leaves as
        ``zero1.local_to_global`` lays them out, row ``d`` data rank
        ``d``'s; FSDP's parameter shards joined on their sharded dim.  The
        group's rank 0 gets it (on its host at n ranks) and writes it; None
        on the other ranks.  With tensor parallelism the whole mesh takes
        part and its rank 0 writes: each optimizer leaf's ``(sl,)`` pieces
        gathered from every rank, row ``d`` the pieces of DP index ``d``'s
        model ranks side by side (``P(dp, None)`` of ``(n_dp, n_model *
        sl)``: rank ``d * n_model + m`` of the mesh, 'model' its last axis);
        the parameter blocks gathered over the model group of DP index 0
        and joined on their split dim."""
        tree = self.tree()
        if self.model.mg is not None and self.fsdp_dims is not None:
            return self._fsdp_tp_checkpoint_tree(tree)
        if self.model.mg is not None:
            return self._tp_checkpoint_tree(tree)
        tree["opt"] = zero1_lib.local_to_global(self.opt, self.group)
        if self.fsdp_dims is not None:
            params, pdef = tree_flatten(tree["params"])
            joined = []
            for p, d in zip(params, tree_leaves(self.fsdp_dims), strict=True):
                rows = None if d < 0 else zero1_lib.gather_rows(p.detach(), self.group)
                joined.append(p if rows is None or len(rows) == 1 else
                              torch.cat(list(rows), dim=d))
            tree["params"] = tree_unflatten(pdef, joined)
        return None if tree["opt"] is None else tree

    def _tp_checkpoint_tree(self, tree: dict) -> dict | None:
        mg = self.model.mg
        rows = zero1_lib.local_to_global(self.opt, dist.group.WORLD)
        params, pdef = tree_flatten(tree["params"])
        if dist.get_rank(self.group) == 0:  # DP index 0: the model group of rank 0
            params = [p if d < 0 else zero1_lib.gather_rows(p.detach(), mg.group)
                      for p, d in zip(params, self._model_dims(), strict=True)]
            params = [p if d < 0 or p is None else torch.cat(list(p), dim=d)
                      for p, d in zip(params, self._model_dims(), strict=True)]
        if rows is None:
            return None
        n_dp = self.meta.n_dp
        tree["opt"] = tree_map(lambda v: v if v.ndim == 0 else v.reshape(n_dp, -1), rows)
        tree["params"] = tree_unflatten(pdef, params)
        return tree

    def _fsdp_tp_checkpoint_tree(self, tree: dict) -> dict | None:
        """FSDP at model > 1: every leaf's pieces gathered from every rank
        of the mesh to its rank 0's host (rank ``d * n_model + m``: DP
        index ``d``, model rank ``m``), a leaf at a time; a parameter's
        model blocks joined on its split dim, then its DP shards on its
        sharded dim; an optimizer leaf's model blocks joined, its DP rows
        stacked ``(n_dp, ...)``."""
        n_model = self.model.mg.size

        def rows_of(t, dm):  # [the model blocks joined] for each DP index
            rows = zero1_lib.gather_rows(t.detach(), dist.group.WORLD)
            if rows is None:
                return None
            rows = rows.reshape(-1, n_model, *rows.shape[1:])
            return [r[0] if dm < 0 else torch.cat(list(r), dim=dm) for r in rows]

        params, pdef = tree_flatten(tree["params"])
        joined = []
        for p, dm, df in zip(params, self._model_dims(), tree_leaves(self.fsdp_dims),
                             strict=True):
            rows = rows_of(p, dm)
            joined.append(None if rows is None else rows[0] if df < 0 else
                          torch.cat(rows, dim=df))
        leaves, odef = tree_flatten(self.opt)
        ost = []
        for v, od in zip(leaves, self._opt_model_dims(), strict=True):
            rows = [v] if v.ndim == 0 else rows_of(v, od)
            ost.append(None if rows is None else v if v.ndim == 0 else torch.stack(rows))
        if dist.get_rank() != 0:
            return None
        return dict(tree, params=tree_unflatten(pdef, joined), opt=tree_unflatten(odef, ost))

    def _opt_blocks(self, ost: dict) -> dict:
        """An FSDP optimizer tree of this rank's DP shards, model-global (the
        reference's row of it), cut to this model rank's blocks, each a
        copy; a leaf of this state's own shape is taken as it is."""
        leaves, odef = tree_flatten(ost)
        mg = self.model.mg
        return tree_unflatten(odef, [
            v if od < 0 or v.shape == q.shape else
            v.narrow(od, mg.rank * q.shape[od], q.shape[od]).clone(
                memory_format=torch.contiguous_format)
            for v, q, od in zip(leaves, tree_leaves(self.opt), self._opt_model_dims(),
                                strict=True)])

    def from_tree(self, tree: dict, device=None) -> "TrainState":
        """A new state holding ``tree``, with this state's config, layout
        and group, its leaves on ``device`` (default: this state's).  A
        tree in the global layout gives this rank its part, a copy with
        storage of its own: its row of the optimizer leaves
        (``zero1.global_to_local``; a ``(1, ...)`` leaf is this rank's
        block from ``restore(shardings=)``, an ``(n_dp, ...)`` one the
        whole) and its shard of an FSDP parameter of the global shape; with
        tensor parallelism, its model rank's block of each parameter and its
        columns of the optimizer rows.  A tree of this rank's own shapes
        (:meth:`tree`) is taken as it is."""
        me, n = self._place()
        dev = self.model.leaves()[0].device if device is None else device
        params, pdef = tree_flatten(tree["params"])
        mg = self.model.mg
        if mg is not None:
            params = [p if d < 0 or p.shape == q.shape else
                      p.narrow(d, mg.rank * q.shape[d], q.shape[d]).clone(
                          memory_format=torch.contiguous_format)
                      for p, q, d in zip(params, self.model.leaves(), self._model_dims(),
                                         strict=True)]
        if self.fsdp_dims is not None:
            params = [p if d < 0 or p.shape == q.shape else
                      p.narrow(d, me * q.shape[d], q.shape[d]).clone(
                          memory_format=torch.contiguous_format)
                      for p, q, d in zip(params, self.model.leaves(),
                                         tree_leaves(self.fsdp_dims), strict=True)]
        model = transformer.Transformer(self.model.cfg, dict(transformer.tree_paths(
            tree_unflatten(pdef, [p.to(dev) for p in params]))), mg, mesh=self.model.mesh)

        def shapes(t):
            return [tuple(v.shape) for v in tree_leaves(t)]

        ost = tree["opt"]
        if shapes(ost) != shapes(self.opt):
            lead = {v.shape[0] for v in tree_leaves(ost) if v.ndim}
            if lead in ({1}, {n}):
                ost = zero1_lib.global_to_local(ost, 0 if lead == {1} else me)
            if mg is not None and self.meta is not None:  # this model rank's columns
                ost = tree_map(lambda v: v if v.ndim != 1 or v.shape[0] % mg.size else v.narrow(
                    0, mg.rank * (v.shape[0] // mg.size), v.shape[0] // mg.size).clone(), ost)
            if mg is not None and self.fsdp_dims is not None:
                ost = self._opt_blocks(ost)
            if shapes(ost) != shapes(self.opt):
                raise ValueError(f"optimizer leaves of {shapes(tree['opt'])} hold no part "
                                 f"of {shapes(self.opt)} for a rank of {n}")
        return dataclasses.replace(self, model=model, opt=tree_map(lambda v: v.to(dev), ost),
                                   step=int(tree["step"]))


def model_dims(cfg: ArchConfig, n_model: int) -> dict:
    """``{path: dim}``: each leaf's dim that a 'model' axis of ``n_model``
    splits (``transformer.block_specs``), -1 where it stays whole."""
    return {path: next((d for d, e in enumerate(spec) if e == "model"), -1)
            for path, spec in transformer.block_specs(cfg, n_model).items()}


def chunked_ce_loss(head: torch.Tensor, hidden: torch.Tensor,
                    labels: torch.Tensor, chunk: int, mg=None) -> torch.Tensor:
    """Mean token cross-entropy with logits materialised ``chunk`` positions
    at a time, in f32 (the reference's ``chunked_ce_loss``).  ``mg``: the
    model group over which ``head`` holds a block of the vocabulary's rows:
    each chunk's logits are this rank's block and the cross-entropy is
    vocabulary-parallel (``tp.vocab_ce_sum``)."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    total = hidden.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, chunk):
        logits = (tp.copy(hidden[:, s0:s0 + chunk], mg) @ head.T).to(torch.float32)
        total = total + tp.vocab_ce_sum(logits, labels[:, s0:s0 + chunk], mg)
    return total / (B * S)


def loss_fn(model: transformer.Transformer, batch: dict, tcfg: TrainConfig):
    hidden = model(batch["tokens"], vision_embeds=batch.get("vision_embeds"),
                   frames=batch.get("frames"), remat=tcfg.remat)
    head = model.head()
    return chunked_ce_loss(head, hidden, batch["labels"], tcfg.loss_chunk,
                           model.vocab_group(head))


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


# ---------------------------------------------------------------------------
# layouts on a mesh: specs (``launch/mesh``) and per-device shapes, read from
# the mesh's axis names and sizes only
# ---------------------------------------------------------------------------

def dp_axes_of(mesh) -> tuple:
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def train_axes_of(mesh, tcfg: TrainConfig) -> tuple:
    """The gradient-sync axes: pod and data, and 'model' too under
    ``dp_only`` (where it carries batch rows, not tensor parallelism)."""
    axes = ("pod", "data", "model") if tcfg.dp_only else ("pod", "data")
    return tuple(a for a in axes if a in mesh.mesh_dim_names)


def _sizes(mesh, axes) -> int:
    sizes = mesh_lib.axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in axes]))


def _dp_entry(axes: tuple):
    """The spec entry of a dim split over ``axes``: the name alone, or the
    tuple of names (``PartitionSpec`` holds a one-name tuple as the name)."""
    return axes if len(axes) > 1 else axes[0]


def sanitize_specs(pspecs, params_shape, mesh):
    """Specs padded to each leaf's rank, an entry dropped where its dim does
    not divide the entry's axes (xlstm's gates, 4 heads, on model = 16)."""
    def f(p, spec):
        return tuple(None if e is None or p.shape[d] % mesh_lib.entry_size(e, mesh) else e
                     for d, e in enumerate(mesh_lib.padded(spec, p.ndim)[:p.ndim]))

    return tree_map_up_to(f, params_shape, pspecs)


def model_specs(cfg: ArchConfig, mesh):
    """The parameters' tensor-parallel specs, sanitized for ``mesh``."""
    return sanitize_specs(transformer.specs(cfg), transformer.abstract_params(cfg), mesh)


def train_param_specs(cfg: ArchConfig, tcfg: TrainConfig, mesh):
    """:func:`model_specs`, or every leaf replicated under ``dp_only``."""
    if tcfg.dp_only:
        return tree_map_up_to(lambda _, s: (None,) * len(s), transformer.abstract_params(cfg),
                              transformer.specs(cfg))
    return model_specs(cfg, mesh)


def local_param_struct(cfg: ArchConfig, mesh, pspecs=None):
    """The parameters of one model shard, as ``meta`` tensors."""
    pspecs = pspecs if pspecs is not None else model_specs(cfg, mesh)
    return tree_map_up_to(
        lambda p, s: torch.empty(mesh_lib.shard_shape(p.shape, s, mesh), dtype=p.dtype,
                                 device="meta"),
        transformer.abstract_params(cfg), pspecs)


def zero1_meta(cfg: ArchConfig, n_dp: int, tcfg: TrainConfig, mesh) -> zero1_lib.BucketMeta:
    """The bucket layout of one model shard's parameters over ``n_dp`` sync
    ranks."""
    local = local_param_struct(cfg, mesh, train_param_specs(cfg, tcfg, mesh))
    return zero1_lib.plan_buckets(tree_leaves(local), n_dp, block=tcfg.policy.profile.block)


def _zero1_state_layout(cfg: ArchConfig, tcfg: TrainConfig, mesh) -> tuple:
    """(global ZeRO-1 state as ``meta`` tensors, its specs)."""
    axes = train_axes_of(mesh, tcfg)
    meta = zero1_meta(cfg, _sizes(mesh, axes), tcfg, mesh)
    n_inner = 1 if tcfg.dp_only else mesh_lib.axis_sizes(mesh)["model"]
    ostruct = zero1_lib.state_struct(tcfg.optim, meta, n_inner)
    ospecs = tree_map(lambda t: (_dp_entry(axes), None) if t.ndim == 2 else (), ostruct)
    return ostruct, ospecs


def make_train_state_specs(cfg: ArchConfig, tcfg: TrainConfig, mesh) -> dict:
    """The specs of the train state ``{"params", "opt", "step"}``: FSDP's
    sharded parameters and their optimizer state with a leading DP dim, or
    ZeRO-1's parameters replicated over the sync axes and its bucket state
    ``(n_dp, model * shard_len)`` over them."""
    if tcfg.partition == "fsdp":
        dp = dp_axes_of(mesh)
        pspecs = model_specs(cfg, mesh)
        plan = plan_fsdp_tree(cfg, tcfg, mesh)
        ospecs = fsdp_opt_specs(transformer.abstract_params(cfg), pspecs, plan, tcfg, dp,
                                _sizes(mesh, dp))
        return {"params": fsdp_param_specs(pspecs, plan, dp), "opt": ospecs, "step": ()}
    return {"params": train_param_specs(cfg, tcfg, mesh),
            "opt": _zero1_state_layout(cfg, tcfg, mesh)[1], "step": ()}


def fsdp_param_specs(pspecs, plan, dp: tuple):
    """Each sharded leaf's spec with the DP axes on its plan dim."""
    def upd(dim, spec):
        if dim < 0:
            return spec
        entries = mesh_lib.padded(spec, dim + 1)
        entries[dim] = _dp_entry(dp)
        return tuple(entries)

    return tree_map_up_to(upd, plan, pspecs)


def fsdp_opt_specs(params_shape, pspecs, plan, tcfg: TrainConfig, dp: tuple, n_dp: int):
    """The FSDP optimizer state's specs: each leaf global ``(n_dp,) +
    local shard shape``, its leading dim over the DP axes, its shard's own
    dims keeping their model-axis entries (the plan dim's entry None: it is
    local)."""
    lead = _dp_entry(dp)
    leaves, treedef = tree_flatten(params_shape)
    specs = tree_flatten_up_to(treedef, pspecs)

    def local_entries(p, spec, dim):
        entries = mesh_lib.padded(spec, p.ndim)
        if dim >= 0:
            entries[dim] = None
        return entries

    def full(p, spec, dim):
        return (lead, *local_entries(p, spec, dim))

    rows = list(zip(leaves, specs, tree_leaves(plan), strict=True))
    if tcfg.optim.name == "adamw":
        tree = tree_unflatten(treedef, [full(*r) for r in rows])
        return {"m": tree, "v": tree, "count": ()}

    def af(p, spec, dim):
        ent = local_entries(p, spec, dim)
        shape = list(p.shape)
        if dim >= 0:
            shape[dim] //= n_dp
        if opt._factored(tuple(shape), tcfg.optim.factored_min_dim):
            return {"vr": (lead, *ent[:-1]), "vc": (lead, *ent[:-2], *ent[-1:])}
        return {"v": (lead, *ent)}

    return {"f": tree_unflatten(treedef, [af(*r) for r in rows]), "count": ()}


def abstract_train_state(cfg: ArchConfig, tcfg: TrainConfig, mesh) -> tuple:
    """``(state, specs)``: the global train state as ``meta`` tensors,
    allocating nothing, and :func:`make_train_state_specs`."""
    specs = make_train_state_specs(cfg, tcfg, mesh)
    params = transformer.abstract_params(cfg)
    step = torch.empty((), dtype=torch.int32, device="meta")
    if tcfg.partition == "fsdp":
        n_dp = _sizes(mesh, dp_axes_of(mesh))
        local = fsdp_local_shapes(params, plan_fsdp_tree(cfg, tcfg, mesh), n_dp)
        ostruct = tree_map(lambda t: t if t.ndim == 0 else torch.empty(
            (n_dp, *t.shape), dtype=t.dtype, device="meta"), opt.init(tcfg.optim, local))
    else:
        ostruct = _zero1_state_layout(cfg, tcfg, mesh)[0]
    return {"params": params, "opt": ostruct, "step": step}, specs


class SyncGroups(NamedTuple):
    """What a step of a config syncs over on a mesh (:func:`sync_group`)."""

    group: object  # the gradient-sync process group
    axes: tuple  # the mesh axes it spans
    model: tp.ModelGroup | None  # the 'model' group where it carries TP, else None


def sync_group(mesh, tcfg: TrainConfig) -> SyncGroups:
    """The groups a step of ``tcfg`` runs over on ``mesh``: the flattened
    :func:`train_axes_of` (ZeRO-1) or :func:`dp_axes_of` (FSDP), its ranks
    in the reference's pod-major DP order (at model > 1 the group of this
    rank's model index: each model rank syncs its own buckets over (pod,
    data), as the reference's inner region does), and the 'model' group
    where that axis is above 1 and carries tensor parallelism (ZeRO-1 and
    FSDP without ``dp_only``; FSDP under ``dp_only`` keeps the leaves whole
    on every model rank)."""
    axes = dp_axes_of(mesh) if tcfg.partition == "fsdp" else train_axes_of(mesh, tcfg)
    mg = None if tcfg.dp_only else tp.model_group(mesh)
    return SyncGroups(mesh_lib.axis_group(mesh, axes), axes, mg)


def train_state_for(model: transformer.Transformer, tcfg: TrainConfig,
                    group=None, *, mesh=None) -> TrainState:
    """The train state of ``tcfg.partition`` around existing weights (this
    rank's ZeRO-1 shard state, or this rank's FSDP shards), syncing over
    ``group`` or over ``mesh``'s :func:`sync_group`."""
    if tcfg.partition not in ("zero1", "fsdp"):
        raise ValueError(f"unknown partition {tcfg.partition!r}")
    group, axes = (group, "data") if mesh is None else sync_group(mesh, tcfg)[:2]
    if tcfg.partition == "fsdp":
        return dataclasses.replace(fsdp_state_for(model, tcfg, group, mesh=mesh), group=group,
                                   axes=axes)
    n_dp = dist.get_world_size(group)
    meta = zero1_lib.plan_buckets(model.leaves(), n_dp,
                                  block=tcfg.policy.profile.block)
    ost = zero1_lib.zero1_init_local(tcfg.optim, meta, model.leaves(),
                                     dp_index=dist.get_rank(group))
    return TrainState(model=model, opt=ost, meta=meta, group=group, axes=axes)


def build_train_state(cfg: ArchConfig, tcfg: TrainConfig, *,
                      generator: torch.Generator, group=None, mesh=None,
                      device="cuda") -> TrainState:
    """Randomly initialised model + its ``tcfg.partition`` state on
    ``device``; at model > 1 this rank's blocks (``transformer.init(mesh=)``)."""
    mg = None
    if mesh is not None:  # a mesh the port cannot run raises before the draw
        mg = sync_group(mesh, tcfg).model
        if mg is not None:
            transformer.check_model_parallel(cfg, mg.size)
    model = transformer.init(cfg, generator=generator, device=device,
                             mesh=None if mg is None else mesh)
    return train_state_for(model, tcfg, group, mesh=mesh)


def zero1_plan(state: TrainState, tcfg: TrainConfig, group=None, *, cache=None):
    """The ``zero1`` plan of this train state's step signature (bucket
    layout, policy, the size of ``group`` or else the state's own group,
    the state's axes label, device): compiled on first sight, then a hit in
    ``cache`` (default: the process cache)."""
    return sched_compile.cached_zero1_plan(
        state.meta, policy=tcfg.policy, axis_name=state.axes,
        n_dev=dist.get_world_size(state.group if group is None else group),
        device=state.model.leaves()[0].device, cache=cache)


def train_step(state: TrainState, batch: dict, tcfg: TrainConfig, *,
               group=None, plan=None) -> dict:
    """One ZeRO-1 step over ``plan`` (default: :func:`zero1_plan`), syncing
    over ``group`` (default: the state's own); updates ``state`` in place
    unless the overflow guard fires.  ``batch`` holds this rank's rows.
    Returns ``{"loss" (mean over ranks), "gnorm": f32 tensors, "overflow":
    int}``.  With tensor parallelism the loss is the same on the ranks of
    a model group and averaged over ``group``; the gradient norm sums over
    the group, then over the model group (the reference's psum over (dp,
    model)).  The overflow flag is the max over ``group`` and over the
    model group, so no rank commits a step that another rank's wire lost
    (the reference keeps each device's own flag: ROADMAP Queue C)."""
    group = state.group if group is None else group
    if plan is None:
        plan = zero1_plan(state, tcfg, group)
    leaves = state.model.leaves()
    for p in leaves:
        p.grad = None
    loss = _microbatch_grads(lambda mb: loss_fn(state.model, mb, tcfg), batch,
                             tcfg.microbatches)
    grads = _grads_of(leaves)
    with torch.no_grad():
        mg = state.model.mg
        new_params, new_opt, flag, gnorm = zero1_lib.zero1_step(
            tcfg.optim, state.meta, leaves, grads, state.opt, group=group,
            policy=tcfg.policy, plan=plan, model_group=mg)
        # one verdict for the whole mesh: a reduce-scatter's flag is the
        # receiver's own, and a model rank's buckets are its own
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        flag = tp.all_max(flag, mg)
        dist.all_reduce(loss, group=group)
        loss = loss / dist.get_world_size(group)
        # the guard needs the flag on the host; a fake flag (the dry run's
        # rank, which holds no values) takes the committing branch
        overflow = 0 if kernels.is_fake(flag) else int(flag)
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

def plan_fsdp_tree(cfg: ArchConfig, tcfg: TrainConfig, mesh) -> dict:
    """The sharded dim of every parameter leaf (-1 = replicated), as a tree
    like the parameters': a leaf under ``fsdp_min_bytes`` or outside the
    codec stays replicated; else its last dim that divides the DP size and
    that the tensor-parallel layout leaves alone, going down, never dim 0
    (the blocks' stacked dim).  The DP size and the tensor-parallel dims
    (:func:`model_specs`) are ``mesh``'s, as the reference's; a caller that
    knows only its DP size passes ``AbstractMesh((n_dp, 1), ("data",
    "model"))``."""
    shapes = transformer.abstract_params(cfg)
    n_dp = mesh_lib.dp_size(mesh)
    taken = tree_map_up_to(lambda _, s: tuple(d for d, e in enumerate(s) if e is not None),
                           shapes, model_specs(cfg, mesh))

    def choose(leaf, taken):
        if leaf.numel() * leaf.element_size() < tcfg.fsdp_min_bytes:
            return -1
        if dtype_name(leaf.dtype) not in codec.LAYOUTS:
            return -1
        for d in range(leaf.ndim - 1, 0, -1):
            if d not in taken and leaf.shape[d] % n_dp == 0:
                return d
        return -1

    return tree_map_up_to(choose, shapes, taken)


def _dp_mesh(n_dp: int) -> mesh_lib.AbstractMesh:
    """The layout of ``n_dp`` data ranks at model = 1."""
    return mesh_lib.AbstractMesh((n_dp, 1), ("data", "model"))


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
                opt_state=None, step: int = 0, mg=None) -> TrainState:
    """The FSDP state of this rank's shards ``model_tree``; at a model group
    ``mg`` shards of its blocks, whose optimizer state decides Adafactor's
    factoring on the model-global shape."""
    model = transformer.Transformer(
        cfg, {p: t.contiguous() for p, t in transformer.tree_paths(model_tree)}, mg)
    if opt_state is None:
        shapes = None
        if model.mg is not None:
            md = model_dims(cfg, model.mg.size)
            shapes = [tuple(s * model.mg.size if i == md[path] else s
                            for i, s in enumerate(t.shape)) for path, t in model.params.items()]
        opt_state = opt.init(tcfg.optim, model.tree(), shapes=shapes)
    return TrainState(model=model, opt=opt_state, meta=None, step=step, fsdp_dims=dims)


def fsdp_state_for(model: transformer.Transformer, tcfg: TrainConfig,
                   group=None, *, mesh=None) -> TrainState:
    """FSDP train state around existing weights (this rank's blocks at
    model > 1): this rank's shards (``fsdp.shard_tree_by_plan``) and the
    optimizer state of the shards.  The plan is ``mesh``'s
    (:func:`plan_fsdp_tree`: the dims 'model' splits stay unsharded), or
    that of ``group``'s size at model = 1."""
    n_dp = dist.get_world_size(group)
    dims = plan_fsdp_tree(model.cfg, tcfg, _dp_mesh(n_dp) if mesh is None else mesh)
    local = fsdp_lib.shard_tree_by_plan(dims, model.tree(), dist.get_rank(group), n_dp)
    return _fsdp_state(local, model.cfg, tcfg, dims, mg=model.mg)


def load_reference_fsdp_state(tree: dict, cfg: ArchConfig, tcfg: TrainConfig, *,
                              n_dp: int = 1, dp_index: int = 0,
                              device="cuda", mesh=None) -> TrainState:
    """Rank ``dp_index``'s FSDP train state from the reference's:
    ``tree = jax.tree_util.tree_map(np.asarray, state)`` of its
    ``build_train_state`` at ``partition="fsdp"`` over ``n_dp`` data ranks.
    Its parameters are global (this rank's shards are cut here); its
    optimizer leaves carry a leading data-rank dim, which is indexed away
    as the reference's ``_opt_local`` does; ``count`` and ``step`` are
    scalars.  ``mesh``: the plan's mesh (default ``n_dp`` data ranks at
    model = 1); at model > 1 this rank's blocks of the parameters and of
    the optimizer leaves (which are model-global in the reference's)."""
    dev = kernels.resolve_device(device)
    dims = plan_fsdp_tree(cfg, tcfg, _dp_mesh(n_dp) if mesh is None else mesh)
    mg = tp.model_group(mesh)
    kept = transformer.block_specs(cfg, mg.size) if mg else {}
    dts, arrays = transformer.leaf_dtypes(cfg), dict(transformer.tree_paths(tree["params"]))
    full = transformer._map_paths(tree["params"], lambda p: transformer._block(
        transformer.numpy_to_torch(np.asarray(arrays[p]), dts[p]), kept.get(p, ()), mg))
    local = tree_map(lambda t: t.contiguous().to(dev),
                     fsdp_lib.shard_tree_by_plan(dims, full, dp_index, n_dp))
    ost = tree_map(lambda a: torch.from_numpy(np.array(a if a.ndim == 0 else a[dp_index]))
                   .to(dev), tree["opt"])
    if mg is None:
        return _fsdp_state(local, cfg, tcfg, dims, ost, int(tree["step"]))
    state = _fsdp_state(local, cfg, tcfg, dims, step=int(tree["step"]), mg=mg)
    state.opt = state._opt_blocks(ost)  # the reference's leaves are model-global
    return state


def _gather_leaves(tree, dims, tcfg: TrainConfig, group, cache, axes="data"):
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
                                           axis_name=axes, cache=cache)
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
    group = state.group if group is None else group
    top_full = _gather_leaves(top, {k: dims[k] for k in top}, tcfg, group, cache, state.axes)
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
            return _gather_leaves(p, layer_dims[idx], tcfg, group, cache, state.axes)

    hidden = model(batch["tokens"], vision_embeds=batch.get("vision_embeds"),
                   frames=batch.get("frames"), top=top_full, remat=tcfg.remat,
                   block_param_fn=gather_layer)
    head = top_full["embed" if model.cfg.tie_embeddings else "lm_head"]
    return chunked_ce_loss(head, hidden, batch["labels"], tcfg.loss_chunk,
                           model.vocab_group(head))


def fsdp_train_step(state: TrainState, batch: dict, tcfg: TrainConfig, *, group=None,
                    cache=None) -> dict:
    """One FSDP step over ``group`` (default: the state's own); updates
    ``state`` in place.  The loss is scaled by
    1/n_dp (a gather's backward SUMS over ranks); the replicated leaves'
    gradients are summed with ``psum_safe``; the global norm adds the
    shards' squares over the group to the replicated leaves' own; the
    optimizer updates the local shards.  At model > 1 the forward is the
    tensor-parallel one on the gathered blocks, and the norm counts each
    leaf once, as the reference's GSPMD-global sum over 'model' does: a
    split leaf's squares summed over the model group, a leaf 'model'
    replicates counted as one rank holds it.  Returns ``{"loss" (mean over
    ranks), "gnorm", "overflow": 0}``: the reference's step reports no
    overflow."""
    group = state.group if group is None else group
    n_dp = dist.get_world_size(group)
    leaves = state.model.leaves()
    for p in leaves:
        p.grad = None
    loss = _microbatch_grads(
        lambda mb: fsdp_loss_fn(state, mb, tcfg, group=group, cache=cache) / n_dp,
        batch, tcfg.microbatches)
    dims = tree_leaves(state.fsdp_dims)
    mg = state.model.mg
    mdims = state._model_dims()
    with torch.no_grad():
        grads = [g if d >= 0 else psum_safe(g, group)
                 for g, d in zip(_grads_of(leaves), dims, strict=True)]
        sqs = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
        split = [] if mg is None else [i for i, dm in enumerate(mdims) if dm >= 0]
        if split:  # a split leaf's squares over every block of it
            summed = tp.all_sum(torch.stack([sqs[i] for i in split]), mg)
            for j, i in enumerate(split):
                sqs[i] = summed[j]
        sq_all = sq_shard = torch.zeros((), dtype=torch.float32, device=loss.device)
        for sq, d in zip(sqs, dims):
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
                                           state.opt, params, model_dims=mdims, mg=mg)
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
