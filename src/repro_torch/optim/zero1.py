"""ZeRO-1 distributed optimizer fused with the compressed two-shot wire
(torch port of ``repro.optim.zero1``).

ZeRO-1 is a two-shot all-reduce with the optimizer update spliced between
its phases, so the optimizer's own reduce-scatter and all-gather are the
compressed wire:

    grads --RS(compressed)--> grad shard --update--> param shard
          --AG(compressed)--> full params

Parameters are a list of tensors in the reference's ``tree_leaves`` order.
They are fused into one flat bucket per dtype, padded to ``n_dp * block``;
rank ``d`` owns shard ``d`` and its f32 optimizer state.  The wire schedule
is a compiled ``zero1`` plan (``sched/compile.compile_zero1_plan``: per
bucket, an RS phase at the gradient width and an AG phase at the weight
width, each compressed iff the policy is enabled and the GLOBAL bytes of
the phase reach ``min_bytes``), replayed through
``sched.Zero1Execution``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import kernels, sched
from repro_torch.core import codec
from repro_torch.core import compressed_collectives as cc
from repro_torch.core.policy import CompressionPolicy
from repro_torch.models import tp
from repro_torch.optim import optimizers as opt
from repro_torch.sched import compile as sched_compile
from repro_torch.tree_util import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class BucketMeta:
    """Static description of the flat buckets of one parameter list."""

    dtype_names: tuple  # bucket order
    members: tuple  # per bucket: ((leaf_index, shape, size), ...)
    lengths: tuple  # unpadded length per bucket
    padded: tuple  # padded length per bucket (multiple of n_dp * block)
    n_dp: int
    block: int

    @property
    def shard_lens(self) -> tuple:
        return tuple(p // self.n_dp for p in self.padded)


def _bucket_name(dtype) -> str:
    try:
        return codec.layout_of(dtype).name
    except ValueError:
        return "float32"  # reduce/update in f32; re-cast on unflatten


def plan_buckets(params, n_dp: int, block: int = 512) -> BucketMeta:
    groups: dict = {}
    for i, p in enumerate(params):
        groups.setdefault(_bucket_name(p.dtype), []).append(
            (i, tuple(p.shape), p.numel()))
    names = tuple(sorted(groups))
    members = tuple(tuple(groups[n]) for n in names)
    lengths = tuple(sum(m[2] for m in groups[n]) for n in names)
    mult = n_dp * block
    padded = tuple(-(-L // mult) * mult for L in lengths)
    return BucketMeta(names, members, lengths, padded, n_dp, block)


def flatten_buckets(meta: BucketMeta, tensors) -> list:
    out = []
    for name, mem, L, Lp in zip(meta.dtype_names, meta.members, meta.lengths,
                                meta.padded):
        dt = codec.LAYOUTS[name].dtype
        parts = [tensors[i].detach().to(dt).reshape(-1) for i, _, _ in mem]
        if Lp > L:
            parts.append(parts[0].new_zeros(Lp - L))
        out.append(torch.cat(parts) if len(parts) > 1 else parts[0])
    return out


def unflatten_buckets(meta: BucketMeta, buckets, like) -> list:
    leaves = list(like)
    for mem, bucket in zip(meta.members, buckets):
        off = 0
        for i, shape, size in mem:
            leaves[i] = bucket[off: off + size].reshape(shape).to(like[i].dtype)
            off += size
    return leaves


# ---------------------------------------------------------------------------
# ZeRO-1 state + step
# ---------------------------------------------------------------------------

def zero1_init_local(ocfg: opt.OptimConfig, meta: BucketMeta, params,
                     dp_index: int) -> dict:
    """This rank's ZeRO-1 shard state: f32 master copy + moments."""
    buckets = flatten_buckets(meta, params)
    dev = buckets[0].device
    state = {"count": torch.zeros((), dtype=torch.int32, device=dev),
             "buckets": []}
    for bucket, sl in zip(buckets, meta.shard_lens):
        shard = bucket[dp_index * sl: (dp_index + 1) * sl]
        b = {"master": shard.to(torch.float32)}
        if ocfg.name == "adamw":
            b["m"] = torch.zeros(sl, dtype=torch.float32, device=dev)
        b["v"] = torch.zeros(sl, dtype=torch.float32, device=dev)
        state["buckets"].append(b)
    state["buckets"] = tuple(state["buckets"])
    return state


def load_reference_zero1_state(tree, device="cuda") -> dict:
    """This rank's ZeRO-1 state from the reference's: ``tree =
    jax.tree_util.tree_map(np.asarray, zero1_init_local(...))`` (leaves
    ``(sl,)``, or ``(1, sl)`` in its global 2-D layout)."""
    dev = kernels.resolve_device(device)
    as_t = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
    return {"count": as_t(tree["count"]).to(torch.int32),
            "buckets": tuple({k: as_t(v).reshape(-1) for k, v in b.items()}
                             for b in tree["buckets"])}


def _raw_reduce_scatter(x: torch.Tensor, group, n_dp: int) -> torch.Tensor:
    """Uncompressed RS as all_to_all + rank-order f32 sum: the same
    accumulation order as the compressed path, so compressed-vs-raw
    training is bit-comparable."""
    return cc._seq_sum(cc.raw_all_to_all(x.reshape(n_dp, -1), group))


def _raw_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    return cc.raw_all_gather(x, group)


def zero1_step(ocfg: opt.OptimConfig, meta: BucketMeta, params, grads,
               state: dict, *, group=None, policy: CompressionPolicy,
               axis_name="data", plan=None, model_group=None):
    """One ZeRO-1 step.  ``grads`` are this rank's UNREDUCED gradients;
    reduction happens in the (compressed) reduce-scatter.  The wire runs
    ``plan``, a compiled ``zero1`` plan (the train step compiles one per
    step signature); with ``plan=None`` it is compiled from ``policy`` and
    the gate label ``axis_name`` on first sight and cached.
    ``model_group``: the 'model' group (``models/tp``) of a rank whose
    buckets hold its blocks of the parameters: the squared norm is summed
    over ``group``, then over it, as the reference's psum over (dp,
    model), which counts a leaf that 'model' replicates (the norms, the
    router, MLA's down-projections) once a model rank.  Returns
    (new_params list, new_state, overflow_flag int32, gnorm f32)."""
    n_dp = dist.get_world_size(group)
    gbuckets = flatten_buckets(meta, grads)
    dev = gbuckets[0].device
    if plan is None:
        plan = sched_compile.cached_zero1_plan(meta, policy=policy, axis_name=axis_name,
                                               n_dev=n_dp, device=dev)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    c = state["count"] + 1
    lr = opt.lr_at(ocfg, c)

    with sched.Zero1Execution(plan, group) as ex:
        # -- reduce-scatter: grad shards (mean over DP) ----------------------
        gshards = []
        norm_sq = torch.zeros((), dtype=torch.float32, device=dev)
        for i, gb in enumerate(gbuckets):
            gs, f = ex.reduce_scatter(i, gb)
            flag = torch.maximum(flag, f)
            gs = gs / n_dp
            gshards.append(gs)
            norm_sq = norm_sq + torch.sum(torch.square(gs))

        # global grad norm: the shards are disjoint over the group (and the
        # model group's blocks too, the replicated leaves counted once a rank)
        dist.all_reduce(norm_sq, group=group)
        gnorm = torch.sqrt(tp.all_sum(norm_sq, model_group))
        scale = torch.clamp(ocfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

        # -- local shard update, then all-gather of the new params -----------
        new_buckets, new_state_buckets = [], []
        b1, b2 = ocfg.b1, ocfg.b2
        cf = c.to(torch.float32)
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf
        beta_af = 1.0 - cf ** (-ocfg.decay_rate)
        for i, (name, gs, bst) in enumerate(zip(meta.dtype_names, gshards,
                                                state["buckets"])):
            g = gs * scale
            master = bst["master"]
            if ocfg.name == "adamw":
                m = b1 * bst["m"] + (1 - b1) * g
                v = b2 * bst["v"] + (1 - b2) * torch.square(g)
                upd = (m / bc1) / (torch.sqrt(v / bc2) + ocfg.eps)
                nb = {"m": m, "v": v}
            else:  # adafactor on a flat shard degenerates to unfactored
                v = beta_af * bst["v"] + (1 - beta_af) * (torch.square(g) + 1e-30)
                upd = g / (torch.sqrt(v) + 1e-12)
                rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
                upd = upd / torch.clamp(rms, min=1.0)
                nb = {"v": v}
            master = master - lr * (upd + ocfg.weight_decay * master)
            nb["master"] = master
            new_state_buckets.append(nb)
            gathered, f = ex.all_gather(i, master.to(codec.LAYOUTS[name].dtype))
            flag = torch.maximum(flag, f)
            new_buckets.append(gathered.reshape(-1))

    new_params = unflatten_buckets(meta, new_buckets, params)
    return new_params, {"count": c, "buckets": tuple(new_state_buckets)}, flag, gnorm


# ---------------------------------------------------------------------------
# the global layout of the state (checkpoints, layouts on a mesh)
# ---------------------------------------------------------------------------

def state_struct(ocfg: opt.OptimConfig, meta: BucketMeta, n_model: int) -> dict:
    """The global state as ``meta`` tensors: each bucket leaf ``(n_dp,
    n_model * shard_len)`` f32, laid out ``((pod, data), model)``: row ``d``
    is data rank ``d``'s shard."""
    def leaf(sl):
        return torch.empty((meta.n_dp, n_model * sl), dtype=torch.float32, device="meta")

    keys = ("master", "m", "v") if ocfg.name == "adamw" else ("master", "v")
    return {"count": torch.empty((), dtype=torch.int32, device="meta"),
            "buckets": tuple({k: leaf(sl) for k in keys} for sl in meta.shard_lens)}


def gather_rows(v: torch.Tensor, group=None) -> torch.Tensor | None:
    """The group's ranks' ``v`` stacked, row ``d`` rank ``d``'s (collective
    over ``group``), on the host of the group's rank 0; None on the other
    ranks.  Rank 0 receives one row at a time into a buffer of ``v``'s
    size, so its device never holds more than one row beyond its own.  At
    one rank (or outside a process group) ``v[None]``, where ``v`` is."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return v[None]
    g = dist.group.WORLD if group is None else group
    v = v.detach().contiguous()
    if dist.get_rank(g) != 0:
        dist.send(v, dst=dist.get_global_rank(g, 0), group=g)
        return None
    rows = torch.empty((dist.get_world_size(g), *v.shape), dtype=v.dtype)
    rows[0] = v.cpu()
    buf = torch.empty_like(v)
    for r in range(1, len(rows)):
        dist.recv(buf, src=dist.get_global_rank(g, r), group=g)
        rows[r] = buf.cpu()
    return rows


def local_to_global(state: dict, group=None) -> dict | None:
    """A rank's state in the global layout: each ``(sl,)`` leaf a row of
    ``(n_dp, sl)``, row ``d`` data rank ``d``'s, the scalar ``count`` as it
    is.  Over a ``group`` of n ranks the rows are gathered to its rank 0
    (:func:`gather_rows`), None on the others; at one rank each leaf is its
    ``(1, sl)`` block.  FSDP's optimizer state, one tree a rank, takes the
    same layout."""
    leaves, treedef = tree_flatten(state)
    rows = [v if v.ndim == 0 else gather_rows(v, group) for v in leaves]
    if any(r is None for r in rows):
        return None
    return tree_unflatten(treedef, rows)


def global_to_local(state: dict, index: int = 0) -> dict:
    """Row ``index`` of each global leaf: a ``(1, sl)`` block its row 0,
    the whole ``(n_dp, sl)`` data rank ``index``'s row, copied to storage of
    its own (a view would keep every rank's rows alive)."""
    return tree_map(lambda v: v if v.ndim == 0 else v[0] if len(v) == 1 else v[index].clone(),
                    state)
