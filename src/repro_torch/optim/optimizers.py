"""Optimizers: AdamW and Adafactor as plain functions over trees of tensors
(torch port of ``repro.optim.optimizers``).

``init``/``update`` take any tree of the port's ``tree_util`` (nested dicts,
tuples, lists): the FSDP step updates its local shards with them.  The
math runs in f32, moments and factors are f32, and each new parameter is
cast back to its dtype, as in the reference.  ZeRO-1 updates its flat
shards in ``zero1.py``.

On blocks of a 'model' axis (FSDP at model > 1) AdamW is elementwise and
needs nothing; Adafactor's means over a dim that 'model' splits, and its
RMS clip over a split leaf, are taken over the whole leaf as the
reference's GSPMD takes them: this rank's sum, summed over the model group
(``models/tp.all_sum``), over the global count; and its factoring is
decided on the model-global shape.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import tp
from repro_torch.tree_util import (tree_flatten, tree_flatten_up_to, tree_leaves, tree_map,
                                   tree_unflatten)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    factored_min_dim: int = 128


def lr_at(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac * lr`` (f32, on the
    step's device: no host sync)."""
    step = step.to(torch.float32)
    warm = (step / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.decay_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaves in tree
    order."""
    sq = [torch.sum(torch.square(t.to(torch.float32))) for t in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree, max_norm: float, *, pre_norm=None):
    """``tree`` scaled by ``min(1, max_norm / norm)`` in f32, each leaf cast
    back to its dtype; returns (clipped tree, norm)."""
    g = pre_norm if pre_norm is not None else global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda t: (t.to(torch.float32) * scale).to(t.dtype), tree), g


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _zeros_f32(t: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(t.shape if shape is None else shape, dtype=torch.float32,
                       device=t.device)


def adamw_init(params) -> dict:
    """f32 first and second moments shaped like ``params``, and the step
    count (int32)."""
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(_zeros_f32, params), "v": tree_map(_zeros_f32, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(cfg: OptimConfig, grads, state: dict, params) -> tuple:
    """One AdamW step over matching trees, in f32, each new parameter cast
    back to its dtype.  Returns (new_params, new_state)."""
    c = state["count"] + 1
    lr = lr_at(cfg, c)
    b1, b2 = cfg.b1, cfg.b2
    cf = c.to(torch.float32)
    bc1, bc2 = 1 - b1 ** cf, 1 - b2 ** cf

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), m, v

    flat_g, tdef = tree_flatten(grads)
    out = [upd(g, m, v, p) for g, m, v, p in zip(
        flat_g, tree_flatten_up_to(tdef, state["m"]), tree_flatten_up_to(tdef, state["v"]),
        tree_flatten_up_to(tdef, params), strict=True)]
    return (tree_unflatten(tdef, [o[0] for o in out]),
            {"m": tree_unflatten(tdef, [o[1] for o in out]),
             "v": tree_unflatten(tdef, [o[2] for o in out]), "count": c})


# ---------------------------------------------------------------------------
# Adafactor (factored second moments: O(n + m) instead of O(nm))
# ---------------------------------------------------------------------------

def _factored(shape, min_dim: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def adafactor_init(params, *, min_dim: int = 128, shapes=None) -> dict:
    """Per leaf f32 row and column factors ``{"vr", "vc"}`` when its last two
    dims reach ``min_dim``, else a full ``{"v"}``; and the step count.
    ``shapes``: per leaf (tree order) the shape that decides the factoring,
    where a leaf is a block of a larger one (its model-global shape);
    default the leaves' own."""
    leaves, tdef = tree_flatten(params)
    shapes = [tuple(p.shape) for p in leaves] if shapes is None else shapes

    def one(p, decide):
        s = tuple(p.shape)
        if _factored(tuple(decide), min_dim):
            return {"vr": _zeros_f32(p, s[:-1]), "vc": _zeros_f32(p, s[:-2] + s[-1:])}
        return {"v": _zeros_f32(p)}

    return {"f": tree_unflatten(tdef, [one(p, d) for p, d in zip(leaves, shapes, strict=True)]),
            "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}


def adafactor_update(cfg: OptimConfig, grads, state: dict, params, *, model_dims=None,
                     mg=None) -> tuple:
    """One Adafactor step (decay ``1 - c**-decay_rate``, the RMS-1 update
    clip, decoupled weight decay) in f32.  ``model_dims``: per leaf (tree
    order) its dim that the model group ``mg`` splits, -1 where it is
    whole.  Returns (new_params, new_state)."""
    c = state["count"] + 1
    lr = lr_at(cfg, c)
    beta = 1.0 - c.to(torch.float32) ** (-cfg.decay_rate)
    eps = 1e-30

    def upd(g, f, p, dm):
        g = g.to(torch.float32)
        split = dm >= 0 and tp.active(mg)

        def mean(t, dim, leaf_dim, keepdim=False):  # over the whole leaf's dim
            if split and leaf_dim == dm:
                return tp.all_sum(t.sum(dim, keepdim=keepdim), mg) / (t.shape[dim] * mg.size)
            return torch.mean(t, dim=dim, keepdim=keepdim)

        nd = g.ndim
        g2 = torch.square(g) + eps
        if "vr" in f:
            vr = beta * f["vr"] + (1 - beta) * mean(g2, -1, nd - 1)
            vc = beta * f["vc"] + (1 - beta) * mean(g2, -2, nd - 2)
            r = vr / torch.clamp(mean(vr, -1, nd - 2, keepdim=True), min=eps)
            u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :] + 1e-12)
            nf = {"vr": vr, "vc": vc}
        else:
            v = beta * f["v"] + (1 - beta) * g2
            u = g / (torch.sqrt(v) + 1e-12)
            nf = {"v": v}
        if split:
            ms = tp.all_sum(torch.sum(torch.square(u)), mg) / (u.numel() * mg.size)
        else:
            ms = torch.mean(torch.square(u))
        rms = torch.sqrt(ms + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        step = u + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), nf

    flat_g, tdef = tree_flatten(grads)
    dims = [-1] * len(flat_g) if model_dims is None else model_dims
    out = [upd(g, f, p, dm) for g, f, p, dm in zip(
        flat_g, tree_flatten_up_to(tdef, state["f"]), tree_flatten_up_to(tdef, params), dims,
        strict=True)]
    return (tree_unflatten(tdef, [o[0] for o in out]),
            {"f": tree_unflatten(tdef, [o[1] for o in out]), "count": c})


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def init(cfg: OptimConfig, params, *, shapes=None) -> dict:
    """The optimizer state of ``params``; ``shapes`` as
    :func:`adafactor_init` takes them (blocks of larger leaves)."""
    if cfg.name == "adamw":
        return adamw_init(params)
    if cfg.name == "adafactor":
        return adafactor_init(params, min_dim=cfg.factored_min_dim, shapes=shapes)
    raise ValueError(cfg.name)


def update(cfg: OptimConfig, grads, state: dict, params, *, model_dims=None,
           mg=None) -> tuple:
    """One step; ``model_dims``/``mg`` as :func:`adafactor_update` takes
    them (AdamW is elementwise: blocks need nothing)."""
    if cfg.name == "adamw":
        return adamw_update(cfg, grads, state, params)
    if cfg.name == "adafactor":
        return adafactor_update(cfg, grads, state, params, model_dims=model_dims, mg=mg)
    raise ValueError(cfg.name)
