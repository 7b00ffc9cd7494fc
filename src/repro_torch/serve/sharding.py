"""Layouts of the serving paths on a mesh (torch port of
``repro.serve.sharding``): specs (``launch/mesh``) for the parameters and
the KV cache, and their ``meta`` tensors.

Parameters carry the tensor-parallel specs over 'model' (``train.step.
model_specs``), and a leaf above ``shard_over_dp_bytes`` per model shard
also goes over the DP axes on a free dim, as no device holds deepseek-v3's
1.34 TB replicated over DP even at model = 16.  A KV cache puts its batch
dim over the DP axes and its ``max_len`` dim over 'model' (context-
parallel decode).  A rank serves on its blocks by these layouts:
``transformer.init(mesh=, param_specs=serve_param_specs(...))`` and
``transformer.init_cache(mesh=)``; the dry run reads them too.
"""
from __future__ import annotations

import numpy as np

from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig
from repro_torch.train.step import dp_axes_of, model_specs
from repro_torch.tree_util import tree_map, tree_map_up_to


def _dp(mesh) -> tuple:
    """(DP spec entry, DP size) of a mesh."""
    dp = dp_axes_of(mesh)
    sizes = mesh_lib.axis_sizes(mesh)
    return (dp if len(dp) > 1 else dp[0]), int(np.prod([sizes[a] for a in dp]))


def serve_param_specs(cfg: ArchConfig, mesh, *, shard_over_dp_bytes: int = 1 << 32):
    """The parameters' specs for serving: :func:`~repro_torch.train.step.
    model_specs`, and a leaf whose bytes per model shard reach
    ``shard_over_dp_bytes`` also split over the DP axes on its last free
    dim (not dim 0) that the DP size divides."""
    dpax, n_dp = _dp(mesh)

    def f(p, spec):
        entries = mesh_lib.padded(spec, p.ndim)
        split = int(np.prod([mesh_lib.entry_size(e, mesh) for e in entries]))
        if p.numel() * p.element_size() / split < shard_over_dp_bytes:
            return tuple(entries)
        for d in range(p.ndim - 1, 0, -1):
            if entries[d] is None and p.shape[d] % n_dp == 0:
                entries[d] = dpax
                break
        return tuple(entries)

    return tree_map_up_to(f, transformer.abstract_params(cfg), model_specs(cfg, mesh))


def cache_specs(cfg: ArchConfig, mesh, batch: int, max_len: int) -> tuple:
    """``(specs, struct)`` of ``transformer.init_cache(cfg, batch,
    max_len)``: per leaf, the batch dim (past a stacked layer's leading
    repeats) over the DP axes when they divide it, and the first later dim
    of ``max_len`` over 'model' when it divides it; ``struct`` the cache as
    ``meta`` tensors."""
    dpax, n_dp = _dp(mesh)
    n_model = mesh_lib.axis_sizes(mesh)["model"]
    struct = transformer.cache_struct(cfg, batch, max_len)

    def f(p):
        if p.ndim == 0:
            return ()
        entries = [None] * p.ndim
        start = 1 if p.shape[0] == cfg.repeats and p.ndim > 1 and p.shape[1] == batch else 0
        if p.shape[start] == batch and batch % n_dp == 0:
            entries[start] = dpax
        for d in range(start + 1, p.ndim):
            if p.shape[d] == max_len and max_len % n_model == 0:
                entries[d] = "model"
                break
        return tuple(entries)

    return tree_map(f, struct), struct


def abstract_cache(cfg: ArchConfig, mesh, batch: int, max_len: int) -> tuple:
    """``(struct, specs)``: the KV cache as ``meta`` tensors and its specs."""
    specs, struct = cache_specs(cfg, mesh, batch, max_len)
    return struct, specs


def abstract_params_sharded(cfg: ArchConfig, mesh, specs) -> tuple:
    """``(struct, specs)``: the parameters as ``meta`` tensors, paired with
    ``specs`` (e.g. :func:`serve_param_specs`)."""
    return transformer.abstract_params(cfg), specs
