"""CommPlan compiler (torch port of ``repro.sched.compile``; the kinds of
:data:`PLAN_KINDS`).

What the collectives, ZeRO-1, ``serve/kv_transfer`` and the weight-sync
engine would decide per call (leaf buckets, the compress gate, the codec
widths, chunk grids, the fused knobs, the expected wire bytes) is decided
here, once, from shapes and dtypes; ``sched/executor.py`` replays the
collective kinds through the same primitives.  The expected bytes are the
wire formats' closed-form sizes (:func:`encoded_wire_bytes`,
:func:`p2p_wire_bytes`, :func:`delta_wire_bytes`), where the reference
traces its encoders with ``jax.eval_shape``; the tests hold the two equal,
and hold :func:`encoded_wire_bytes` to a real encode's ``wire_nbytes``.

Widths come from the policy's profile unless live data is given
(``compile_psum_plan(sample=...)``): then ``calibrate.choose_width`` picks
each bucket's width and the probe's estimates are recorded.

The P2P kinds (``p2p``, ``kv``, ``wsync``) record their strategy
(:data:`P2P_STRATEGIES`, default ``split_send``) in the plan and its key;
``sched/executor.py`` replays them through ``core/split_send``.  A wsync
plan may also carry a fan-out topology for a fleet size
(:func:`compile_broadcast_schedule`, the ``broadcast=`` arguments).  The
``fsdp_gather`` kind schedules one FSDP leaf's gather (its forward
all-gather and backward reduce-scatter); ``sched/executor.gather_from_plan``
replays it through ``optim/fsdp``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import kernels
from repro_torch.core import calibrate, codec, packing
from repro_torch.core.split_send import STRATEGIES as P2P_STRATEGIES
from repro_torch.core.split_send import chunk_grid
from repro_torch.sched.plan import (BROADCAST_KINDS, BROADCAST_PIPELINE,
                                    BROADCAST_STAR, BROADCAST_TREE, PATH_COMPRESSED,
                                    PATH_RAW, PATH_RAW_PSUM, PATH_RAW_TWOSHOT, PATH_RING,
                                    PATH_TWO_SHOT, BroadcastSchedule, BucketPlan,
                                    CommPlan, PhasePair, dtype_name, policy_fingerprint,
                                    tree_signature)
from repro_torch.tree_util import tree_flatten, tree_leaves


def axis_tuple(axis_name) -> tuple:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)


def probe_backend(device="cuda") -> tuple:
    """(device type, whether its wires run the CUDA kernels): a CUDA device
    runs them, the CPU their plain versions."""
    dev = kernels.resolve_device(device)
    return dev.type, dev.type == "cuda"


def _pad_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def p2p_wire_bytes(n_padded: int, dtype, *, width: int, block: int,
                   exc_frac: float) -> int:
    """Wire size of ONE P2P message of ``n_padded`` (block-padded) elements:
    the packed lo plane, then the exponent wire of ``pack_exponents``
    (payload, bases, exception indices and raw blocks, the overflow
    scalar), in the reference's dtypes (uint32 words, uint8 bases and raw
    exponents, int32 indices and flag)."""
    lay = codec.layout_of(dtype)
    n_blocks = -(-n_padded // block)
    n_groups = n_blocks * block // packing.GROUP
    cap = packing.exception_capacity(n_blocks, exc_frac)
    lo = -(-n_padded // packing.GROUP) * lay.lo_bits * 4
    exp = n_groups * width * 4 + n_blocks + cap * 4 + cap * block + 4
    return lo + exp


def encoded_wire_bytes(n_chunks: int, chunk: int, dtype, *, width: int,
                       block: int, exc_frac: float) -> int:
    """Wire size of encoding ``(n_chunks, chunk)`` rows at ``width``
    (``compressed_collectives._encode_chunks``): each row is one message of
    :func:`p2p_wire_bytes`, its lo plane over the row padded to whole
    groups, its exponent wire over the row padded to whole blocks."""
    return n_chunks * p2p_wire_bytes(chunk, dtype, width=width, block=block,
                                     exc_frac=exc_frac)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


_P2P_PIPELINE_CHUNKS = 4  # chunked_pipeline_send's default chunk count


def _check_strategy(strategy: str) -> None:
    if strategy not in P2P_STRATEGIES:
        raise ValueError(f"unknown P2P strategy {strategy!r}")


def _p2p_bucket(length: int, dtype, axis_name, *, policy, n_dev: int,
                tensor_class: str, strategy: str = "split_send") -> BucketPlan:
    """One flat P2P message's schedule under ``strategy``: the policy gate,
    the width and the fused knobs, as a BucketPlan.  ``chunk`` is the
    block-padded length of one send ("chunked": of one pipeline chunk, on
    ``split_send.chunk_grid``'s grid)."""
    itemsize = _itemsize(dtype)
    base = dict(dtype_name=dtype_name(dtype), members=((0, (length,), length),),
                length=length, n_dev=n_dev)
    struct = torch.empty((length,), dtype=dtype, device="meta")
    if not policy.should_compress(struct, axis_name, tensor_class=tensor_class):
        return BucketPlan(path=PATH_RAW, raw_bytes=length * itemsize, **base)
    width = policy.width_for(tensor_class)
    block, exc = policy.profile.block, policy.profile.exc_frac
    if strategy == "chunked":
        per, n_chunks = chunk_grid(length, _P2P_PIPELINE_CHUNKS, block)
    else:
        per, n_chunks = _pad_up(length, block), 1
    # split_send materialises the split (its early lo-plane send needs it),
    # so its encode is never the fused one-pass kernel
    return BucketPlan(path=PATH_COMPRESSED, width=width, block=block, exc_frac=exc,
                      fused=policy.fused_decode_reduce,
                      encode_fused=policy.fused_encode and strategy != "split_send",
                      chunk=per,
                      wire_bytes=n_chunks * p2p_wire_bytes(per, dtype, width=width,
                                                           block=block, exc_frac=exc),
                      raw_bytes=n_chunks * per * itemsize, **base)


def _with_members(bucket: BucketPlan, members) -> BucketPlan:
    return dataclasses.replace(bucket, members=tuple(members))


# ---------------------------------------------------------------------------
# collectives: the pytree all-reduce, the flat two-shot phases, ZeRO-1
# ---------------------------------------------------------------------------

def _group_leaves(leaves) -> tuple:
    """The psum bucketing (``tree_psum_compressed``, the psum and wsync
    kinds): codec-float leaves group per dtype name (in leaf order), every
    other leaf is raw.  Returns ``({name: [(i, shape, size), ...]}, raw leaf
    indices)``."""
    groups: dict = {}
    raw_ix = []
    for i, leaf in enumerate(leaves):
        lay = codec.LAYOUTS.get(dtype_name(leaf.dtype)) if isinstance(
            leaf, torch.Tensor) else None
        if lay is None:
            raw_ix.append(i)
        else:
            groups.setdefault(lay.name, []).append(
                (i, tuple(leaf.shape), math.prod(leaf.shape)))
    return groups, tuple(raw_ix)


def _probe_bucket(parts, block: int):
    """Compressibility probe on live bucket data: a ``WidthChoice``."""
    flat = torch.cat(parts) if len(parts) > 1 else parts[0]
    return calibrate.choose_width(flat, block=block)


def compile_psum_plan(tree, axis_name, *, policy, tensor_class: str = "gradient",
                      n_dev: int, sample=None, key: tuple = None,
                      device=None) -> CommPlan:
    """Compile the pytree all-reduce schedule (kind "psum"): the buckets of
    ``tree_psum_compressed`` and the dispatch of ``psum_compressed`` for
    each (two-shot or ring when compressed; the raw two-shot when gated off
    at ``min_bytes`` or more, else ``psum_safe``).  Only the shapes and
    dtypes of ``tree`` are read.  ``sample`` (a tree of live tensors of the
    same structure) switches the width to the calibrate probe.  ``device``
    (default: the tree's; needed for "meta" tensors) picks the recorded
    kernel routing."""
    leaves, _ = tree_flatten(tree)
    device = _device_of(leaves) if device is None else device
    backend, use_kernels = probe_backend(device)
    sample_leaves = tree_leaves(sample) if sample is not None else None
    groups, raw_ix = _group_leaves(leaves)
    buckets = []
    for name in sorted(groups):
        members = tuple(groups[name])
        length = sum(m[2] for m in members)
        dt = codec.LAYOUTS[name].dtype
        itemsize = _itemsize(dt)
        base = dict(dtype_name=name, members=members, length=length, n_dev=n_dev)
        struct = torch.empty((length,), dtype=dt, device="meta")
        if not policy.should_compress(struct, axis_name, tensor_class=tensor_class):
            path = (PATH_RAW_TWOSHOT if length * itemsize >= policy.min_bytes
                    else PATH_RAW_PSUM)
            buckets.append(BucketPlan(path=path, raw_bytes=length * itemsize, **base))
            continue
        width = policy.width_for(tensor_class)
        block, exc = policy.profile.block, policy.profile.exc_frac
        probe = None
        if sample_leaves is not None:
            choice = _probe_bucket([sample_leaves[i].reshape(-1) for i, _, _ in members],
                                   block)
            width = choice.width
            probe = (choice.est_exc_rate, choice.est_ratio, choice.entropy_bits)
        padded = _pad_up(length, n_dev * block)
        chunk = padded // n_dev
        common = dict(width=width, block=block, exc_frac=exc,
                      fused=policy.fused_decode_reduce,
                      encode_fused=policy.fused_encode, chunk=chunk, probe=probe, **base)
        if policy.allreduce_algorithm == "ring":
            hop = encoded_wire_bytes(1, chunk, dt, width=width, block=block, exc_frac=exc)
            buckets.append(BucketPlan(
                path=PATH_RING, wire_bytes=2 * (n_dev - 1) * hop,
                raw_bytes=2 * (n_dev - 1) * chunk * itemsize, **common))
            continue
        ag_width = min(width + policy.profile.ag_extra_bits, 8)
        rs_wire = encoded_wire_bytes(n_dev, chunk, dt, width=width, block=block,
                                     exc_frac=exc)
        ag_wire = n_dev * encoded_wire_bytes(1, chunk, dt, width=ag_width, block=block,
                                             exc_frac=exc)
        buckets.append(BucketPlan(
            path=PATH_TWO_SHOT, ag_width=ag_width, wire_bytes=rs_wire + ag_wire,
            raw_bytes=(padded + n_dev * chunk) * itemsize, **common))
    if key is None:
        key = psum_plan_key(tree, axis_name, policy, tensor_class, n_dev, device)
    return CommPlan(key=key, kind="psum", axis=axis_tuple(axis_name), n_dev=n_dev,
                    backend=backend, use_kernels=use_kernels, buckets=tuple(buckets),
                    raw_leaf_ix=raw_ix, n_leaves=len(leaves))


def psum_plan_key(tree, axis_name, policy, tensor_class: str, n_dev: int,
                  device=None) -> tuple:
    # probe_backend is part of every key, so a CPU plan is never replayed on
    # the card (nor the other way round)
    if device is None:
        device = _device_of(tree_leaves(tree))
    return ("psum", tree_signature(tree), axis_tuple(axis_name), int(n_dev),
            policy_fingerprint(policy, tensor_class), probe_backend(device))


def reduce_scatter_plan_key(length: int, dtype_name: str, axis_name, policy,
                            tensor_class: str, n_dev: int, device="cuda") -> tuple:
    return ("reduce_scatter", (int(length), str(dtype_name)), axis_tuple(axis_name),
            int(n_dev), policy_fingerprint(policy, tensor_class), probe_backend(device))


def all_gather_plan_key(length: int, dtype_name: str, axis_name, policy,
                        tensor_class: str, n_dev: int, device="cuda") -> tuple:
    return ("all_gather", (int(length), str(dtype_name)), axis_tuple(axis_name),
            int(n_dev), policy_fingerprint(policy, tensor_class), probe_backend(device))


def _gated_on(policy, length: int, itemsize: int, n_dev: int) -> bool:
    """ZeRO-1's gate of a flat phase: the policy is enabled and the GLOBAL
    bytes (the local bucket times ``n_dev``) reach ``min_bytes``."""
    return policy.enabled and length * itemsize * n_dev >= policy.min_bytes


def compile_reduce_scatter_plan(length: int, dtype_name: str, axis_name, *, policy,
                                n_dev: int, tensor_class: str = "gradient",
                                key: tuple = None, device="cuda") -> CommPlan:
    """Flat reduce-scatter schedule (kind "reduce_scatter") of a local
    bucket of ``length`` elements, gated on the global bucket bytes."""
    backend, use_kernels = probe_backend(device)
    itemsize = _itemsize(codec.LAYOUTS[dtype_name].dtype)
    base = dict(dtype_name=dtype_name, members=((0, (length,), length),),
                length=length, n_dev=n_dev)
    if key is None:
        key = reduce_scatter_plan_key(length, dtype_name, axis_name, policy,
                                      tensor_class, n_dev, device)
    if not _gated_on(policy, length, itemsize, n_dev):
        bucket = BucketPlan(path=PATH_RAW, raw_bytes=length * itemsize, **base)
    else:
        width, block = policy.width_for(tensor_class), policy.profile.block
        exc = policy.profile.exc_frac
        padded = _pad_up(length, n_dev * block)
        chunk = padded // n_dev
        bucket = BucketPlan(
            path=PATH_COMPRESSED, width=width, block=block, exc_frac=exc,
            fused=policy.fused_decode_reduce, encode_fused=policy.fused_encode,
            chunk=chunk, raw_bytes=padded * itemsize,
            wire_bytes=encoded_wire_bytes(n_dev, chunk, codec.LAYOUTS[dtype_name].dtype,
                                          width=width, block=block, exc_frac=exc),
            **base)
    return CommPlan(key=key, kind="reduce_scatter", axis=axis_tuple(axis_name),
                    n_dev=n_dev, backend=backend, use_kernels=use_kernels,
                    buckets=(bucket,), n_leaves=1)


def compile_all_gather_plan(length: int, dtype_name: str, axis_name, *, policy,
                            n_dev: int, tensor_class: str = "weight",
                            key: tuple = None, device="cuda") -> CommPlan:
    """Flat all-gather schedule (kind "all_gather") of a local shard of
    ``length`` elements: the tensor class's width plus ``ag_extra_bits``."""
    backend, use_kernels = probe_backend(device)
    dt = codec.LAYOUTS[dtype_name].dtype
    itemsize = _itemsize(dt)
    base = dict(dtype_name=dtype_name, members=((0, (length,), length),),
                length=length, n_dev=n_dev, fused=False)
    if key is None:
        key = all_gather_plan_key(length, dtype_name, axis_name, policy,
                                  tensor_class, n_dev, device)
    if not _gated_on(policy, length, itemsize, n_dev):
        bucket = BucketPlan(path=PATH_RAW, raw_bytes=n_dev * length * itemsize, **base)
    else:
        width = min(policy.width_for(tensor_class) + policy.profile.ag_extra_bits, 8)
        block, exc = policy.profile.block, policy.profile.exc_frac
        padded = _pad_up(length, block)
        bucket = BucketPlan(
            path=PATH_COMPRESSED, width=width, block=block, exc_frac=exc,
            encode_fused=policy.fused_encode, chunk=padded,
            wire_bytes=n_dev * encoded_wire_bytes(1, padded, dt, width=width,
                                                  block=block, exc_frac=exc),
            raw_bytes=n_dev * padded * itemsize, **base)
    return CommPlan(key=key, kind="all_gather", axis=axis_tuple(axis_name),
                    n_dev=n_dev, backend=backend, use_kernels=use_kernels,
                    buckets=(bucket,), n_leaves=1)


def compile_zero1_plan(meta, *, policy, axis_name, n_dev: int, key: tuple = None,
                       device="cuda") -> CommPlan:
    """Compile the ZeRO-1 sync schedule (kind "zero1") of a ``BucketMeta``:
    one ``PhasePair`` per dtype bucket, the RS phase at the gradient width,
    the AG phase at the weight width, each gated as its flat kind."""
    backend, use_kernels = probe_backend(device)
    if key is None:
        key = zero1_plan_key(meta, axis_name, policy, n_dev, device)
    pairs = []
    for name, members, padded, shard in zip(meta.dtype_names, meta.members,
                                            meta.padded, meta.shard_lens):
        rs = compile_reduce_scatter_plan(
            padded, name, axis_name, policy=policy, n_dev=n_dev,
            tensor_class="gradient", key=key + ("rs", name), device=device).buckets[0]
        ag = compile_all_gather_plan(
            shard, name, axis_name, policy=policy, n_dev=n_dev, tensor_class="weight",
            key=key + ("ag", name), device=device).buckets[0]
        pairs.append(PhasePair(rs=_with_members(rs, members), ag=ag))
    return CommPlan(key=key, kind="zero1", axis=axis_tuple(axis_name), n_dev=n_dev,
                    backend=backend, use_kernels=use_kernels, buckets=tuple(pairs),
                    n_leaves=sum(len(m) for m in meta.members))


def zero1_plan_key(meta, axis_name, policy, n_dev: int, device="cuda") -> tuple:
    return ("zero1", meta.dtype_names, meta.padded, meta.shard_lens, meta.block,
            axis_tuple(axis_name), int(n_dev), policy_fingerprint(policy),
            probe_backend(device))


def cached_zero1_plan(meta, *, policy, axis_name, n_dev: int, device="cuda",
                      cache=None) -> CommPlan:
    """Keyed-cache wrapper of :func:`compile_zero1_plan`, the train step's
    entry point: one compile per step signature and policy, then hits."""
    from repro_torch.sched.cache import default_cache

    cache = default_cache() if cache is None else cache
    key = zero1_plan_key(meta, axis_name, policy, n_dev, device)
    return cache.get_or_compile(
        key, lambda: compile_zero1_plan(meta, policy=policy, axis_name=axis_name,
                                        n_dev=n_dev, key=key, device=device))


# ---------------------------------------------------------------------------
# FSDP gather: the weight AG forward and the gradient RS backward
# ---------------------------------------------------------------------------

def compile_fsdp_gather_plan(local_shape: tuple, dtype_name: str, axis_name, *, policy,
                             n_dev: int, key: tuple = None, device="cuda") -> CommPlan:
    """Schedule of one FSDP leaf's gather (kind "fsdp_gather"): ``ag_width``
    is the forward (weight-class all-gather) width, ``width`` the backward
    (gradient-class reduce-scatter) width, ``chunk`` the block-padded row a
    destination gets.  Whether a leaf is sharded is the train step's plan
    (``train/step.plan_fsdp_tree``); this plan only schedules the wire, so
    only ``policy.enabled`` gates it."""
    backend, use_kernels = probe_backend(device)
    length = math.prod(local_shape)
    dt = codec.LAYOUTS[dtype_name].dtype
    itemsize = _itemsize(dt)
    block = policy.profile.block
    if key is None:
        key = fsdp_gather_plan_key(local_shape, dtype_name, axis_name, policy, n_dev,
                                   device)
    base = dict(dtype_name=dtype_name, members=((0, tuple(local_shape), length),),
                length=length, n_dev=n_dev)
    if not policy.enabled:
        bucket = BucketPlan(path=PATH_RAW, width=8, ag_width=8, fused=False,
                            raw_bytes=(n_dev + 1) * length * itemsize, **base)
    else:
        w_bwd, w_fwd = policy.width_for("gradient"), policy.width_for("weight")
        exc = policy.profile.exc_frac
        padded = _pad_up(length, block)  # the AG shard and each RS row
        bucket = BucketPlan(
            path=PATH_COMPRESSED, width=w_bwd, ag_width=w_fwd, block=block, exc_frac=exc,
            fused=policy.fused_decode_reduce, encode_fused=policy.fused_encode,
            chunk=padded,
            wire_bytes=(n_dev * encoded_wire_bytes(1, padded, dt, width=w_fwd, block=block,
                                                   exc_frac=exc)
                        + encoded_wire_bytes(n_dev, padded, dt, width=w_bwd, block=block,
                                             exc_frac=exc)),
            raw_bytes=2 * n_dev * padded * itemsize, **base)
    return CommPlan(key=key, kind="fsdp_gather", axis=axis_tuple(axis_name), n_dev=n_dev,
                    backend=backend, use_kernels=use_kernels, buckets=(bucket,),
                    n_leaves=1)


def fsdp_gather_plan_key(local_shape, dtype_name: str, axis_name, policy, n_dev: int,
                         device="cuda") -> tuple:
    return ("fsdp_gather", tuple(local_shape), str(dtype_name), axis_tuple(axis_name),
            int(n_dev), policy_fingerprint(policy), probe_backend(device))


def cached_fsdp_gather_plan(local_shape, dtype_name: str, axis_name, *, policy,
                            n_dev: int, device="cuda", cache=None) -> CommPlan:
    """Keyed-cache wrapper of :func:`compile_fsdp_gather_plan`, the FSDP
    step's entry point: every layer's leaf of one signature replays one
    plan."""
    from repro_torch.sched.cache import default_cache

    cache = default_cache() if cache is None else cache
    key = fsdp_gather_plan_key(local_shape, dtype_name, axis_name, policy, n_dev, device)
    return cache.get_or_compile(
        key, lambda: compile_fsdp_gather_plan(tuple(local_shape), dtype_name, axis_name,
                                              policy=policy, n_dev=n_dev, key=key,
                                              device=device))


# ---------------------------------------------------------------------------
# P2P: one tensor over the split-send pipeline or a baseline (paper §3.2)
# ---------------------------------------------------------------------------

def compile_p2p_plan(x, axis_name, *, policy, n_dev: int, tensor_class: str = "weight",
                     strategy: str = "split_send", key: tuple = None,
                     device=None) -> CommPlan:
    """Compile the schedule of one P2P send (kind "p2p"): the gate, width
    and fused knobs ``core/split_send.p2p_send`` derives at every call, and
    the strategy's chunk grid, decided once from ``x``'s shape and dtype.
    ``device`` (default: ``x``'s; needed for a "meta" tensor) picks the
    recorded kernel routing."""
    _check_strategy(strategy)
    device = x.device if device is None else device
    backend, use_kernels = probe_backend(device)
    shape, length = tuple(x.shape), math.prod(x.shape)
    if key is None:
        key = p2p_plan_key(shape, dtype_name(x.dtype), axis_name, policy, tensor_class,
                           strategy, n_dev, device)
    bucket = _p2p_bucket(length, x.dtype, axis_name, policy=policy, n_dev=n_dev,
                         tensor_class=tensor_class, strategy=strategy)
    return CommPlan(key=key, kind="p2p", axis=axis_tuple(axis_name), n_dev=n_dev,
                    backend=backend, use_kernels=use_kernels,
                    buckets=(_with_members(bucket, ((0, shape, length),)),),
                    n_leaves=1, strategy=strategy)


def p2p_plan_key(shape, dtype_name: str, axis_name, policy, tensor_class: str,
                 strategy: str, n_dev: int, device="cuda") -> tuple:
    return ("p2p", (tuple(shape), str(dtype_name)), str(strategy), axis_tuple(axis_name),
            int(n_dev), policy_fingerprint(policy, tensor_class), probe_backend(device))


def cached_p2p_plan(x, axis_name, *, policy, n_dev: int, tensor_class: str = "weight",
                    strategy: str = "split_send", cache=None) -> CommPlan:
    """Keyed-cache wrapper of :func:`compile_p2p_plan`: one compile a send
    signature (shape, dtype, strategy, policy, device), then hits."""
    from repro_torch.sched.cache import default_cache

    cache = default_cache() if cache is None else cache
    key = p2p_plan_key(tuple(x.shape), dtype_name(x.dtype), axis_name, policy,
                       tensor_class, strategy, n_dev, x.device)
    return cache.get_or_compile(key, lambda: compile_p2p_plan(
        x, axis_name, policy=policy, n_dev=n_dev, tensor_class=tensor_class,
        strategy=strategy, key=key))


# ---------------------------------------------------------------------------
# serve KV: the cache pytree shipped over the P2P wire (paper §5.3.2)
# ---------------------------------------------------------------------------

def compile_kv_plan(cache, axis_name, *, policy, n_dev: int,
                    strategy: str = "split_send", key: tuple = None,
                    device=None) -> CommPlan:
    """Compile a KV-cache transfer schedule (kind "kv") under a P2P
    ``strategy`` (``serve/kv_transfer.transfer_cache``).

    Leaves are split with ``kv_transfer._bucket_leaves``; compressible
    leaves fuse into one flat message per dtype (in first-seen leaf order),
    each gated and sized like a P2P send of the concatenated bucket at
    tensor class "activation".  ``device`` (default: the cache's) picks the
    recorded kernel routing.  The host wire (``kv_transfer.pack_cache``)
    reads the widths of the default, ``split_send``, plan."""
    from repro_torch.serve.kv_transfer import _bucket_leaves

    _check_strategy(strategy)
    leaves, comp, raw = _bucket_leaves(cache)
    device = _device_of(leaves) if device is None else device
    backend, use_kernels = probe_backend(device)
    groups: dict = {}
    for i in comp:
        groups.setdefault(leaves[i].dtype, []).append(i)
    buckets = []
    for dt, idxs in groups.items():
        members = tuple((i, tuple(leaves[i].shape), math.prod(leaves[i].shape))
                        for i in idxs)
        bucket = _p2p_bucket(sum(m[2] for m in members), dt, axis_name,
                             policy=policy, n_dev=n_dev,
                             tensor_class="activation", strategy=strategy)
        buckets.append(_with_members(bucket, members))
    if key is None:
        key = kv_plan_key(cache, axis_name, policy, n_dev, device, strategy=strategy)
    return CommPlan(key=key, kind="kv", axis=axis_tuple(axis_name), n_dev=n_dev,
                    backend=backend, use_kernels=use_kernels,
                    buckets=tuple(buckets), raw_leaf_ix=tuple(raw),
                    n_leaves=len(leaves), strategy=strategy)


def _device_of(leaves) -> torch.device:
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def kv_plan_key(cache, axis_name, policy, n_dev: int, device=None, *,
                strategy: str = "split_send") -> tuple:
    if device is None:
        device = _device_of(tree_leaves(cache))
    return ("kv", tree_signature(cache), str(strategy), axis_tuple(axis_name),
            int(n_dev), policy_fingerprint(policy, "activation"),
            probe_backend(device))


def cached_kv_plan(cache, axis_name, *, policy, n_dev: int,
                   strategy: str = "split_send", plan_cache=None) -> CommPlan:
    """Keyed-cache wrapper of :func:`compile_kv_plan`, the serve engine's
    entry point: a signature-stable cache compiles once and hits after."""
    from repro_torch.sched.cache import default_cache

    plan_cache = default_cache() if plan_cache is None else plan_cache
    key = kv_plan_key(cache, axis_name, policy, n_dev, strategy=strategy)
    return plan_cache.get_or_compile(
        key, lambda: compile_kv_plan(cache, axis_name, policy=policy, n_dev=n_dev,
                                     strategy=strategy, key=key))


# ---------------------------------------------------------------------------
# weight sync: the versioned trainer -> replica send (paper §5.3.1), per-dtype
# leaf buckets with both the full and the XOR-delta wire's schedule
# ---------------------------------------------------------------------------

def delta_wire_bytes(n_padded: int, *, width: int, lo_width: int, block: int,
                     exc_frac: float) -> int:
    """Wire size of ONE XOR-delta message of ``n_padded`` (block-padded)
    elements (``packing.encode_delta``): the lo-delta plane (payload words,
    ``min(n, max(4, ceil(n * exc_frac)))`` int32 indices and uint32 raw
    values, the overflow scalar), then the exponent-delta plane as in
    :func:`p2p_wire_bytes`.  Unlike the full wire's, the size does not
    depend on the float format."""
    n_blocks = -(-n_padded // block)
    cap_lo = min(n_padded, max(4, int(math.ceil(n_padded * exc_frac))))
    cap = packing.exception_capacity(n_blocks, exc_frac)
    lo = -(-n_padded // packing.GROUP) * lo_width * 4 + cap_lo * 8 + 4
    exp = (n_blocks * block // packing.GROUP * width * 4 + n_blocks + cap * 4
           + cap * block + 4)
    return lo + exp


def compile_broadcast_schedule(n_receivers: int, *, kind: str = BROADCAST_TREE,
                               fanout: int = 2) -> BroadcastSchedule:
    """Normalise (fleet size, requested kind, requested fan-out) into the
    frozen :class:`BroadcastSchedule` a wsync plan carries: ``star`` widens
    to ``n_receivers`` (every receiver a trainer child), ``pipeline``
    narrows to 1 (a forwarding chain), ``tree`` keeps ``fanout`` clamped to
    the fleet (3 replicas at fanout 8 are a star-shaped tree)."""
    if kind not in BROADCAST_KINDS:
        raise ValueError(f"unknown broadcast kind {kind!r}; expected one of "
                         f"{BROADCAST_KINDS}")
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    n = int(n_receivers)
    if kind == BROADCAST_STAR:
        eff = max(n, 1)
    elif kind == BROADCAST_PIPELINE:
        eff = 1
    else:
        eff = min(int(fanout), max(n, 1))
    return BroadcastSchedule(kind=kind, fanout=eff, n_receivers=n)


def _schedule(broadcast, fanout: int, n_receivers: int):
    return (None if broadcast is None else
            compile_broadcast_schedule(n_receivers, kind=broadcast, fanout=fanout))


def compile_wsync_plan(tree, axis_name, *, policy, n_dev: int,
                       strategy: str = "split_send", broadcast: str = None,
                       fanout: int = 2, n_receivers: int = 0, key: tuple = None,
                       device=None) -> CommPlan:
    """Compile a weight-sync schedule (kind "wsync").

    Codec-float leaves fuse into one flat bucket per dtype (sorted by dtype
    name), each gated and sized like a P2P message of the concatenated
    bucket at tensor class "weight" under ``strategy``, plus the XOR-delta
    schedule of each compressed bucket: ``policy.delta_widths`` and the
    expected delta wire bytes.  Delta or full is chosen per receiver at run
    time; the plan holds the schedule of both.  The host engine
    (``sync/engine.py``) and the in-mesh wire (``sched/executor.execute_wsync``)
    read it.  ``device`` (default: the tree's) picks the recorded kernel
    routing.

    ``broadcast``/``fanout``/``n_receivers`` compile the fan-out topology
    into the plan (``CommPlan.broadcast``): who forwards the encoded wire
    to whom when one publish goes to ``n_receivers`` receivers of the same
    base.  ``broadcast=None`` (default) leaves the plan without a receiver
    count: the sender sends every copy itself."""
    _check_strategy(strategy)
    schedule = _schedule(broadcast, fanout, n_receivers)
    leaves, _ = tree_flatten(tree)
    device = _device_of(leaves) if device is None else device
    backend, use_kernels = probe_backend(device)
    groups, raw_ix = _group_leaves(leaves)
    block, exc = policy.profile.block, policy.profile.exc_frac
    buckets = []
    for name in sorted(groups):
        members = groups[name]
        length = sum(m[2] for m in members)
        dt = codec.LAYOUTS[name].dtype
        bucket = _with_members(
            _p2p_bucket(length, dt, axis_name, policy=policy, n_dev=n_dev,
                        tensor_class="weight", strategy=strategy), members)
        if bucket.path == PATH_COMPRESSED:
            w_d, w_lo = policy.delta_widths(name)
            bucket = dataclasses.replace(
                bucket, delta_width=w_d, delta_lo_width=w_lo,
                delta_wire_bytes=delta_wire_bytes(
                    _pad_up(length, block), width=w_d, lo_width=w_lo, block=block,
                    exc_frac=exc))
        buckets.append(bucket)
    if key is None:
        key = wsync_plan_key(tree, axis_name, policy, n_dev, device, strategy=strategy,
                             broadcast=schedule)
    return CommPlan(key=key, kind="wsync", axis=axis_tuple(axis_name), n_dev=n_dev,
                    backend=backend, use_kernels=use_kernels,
                    buckets=tuple(buckets), raw_leaf_ix=raw_ix,
                    n_leaves=len(leaves), strategy=strategy, broadcast=schedule)


def wsync_plan_key(tree, axis_name, policy, n_dev: int, device=None, *,
                   strategy: str = "split_send",
                   broadcast: BroadcastSchedule | None = None) -> tuple:
    # the schedule triple is part of the key: a fleet size or fan-out change
    # misses and recompiles (route_for also refuses a stale topology)
    if device is None:
        device = _device_of(tree_leaves(tree))
    sched_key = (None if broadcast is None else
                 (broadcast.kind, broadcast.fanout, broadcast.n_receivers))
    return ("wsync", tree_signature(tree), str(strategy), axis_tuple(axis_name),
            int(n_dev), policy_fingerprint(policy, "weight"), probe_backend(device),
            sched_key)


def cached_wsync_plan(tree, axis_name, *, policy, n_dev: int,
                      strategy: str = "split_send", broadcast: str = None,
                      fanout: int = 2, n_receivers: int = 0, cache=None) -> CommPlan:
    """Keyed-cache wrapper of :func:`compile_wsync_plan`, the weight-sync
    engine's entry point: a stable weight-tree signature compiles on the
    first publish and hits on every later one.  With a ``broadcast`` kind, a
    stable fleet size hits and a changed one recompiles."""
    from repro_torch.sched.cache import default_cache

    cache = default_cache() if cache is None else cache
    key = wsync_plan_key(tree, axis_name, policy, n_dev, strategy=strategy,
                         broadcast=_schedule(broadcast, fanout, n_receivers))
    return cache.get_or_compile(
        key, lambda: compile_wsync_plan(tree, axis_name, policy=policy, n_dev=n_dev,
                                        strategy=strategy, broadcast=broadcast,
                                        fanout=fanout, n_receivers=n_receivers, key=key))


# ---------------------------------------------------------------------------
# kind registry: CommPlan.kind -> compiler
# ---------------------------------------------------------------------------

PLAN_KINDS = {
    "psum": compile_psum_plan,
    "reduce_scatter": compile_reduce_scatter_plan,
    "all_gather": compile_all_gather_plan,
    "zero1": compile_zero1_plan,
    "fsdp_gather": compile_fsdp_gather_plan,
    "p2p": compile_p2p_plan,
    "kv": compile_kv_plan,
    "wsync": compile_wsync_plan,
}
