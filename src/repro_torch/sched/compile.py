"""CommPlan compiler (torch port of ``repro.sched.compile``; the ``kv`` and
``wsync`` kinds so far).

What ``serve/kv_transfer`` would decide per shipment and the weight-sync
engine per publish (leaf buckets, the compress gate, the codec widths, the
expected wire bytes) is decided here, once, from shapes and dtypes.  The
expected bytes are the wire formats' closed-form sizes
(:func:`p2p_wire_bytes`, :func:`delta_wire_bytes`), where the reference
traces its encoders with ``jax.eval_shape``; the tests hold the two equal.
The P2P strategy is the reference's default, ``split_send``, throughout.
The reference's broadcast schedules (its ``broadcast=`` argument of the
wsync compiler) are not ported: a wsync plan is receiver-count-agnostic.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import kernels
from repro_torch.core import codec, packing
from repro_torch.sched.plan import (PATH_COMPRESSED, PATH_RAW, BucketPlan,
                                    CommPlan, dtype_name, policy_fingerprint,
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


def _p2p_bucket(length: int, dtype, axis_name, *, policy, n_dev: int,
                tensor_class: str) -> BucketPlan:
    """One flat split-send P2P message's schedule: the policy gate and the
    width, as a BucketPlan (``chunk``: the block-padded length of the
    send)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    base = dict(dtype_name=dtype_name(dtype), members=((0, (length,), length),),
                length=length, n_dev=n_dev)
    struct = torch.empty((length,), dtype=dtype, device="meta")
    if not policy.should_compress(struct, axis_name, tensor_class=tensor_class):
        return BucketPlan(path=PATH_RAW, raw_bytes=length * itemsize, **base)
    width = policy.width_for(tensor_class)
    block, exc = policy.profile.block, policy.profile.exc_frac
    padded = _pad_up(length, block)
    # split_send materialises the split (its early lo-plane send needs it),
    # so its encode is never the fused one-pass kernel
    return BucketPlan(path=PATH_COMPRESSED, width=width, block=block, exc_frac=exc,
                      fused=policy.fused_decode_reduce, encode_fused=False,
                      chunk=padded,
                      wire_bytes=p2p_wire_bytes(padded, dtype, width=width,
                                                block=block, exc_frac=exc),
                      raw_bytes=padded * itemsize, **base)


def _with_members(bucket: BucketPlan, members) -> BucketPlan:
    return dataclasses.replace(bucket, members=tuple(members))


def compile_kv_plan(cache, axis_name, *, policy, n_dev: int,
                    key: tuple = None, device=None) -> CommPlan:
    """Compile a KV-cache transfer schedule (kind "kv"), shipped with the
    reference's default P2P strategy, ``split_send``.

    Leaves are split with ``kv_transfer._bucket_leaves``; compressible
    leaves fuse into one flat message per dtype (in first-seen leaf order),
    each gated and sized like a P2P send of the concatenated bucket at
    tensor class "activation".  ``device`` (default: the cache's) picks the
    recorded kernel routing."""
    from repro_torch.serve.kv_transfer import _bucket_leaves

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
                             tensor_class="activation")
        buckets.append(_with_members(bucket, members))
    if key is None:
        key = kv_plan_key(cache, axis_name, policy, n_dev, device)
    return CommPlan(key=key, kind="kv", axis=axis_tuple(axis_name), n_dev=n_dev,
                    backend=backend, use_kernels=use_kernels,
                    buckets=tuple(buckets), raw_leaf_ix=tuple(raw),
                    n_leaves=len(leaves))


def _device_of(leaves) -> torch.device:
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def kv_plan_key(cache, axis_name, policy, n_dev: int, device=None) -> tuple:
    if device is None:
        device = _device_of(tree_leaves(cache))
    return ("kv", tree_signature(cache), axis_tuple(axis_name),
            int(n_dev), policy_fingerprint(policy, "activation"),
            probe_backend(device))


def cached_kv_plan(cache, axis_name, *, policy, n_dev: int,
                   plan_cache=None) -> CommPlan:
    """Keyed-cache wrapper of :func:`compile_kv_plan`, the serve engine's
    entry point: a signature-stable cache compiles once and hits after."""
    from repro_torch.sched.cache import default_cache

    plan_cache = default_cache() if plan_cache is None else plan_cache
    key = kv_plan_key(cache, axis_name, policy, n_dev)
    return plan_cache.get_or_compile(
        key, lambda: compile_kv_plan(cache, axis_name, policy=policy,
                                     n_dev=n_dev, key=key))


# ---------------------------------------------------------------------------
# weight sync: the versioned trainer -> replica send (paper §5.3.1), per-dtype
# leaf buckets with both the full and the XOR-delta wire's schedule
# ---------------------------------------------------------------------------

def _group_leaves(leaves) -> tuple:
    """The reference's psum bucketing: codec-float leaves group per dtype
    name (in leaf order), every other leaf is raw.  Returns ``({name:
    [(i, shape, size), ...]}, raw leaf indices)``."""
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


def compile_wsync_plan(tree, axis_name, *, policy, n_dev: int,
                       key: tuple = None, device=None) -> CommPlan:
    """Compile a weight-sync schedule (kind "wsync").

    Codec-float leaves fuse into one flat bucket per dtype (sorted by dtype
    name), each gated and sized like a ``split_send`` P2P message of the
    concatenated bucket at tensor class "weight", plus the XOR-delta
    schedule of each compressed bucket: ``policy.delta_widths`` and the
    expected delta wire bytes.  Delta or full is chosen per receiver at run
    time; the plan holds the schedule of both.  ``device`` (default: the
    tree's) picks the recorded kernel routing."""
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
                        tensor_class="weight"), members)
        if bucket.path == PATH_COMPRESSED:
            # A host update ships whole messages, so its full encode is the
            # one-pass kernel (``packing.encode_message``); the reference
            # records split_send's encode_fused=False, which its in-mesh
            # early lo-plane send needs and the host wire does not.
            w_d, w_lo = policy.delta_widths(name)
            bucket = dataclasses.replace(
                bucket, encode_fused=True, delta_width=w_d, delta_lo_width=w_lo,
                delta_wire_bytes=delta_wire_bytes(
                    _pad_up(length, block), width=w_d, lo_width=w_lo, block=block,
                    exc_frac=exc))
        buckets.append(bucket)
    if key is None:
        key = wsync_plan_key(tree, axis_name, policy, n_dev, device)
    return CommPlan(key=key, kind="wsync", axis=axis_tuple(axis_name), n_dev=n_dev,
                    backend=backend, use_kernels=use_kernels,
                    buckets=tuple(buckets), raw_leaf_ix=raw_ix,
                    n_leaves=len(leaves))


def wsync_plan_key(tree, axis_name, policy, n_dev: int, device=None) -> tuple:
    if device is None:
        device = _device_of(tree_leaves(tree))
    return ("wsync", tree_signature(tree), axis_tuple(axis_name), int(n_dev),
            policy_fingerprint(policy, "weight"), probe_backend(device))


def cached_wsync_plan(tree, axis_name, *, policy, n_dev: int,
                      cache=None) -> CommPlan:
    """Keyed-cache wrapper of :func:`compile_wsync_plan`, the weight-sync
    engine's entry point: a stable weight-tree signature compiles on the
    first publish and hits on every later one."""
    from repro_torch.sched.cache import default_cache

    cache = default_cache() if cache is None else cache
    key = wsync_plan_key(tree, axis_name, policy, n_dev)
    return cache.get_or_compile(
        key, lambda: compile_wsync_plan(tree, axis_name, policy=policy,
                                        n_dev=n_dev, key=key))
