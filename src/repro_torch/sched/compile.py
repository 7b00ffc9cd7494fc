"""CommPlan compiler (torch port of ``repro.sched.compile``; the ``kv`` kind
so far).

What ``serve/kv_transfer`` would decide per shipment (leaf buckets, the
compress gate, the codec width, the expected wire bytes) is decided here,
once, from shapes and dtypes.  The expected bytes are the wire format's
closed-form size (:func:`p2p_wire_bytes`), where the reference traces its
encoder with ``jax.eval_shape``; the tests hold the two equal.
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
from repro_torch.tree_util import tree_leaves

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
        buckets.append(dataclasses.replace(bucket, members=members))
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
