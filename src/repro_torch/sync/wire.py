"""The planless in-mesh weight sync (torch port of ``repro.sync.wire``, the
kind-"wsync" reference path), and its fan-out over a ``BroadcastSchedule``
(:func:`broadcast_weights`).

A trainer rank ships its weight pytree along a ``perm`` of a process group.
Codec-float leaves fuse into one flat bucket per dtype (sorted by dtype
name, the psum grouping rule); each bucket is gated and sized like a
``p2p_send`` at tensor class "weight" and, when both ends hold a ``base``
version, ships the XOR delta against it (``core/split_send.delta_send``),
exact and far more compressible between consecutive optimizer steps.

Every decision is re-derived from the policy at each call;
``sched.sync_weights_with_plan`` replays it from a compiled kind-"wsync"
``CommPlan``.  Both go through ``core/split_send.wsync_dispatch``, so they
give the same bits.  Who holds which base version is ``sync/store.py``'s
and ``sync/engine.py``'s business.
"""
from __future__ import annotations

import torch

from repro_torch.core import codec
from repro_torch.core.compressed_collectives import _no_flag, check_perm
from repro_torch.core.policy import CompressionPolicy
from repro_torch.core.split_send import send_raw_leaves, wsync_dispatch
from repro_torch.sched.compile import _group_leaves
from repro_torch.tree_util import tree_flatten, tree_unflatten


def sync_weights(tree, group, perm, *, policy: CompressionPolicy, base=None,
                 strategy: str = "split_send", axis_name="data"):
    """Send a weight pytree along ``perm`` (``(source, target)`` ranks of
    ``group``).  ``base=None`` ships full tensors (first contact, a stale
    receiver); ``base``, a pytree of ``tree``'s structure, ships XOR deltas
    on every compressed bucket, which the receiver decodes against its own
    copy of the base.  Raw-gated buckets and leaves outside the codec always
    ship full.  Returns (tree at the target, flag): the bits of a raw
    ppermute of ``tree`` when the flag is 0; a nonzero flag means a delta
    overflowed its widths and the caller must retry with ``base=None``."""
    leaves, treedef = tree_flatten(tree)
    base_leaves = None
    if base is not None:
        base_leaves, base_def = tree_flatten(base)
        if base_def != treedef:
            raise ValueError("the base tree's structure is not the weight tree's")
    groups, raw_ix = _group_leaves(leaves)
    out = list(leaves)
    flag = _no_flag(leaves[0])
    for name in sorted(groups):
        members = groups[name]
        bucket = codec.concat_members(leaves, members)
        bucket_base = (None if base_leaves is None
                       else codec.concat_members(base_leaves, members))
        w_d, w_lo = policy.delta_widths(name)
        got, f = wsync_dispatch(
            bucket, bucket_base, group, perm,
            compressed=policy.should_compress(bucket, axis_name, tensor_class="weight"),
            width=policy.width_for("weight"), delta_width=w_d, delta_lo_width=w_lo,
            block=policy.profile.block, exc_frac=policy.profile.exc_frac,
            strategy=strategy, fused=policy.fused_decode_reduce,
            encode_fused=policy.fused_encode, axis_name=axis_name)
        flag = torch.maximum(flag, f)
        for i, leaf in codec.split_members(got, members):
            out[i] = leaf
    send_raw_leaves(leaves, raw_ix, out, group, perm)
    return tree_unflatten(treedef, out), flag


def broadcast_weights(tree, group, schedule, ranks, *, policy: CompressionPolicy,
                      base=None, strategy: str = "split_send", axis_name="data"):
    """The planless replay of a :class:`~repro_torch.sched.plan.BroadcastSchedule`
    in the mesh: one :func:`sync_weights` a hop level, each level's perm
    sending from the previous level's receivers
    (``sched.executor.wsync_hop_perms``); the twin of
    ``sched.executor.execute_wsync_broadcast``, which gives the same bits.
    A level that repeats a source or a target raises ``ValueError`` before
    anything is sent.  Returns (the tree each rank holds after the last
    level, the ``torch.maximum`` of the levels' flags), as
    ``execute_wsync_broadcast`` does."""
    from repro_torch.sched.executor import wsync_hop_perms

    levels = wsync_hop_perms(schedule, ranks)
    for level in levels:
        check_perm(level)
    current, flag = tree, _no_flag(tree_flatten(tree)[0][0])
    for level in levels:
        current, f = sync_weights(current, group, list(level), policy=policy, base=base,
                                  strategy=strategy, axis_name=axis_name)
        flag = torch.maximum(flag, f)
    return current, flag
