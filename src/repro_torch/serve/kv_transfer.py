"""KV-cache transfer for prefill-decode disaggregation (paper §5.3.2);
torch port of ``repro.serve.kv_transfer``.

Two wires:

  * in-mesh (:func:`transfer_cache`): prefill and decode ranks share a
    process group; the compressible leaves fuse into one flat message per
    dtype (large blocks keep the codec efficient) and cross it over the P2P
    pipeline (``core/split_send.p2p_send``, by default the split-send);
    ``sched.transfer_cache_with_plan`` replays the same decisions from a
    kind-"kv" ``CommPlan``, to the same bits;
  * host (:func:`pack_cache` / :func:`unpack_cache`): PD workers are
    separate processes; the prefilled cache is encoded leaf by leaf with the
    host engine (``p2p/engine.Compressor``), shipped out of band as numpy
    messages with a CRC-32 over the payload, and decoded on the other side
    bit for bit.  The codec widths come from a kind-"kv" ``CommPlan``
    compiled once per cache signature (:func:`ship_cache`), so a serve
    engine with a stable cache shape decides once and hits the plan cache on
    every later shipment.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import codec, integrity
from repro_torch.core.compressed_collectives import _no_flag
from repro_torch.core.policy import CompressionPolicy
from repro_torch.sched.plan import dtype_name
from repro_torch.tree_util import tree_flatten, tree_unflatten


def _bucket_leaves(cache):
    """Split cache leaves into (compressible, passthrough) index sets: a
    compressible leaf is a codec float with at least one dimension.  The one
    rule of KV wires, shared with ``sched/compile.compile_kv_plan``."""
    leaves, _ = tree_flatten(cache)
    comp, raw = [], []
    for i, leaf in enumerate(leaves):
        if (isinstance(leaf, torch.Tensor) and dtype_name(leaf.dtype) in codec.LAYOUTS
                and leaf.dim() > 0):
            comp.append(i)
        else:
            raw.append(i)
    return leaves, comp, raw


def transfer_cache(cache, group, perm, *, policy: CompressionPolicy,
                   strategy: str = "split_send", plan=None, axis_name="data"):
    """Ship a KV-cache pytree along ``perm`` (``(source, target)`` ranks of
    ``group``) over the in-mesh wire.  The compressible leaves fuse into one
    flat bucket per dtype, in first-seen leaf order, each sent by
    ``split_send.p2p_send`` at tensor class "activation" under
    ``strategy``; every other leaf takes the raw ppermute (a 0-d leaf as
    ``[None]``).  Returns (cache at the target, flag), every leaf the bits
    of a raw ppermute.  ``plan`` (a compiled kind-"kv" ``CommPlan``) replays
    its schedule instead (``sched/executor.execute_kv_transfer``)."""
    from repro_torch.core.split_send import p2p_send, send_raw_leaves

    if plan is not None:
        from repro_torch.sched.executor import execute_kv_transfer

        return execute_kv_transfer(plan, cache, group, perm)
    leaves, comp, raw = _bucket_leaves(cache)
    out = list(leaves)
    flag = _no_flag(leaves[0])
    groups: dict = {}
    for i in comp:
        groups.setdefault(leaves[i].dtype, []).append(
            (i, tuple(leaves[i].shape), leaves[i].numel()))
    for members in groups.values():
        got, f = p2p_send(codec.concat_members(leaves, members), group, perm,
                          policy=policy, tensor_class="activation", strategy=strategy,
                          axis_name=axis_name)
        flag = torch.maximum(flag, f)
        for i, leaf in codec.split_members(got, members):
            out[i] = leaf
    send_raw_leaves(leaves, raw, out, group, perm)
    return tree_unflatten(tree_flatten(cache)[1], out), flag


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def pack_cache(cache, engine, plan=None) -> dict:
    """Encode a cache pytree with the host engine (packed or rANS codec).

    Returns the wire ``{"messages", "treedef", "meta", "checksum"}``:
    compressible leaves become ``Message``s, the rest numpy arrays, and the
    CRC-32 covers (messages, meta).  ``plan`` (a kind-"kv" ``CommPlan``)
    hands the engine its recorded per-dtype widths."""
    leaves, comp, _ = _bucket_leaves(cache)
    comp = set(comp)
    msgs, meta = [], []
    for i, leaf in enumerate(leaves):
        if i in comp:
            msgs.append(engine.encode(leaf, tensor_class="activation", plan=plan))
            meta.append(("z", tuple(leaf.shape), dtype_name(leaf.dtype)))
        else:
            arr = _to_numpy(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            msgs.append(arr)
            meta.append(("raw", arr.shape, arr.dtype.name))
    return {
        "messages": msgs,
        "treedef": tree_flatten(cache)[1],
        "meta": meta,
        "checksum": integrity.crc32_tree((msgs, meta)),
    }


def verify_wire(wire: dict) -> bool:
    """True iff the packed wire's payload still matches its checksum (a wire
    without one verifies vacuously)."""
    c = wire.get("checksum")
    if c is None:
        return True
    return integrity.crc32_tree((wire["messages"], wire["meta"])) == c


def unpack_cache(wire: dict, engine, *, verify: bool = True):
    """Inverse of :func:`pack_cache`, on the engine's device.  Verifies the
    checksum first and raises ``WireIntegrityError`` on a mismatch: a
    corrupt shipment is rejected before any decode."""
    if verify and not verify_wire(wire):
        raise integrity.WireIntegrityError(
            "packed KV wire failed its content checksum; re-ship it")
    out = []
    for msg, (kind, shape, _) in zip(wire["messages"], wire["meta"]):
        if kind == "z":
            out.append(engine.decode(msg).reshape(shape))
        else:
            out.append(torch.from_numpy(np.array(msg)).to(engine.device))
    return tree_unflatten(wire["treedef"], out)


def ship_cache(cache, engine, *, policy: CompressionPolicy, plan_cache=None,
               axis_name: str = "data") -> tuple:
    """Host-path PD shipment with a cached kind-"kv" plan: compiles (or
    fetches, keyed on the cache signature) the plan, packs with its
    recorded widths, and returns ``(wire, plan)``."""
    from repro_torch.sched.compile import cached_kv_plan

    plan = cached_kv_plan(cache, axis_name, policy=policy, n_dev=1,
                          plan_cache=plan_cache)
    return pack_cache(cache, engine, plan=plan), plan
