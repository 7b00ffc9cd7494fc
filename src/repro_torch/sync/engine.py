"""Host-path weight-sync engine: one trainer, N inference replicas (torch
port of ``repro.sync.engine``).

The paper's headline P2P workload (§5.3.1, Fig. 10): the trainer pushes its
updated policy weights to the rollout replicas every iteration.

  * The schedule (per-dtype leaf buckets, compress-vs-raw gates, the full and
    the XOR-delta widths, the expected wire bytes) comes from a kind-"wsync"
    ``CommPlan`` cached on the weight tree's signature: the first publish
    compiles it, every later one hits.
  * ``sync/store.VersionedStore`` decides delta or full per replica: a delta
    against the replica's acked version when the trainer still keeps it and
    the ack is epoch-current, the full tensors otherwise.
  * A delta whose exceptions overflow the calibrated widths falls back to a
    full encode of that bucket, and a full encode that overflows to the raw
    bits, before anything ships: every path reconstructs the published bits,
    NaN and Inf payloads included.

The codec runs on the device of the published tensors (the encode_fused and
pack kernels on CUDA); an update's messages are numpy arrays with the
reference's dtypes (:func:`host_message`), so either package decodes an
update that the other encoded.

Observability (``obs``): the ``sync:publish``, ``sync:update`` and
``sync:encode`` spans and the ``sync:memo_hit`` instant; publish, update,
bucket-route, memo and per-replica lag metrics; each bucket's bytes in the
per-bucket ledger under the host kind ``wsync_host``, a bounded sample of
its payload for the width-regret analysis, and each update's live wire
ratio against the plan's prediction in the drift detector.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import kernels, obs
from repro_torch.core import codec, integrity, packing
from repro_torch.core.policy import CompressionPolicy
from repro_torch.obs import drift as drift_lib
from repro_torch.obs import regret as regret_lib
from repro_torch.p2p.engine import host_array
from repro_torch.sched.compile import cached_wsync_plan
from repro_torch.sched.plan import PATH_COMPRESSED
from repro_torch.sync.store import VersionedStore
from repro_torch.tree_util import tree_flatten, tree_unflatten

MODE_DELTA = "delta"
MODE_FULL = "full"
MODE_RAW = "raw"

# recovery overrides of update_for: a rejected delta re-sends full, a rejected
# full re-sends raw
FORCE_MODES = (None, MODE_FULL, MODE_RAW)

_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}
_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """A wire array as a new tensor on ``dev`` with the same bits (uint16/32
    as int16/32, which is how the codec holds them)."""
    a = np.asarray(a, order="C")
    return torch.from_numpy(a.view(_SIGNED.get(a.dtype, a.dtype))).to(dev, copy=True)


def _host_plane(p: packing.PackedPlane) -> packing.PackedPlane:
    return dataclasses.replace(
        p, payload=host_array(p.payload, np.uint32),
        bases=host_array(p.bases, np.uint8), exc_idx=host_array(p.exc_idx, np.int32),
        exc_raw=host_array(p.exc_raw, np.uint8),
        overflow=host_array(p.overflow, np.int32))


def _device_plane(p, dev) -> packing.PackedPlane:
    return packing.PackedPlane(
        payload=_tensor(p.payload, dev), bases=_tensor(p.bases, dev),
        exc_idx=_tensor(p.exc_idx, dev), exc_raw=_tensor(p.exc_raw, dev),
        overflow=_tensor(p.overflow, dev), width=int(p.width),
        block=int(p.block), n=int(p.n), exp_bits=int(p.exp_bits))


def host_message(m):
    """A ``CompressedMessage`` or ``DeltaMessage`` with tensor fields as the
    same message with numpy fields in the reference's dtypes: uint32 plane
    words and lo exceptions, uint8 bases and raw exponents, int32 indices
    and overflow flags."""
    if isinstance(m, packing.DeltaMessage):
        lo = dataclasses.replace(
            m.lo, payload=host_array(m.lo.payload, np.uint32),
            exc_idx=host_array(m.lo.exc_idx, np.int32),
            exc_raw=host_array(m.lo.exc_raw, np.uint32),
            overflow=host_array(m.lo.overflow, np.int32))
        return dataclasses.replace(m, lo=lo, exp=_host_plane(m.exp))
    return dataclasses.replace(m, lo=host_array(m.lo, np.uint32), exp=_host_plane(m.exp))


def _device_message(m, mode: str, dev: torch.device):
    """Inverse of :func:`host_message` onto ``dev``.  Reads the fields by
    name, so the reference's numpy messages are taken as well."""
    exp = _device_plane(m.exp, dev)
    shape = tuple(int(s) for s in m.shape)
    if mode == MODE_DELTA:
        lo = m.lo
        return packing.DeltaMessage(
            lo=packing.DeltaPlane(
                payload=_tensor(lo.payload, dev), exc_idx=_tensor(lo.exc_idx, dev),
                exc_raw=_tensor(lo.exc_raw, dev), overflow=_tensor(lo.overflow, dev),
                width=int(lo.width), n=int(lo.n)),
            exp=exp, dtype_name=m.dtype_name, shape=shape)
    return packing.CompressedMessage(lo=_tensor(m.lo, dev), exp=exp,
                                     dtype_name=m.dtype_name, shape=shape)


def _raw_wire(bucket: torch.Tensor, dtype_name: str) -> np.ndarray:
    """A raw bucket as its wire array: codec floats travel as their unsigned
    bit patterns, anything else as it is."""
    lay = codec.LAYOUTS.get(dtype_name)
    if lay is None:
        return bucket.detach().cpu().numpy()
    return host_array(bucket.view(lay.bits_dtype), _UINT[lay.total_bits // 8])


def _raw_unwire(msg, dtype_name: str, dev: torch.device) -> torch.Tensor:
    t = _tensor(msg, dev)
    lay = codec.LAYOUTS.get(dtype_name)
    return t if lay is None else t.view(lay.dtype)


@dataclasses.dataclass
class SyncUpdate:
    """One encoded trainer -> replica weight shipment.

    ``base_version`` is None for a full send; otherwise every ``MODE_DELTA``
    bucket decodes against that version's bits (the receiver's current
    weights, ``apply_update(base_params=...)``).  ``buckets`` carry
    ``(dtype_name, members, mode, message)`` per plan bucket, ``raw_leaves``
    the leaves outside every bucket.  ``checksum`` is the CRC-32 of the
    payload (:func:`update_checksum`); the (version, epoch, base) envelope is
    left out because the receiver fences it against its own state."""

    version: int
    epoch: int
    base_version: Optional[int]
    treedef: Any
    n_leaves: int
    buckets: tuple  # ((dtype_name, members, mode, message), ...)
    raw_leaves: tuple  # ((leaf_index, ndarray), ...)
    wire_bytes: int
    raw_bytes: int
    checksum: Optional[int] = None

    @property
    def mode(self) -> str:
        """"delta" if any bucket shipped a delta, else "full"."""
        return (MODE_DELTA if any(m == MODE_DELTA for _, _, m, _ in self.buckets)
                else MODE_FULL)

    @property
    def ratio(self) -> float:
        return self.wire_bytes / max(self.raw_bytes, 1)


def apply_update(update: SyncUpdate, base_params=None, *, device="cuda"):
    """The published weights of ``update``, bit-identical, as a tree of
    tensors on ``device``.  ``base_params`` (the receiver's weights at
    ``update.base_version``) is required iff the update carries delta
    buckets.  Every bucket is decoded before the tree is returned, so the
    result never aliases ``base_params``."""
    dev = kernels.resolve_device(device)
    leaves: list = [None] * update.n_leaves
    base_leaves = None if base_params is None else tree_flatten(base_params)[0]
    for dtype_name, members, mode, msg in update.buckets:
        if mode == MODE_DELTA:
            if base_leaves is None:
                raise ValueError(
                    f"update v{update.version} deltas against v{update.base_version}; "
                    f"apply_update needs base_params")
            base_bucket = codec.pad_flat_bits(
                codec.concat_members(base_leaves, members), math.prod(msg.shape))
            got = packing.decode_delta(_device_message(msg, mode, dev),
                                       base_bucket.to(dev))
        elif mode == MODE_FULL:
            got = packing.decode_message(_device_message(msg, mode, dev))
        else:
            got = _raw_unwire(msg, dtype_name, dev)
        for i, leaf in codec.split_members(got, members):
            leaves[i] = leaf
    for i, arr in update.raw_leaves:
        leaves[i] = _tensor(arr, dev)
    return tree_unflatten(update.treedef, leaves)


def update_checksum(update: SyncUpdate) -> int:
    """CRC-32 over the payload: the bucket schedule (dtype, members, mode),
    every message array and the raw leaves.  Equal to the reference's for
    the same payload."""
    c = integrity.crc32_tree(update.n_leaves)
    for dtype_name, members, mode, msg in update.buckets:
        c = integrity.crc32_tree((dtype_name, members, mode, msg), seed=c)
    return integrity.crc32_tree(update.raw_leaves, seed=c)


def verify_update(update: SyncUpdate) -> bool:
    """True iff the update carries a checksum and its payload still matches
    it.  Receivers call it before :func:`apply_update`; False means reject
    and ask again (delta -> full -> raw), never apply."""
    return update.checksum is not None and update_checksum(update) == update.checksum


class WeightSyncEngine:
    """Trainer-side weight-sync engine with versioned XOR-delta encoding."""

    def __init__(self, *, policy: CompressionPolicy = None, axis_name: str = "data",
                 history: int = 4, plan_cache=None) -> None:
        self.policy = CompressionPolicy() if policy is None else policy
        self.axis_name = axis_name
        self.store = VersionedStore(history=history)
        self.plan_cache = plan_cache
        # encoded updates of the LATEST version, keyed by (base version,
        # force): replicas that acked the same base get the same update, so
        # sending to N of them encodes once
        self._updates: dict = {}

    # -- trainer side --------------------------------------------------------

    def publish(self, params) -> int:
        """Keep ``params`` (a tree of tensors) as the next weight version."""
        self._updates.clear()  # encoded updates are per version
        with obs.span("sync:publish"):
            version = self.store.publish(params)
        obs.metric("sync_publish_total").inc()
        self._export_lag()  # every replica just fell one version behind
        return version

    def _export_lag(self) -> None:
        """Per-replica version-lag gauges (latest - acked, epoch-current)."""
        if not obs.enabled():
            return
        gauge = obs.metric("sync_replica_version_lag")
        latest = self.store.version
        for r in self.store.acked_replicas():
            gauge.set(latest - self.store.acked_version(r), replica=str(r))

    def plan_for(self, params, *, broadcast: Optional[str] = None, fanout: int = 2,
                 n_receivers: int = 0):
        """The cached kind-"wsync" CommPlan of ``params``' signature.

        ``broadcast``/``fanout``/``n_receivers`` also compile the fan-out
        topology into the plan (``CommPlan.broadcast``): the fleet asks here
        for the schedule of each group of receivers of one base, so a stable
        group size hits and a changed one recompiles.  Without a schedule
        (what ``_encode_update`` asks for) the bucket schedule is the same
        under every topology: forwarding never changes the bits."""
        return cached_wsync_plan(params, self.axis_name, policy=self.policy,
                                 n_dev=1, broadcast=broadcast, fanout=fanout,
                                 n_receivers=n_receivers, cache=self.plan_cache)

    def update_for(self, replica, *, force: Optional[str] = None) -> SyncUpdate:
        """Encode the latest version for ``replica``: an XOR delta against its
        acked base when possible (a replica that is already current gets the
        all-zero delta), the full tensors otherwise (absent, stale or fenced
        ack, raw-gated buckets, or a bucket whose delta overflowed).  Memoized
        per (latest version, base version, force).

        ``force="full"`` skips the delta even when a base is acked (the
        receiver rejected or lost a delta); ``force="raw"`` also ships every
        bucket uncompressed."""
        if force not in FORCE_MODES:
            raise ValueError(f"force must be one of {FORCE_MODES}, got {force!r}")
        with obs.span("sync:update", replica=str(replica)) as sp:
            params, version = self.store.latest()
            base_version = None if force is not None else self.store.base_for(replica)
            sp.args["version"] = version
            key = (base_version, force)
            cached = self._updates.get(key)
            if cached is not None:
                obs.instant("sync:memo_hit", version=version, base=base_version)
                obs.metric("sync_memo_hits_total").inc()
                return cached
            update = self._encode_update(params, version, base_version, force)
            self._updates[key] = update
        obs.metric("sync_updates_total").inc(mode=update.mode)
        obs.metric("sync_update_wire_bytes_total").inc(update.wire_bytes,
                                                       mode=update.mode)
        return update

    def _encode_update(self, params, version: int, base_version,
                       force: Optional[str]) -> SyncUpdate:
        base = None if base_version is None else self.store.get(base_version)
        plan = self.plan_for(params)
        leaves = tree_flatten(params)[0]
        base_leaves = None if base is None else tree_flatten(base)[0]
        buckets = []
        wire = 0
        used_delta = False
        bucket_counter = obs.metric("sync_buckets_total")
        with obs.span("sync:encode", version=version,
                      base=base_version if base_version is not None else -1):
            for b in plan.buckets:
                bucket = codec.concat_members(leaves, b.members)
                msg = base_bucket = None
                if b.path == PATH_COMPRESSED and force != MODE_RAW:
                    # pad to the block grid, so the plan's bytes are this wire's
                    bucket = codec.pad_flat_bits(bucket, b.block)
                    if base_leaves is not None and b.delta_width:
                        base_bucket = codec.pad_flat_bits(
                            codec.concat_members(base_leaves, b.members), b.block)
                        m = packing.encode_delta(bucket, base_bucket,
                                                 width=b.delta_width,
                                                 lo_width=b.delta_lo_width,
                                                 block=b.block, exc_frac=b.exc_frac)
                        if not m.overflow:  # else: fall through to full
                            mode, msg = MODE_DELTA, host_message(m)
                            used_delta = True
                    if msg is None:
                        m = packing.encode_message(bucket, width=b.width, block=b.block,
                                                   exc_frac=b.exc_frac)
                        if int(m.exp.overflow):
                            # even the full wire's exceptions overflowed: ship
                            # the bucket raw rather than corrupt it
                            mode, msg = MODE_RAW, _raw_wire(bucket, b.dtype_name)
                        else:
                            mode, msg = MODE_FULL, host_message(m)
                else:
                    mode, msg = MODE_RAW, _raw_wire(bucket, b.dtype_name)
                b_wire = msg.nbytes if mode == MODE_RAW else msg.wire_bytes()
                wire += b_wire
                bucket_counter.inc(mode=mode)
                if obs.enabled():
                    # host-path ledger + recalibration sample, under its own
                    # kind so the plan-kind exactness check stays exact
                    w_used = {MODE_DELTA: b.delta_width, MODE_FULL: b.width}.get(mode, 0)
                    obs.metric("bucket_wire_raw_bytes_total").inc(
                        bucket.numel() * bucket.element_size(), kind="wsync_host",
                        dtype=b.dtype_name, width=w_used)
                    obs.metric("bucket_wire_bytes_total").inc(
                        b_wire, kind="wsync_host", dtype=b.dtype_name, width=w_used)
                    regret_lib.record_sample("wsync_host", b.dtype_name, bucket,
                                             base=base_bucket)
                buckets.append((b.dtype_name, b.members, mode, msg))
            raw_leaves = tuple((i, leaves[i].detach().cpu().numpy())
                               for i in plan.raw_leaf_ix)
        wire += sum(arr.nbytes for _, arr in raw_leaves)
        raw_total = sum(leaf.numel() * leaf.element_size() for leaf in leaves
                        if isinstance(leaf, torch.Tensor))
        update = SyncUpdate(
            version=version, epoch=self.store.epoch,
            base_version=base_version if used_delta else None,
            treedef=tree_flatten(params)[1], n_leaves=len(leaves),
            buckets=tuple(buckets), raw_leaves=raw_leaves, wire_bytes=int(wire),
            raw_bytes=int(raw_total))
        update.checksum = update_checksum(update)
        if obs.enabled() and force is None and raw_total > 0:
            # drift: the plan predicts this send's mode mix (delta when a base
            # is acked and the widths are calibrated, full otherwise); every
            # wire size is fixed by shapes, so a stationary workload observes
            # live == predicted and only the data-dependent fallbacks (delta
            # or full overflow) diverge: the stale-calibration signal
            comp = [bb for bb in plan.buckets if bb.compressed]
            delta_planned = base_leaves is not None and any(bb.delta_width for bb in comp)
            pred = ((plan.delta_wire_bytes if delta_planned else plan.wire_bytes)
                    + sum(bb.raw_bytes for bb in plan.buckets if not bb.compressed)
                    + sum(arr.nbytes for _, arr in raw_leaves))
            drift_lib.observe((plan.key, "host"), plan.kind, pred / raw_total,
                              update.ratio)
        return update

    def ack(self, replica, version: int, epoch: Optional[int] = None) -> bool:
        """Record a replica's applied version (epoch-fenced)."""
        ok = self.store.ack(replica, version, epoch)
        if ok:
            obs.metric("sync_replica_version_lag").set(
                self.store.version - version, replica=str(replica))
        return ok

    def advance_epoch(self) -> int:
        """Fence all acks (trainer restart or restore): the next sends are
        full."""
        self._updates.clear()  # cached updates carry the old epoch
        return self.store.advance_epoch()
