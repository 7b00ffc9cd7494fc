"""Communication-plan IR (paper §3.3, the Uzip-NCCL persistent kernel model);
torch port of ``repro.sched.plan``.

A ``CommPlan`` is the static, hashable record of everything a wire would
otherwise re-derive at every call: leaf buckets, compress-vs-raw paths,
codec widths, the kernel routing and the expected wire bytes.  It is pure
data (no tensors), built by ``sched/compile.py`` from shapes and a
``CompressionPolicy``, cached by ``sched/cache.py`` on the signature of
what it ships, and replayed by ``sched/executor.py`` (the host serve and
weight-sync engines also read the ``kv`` and ``wsync`` plans).  Replaying a
plan calls the same primitives with the same arguments as the planless
entry point, so the two give the same bits.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree_util import tree_flatten

# -- bucket execution paths ---------------------------------------------------
# psum-kind buckets (mirror of ``psum_compressed``'s dispatch):
PATH_TWO_SHOT = "two_shot"        # compressed RS + compressed AG
PATH_RING = "ring"                # paper's negative baseline, per-hop codec
PATH_RAW_TWOSHOT = "raw_twoshot"  # big but gated off: byte-exact raw two-shot
PATH_RAW_PSUM = "raw_psum"        # small: plain (f32-promoted) psum
# single-phase buckets (reduce_scatter / all_gather / kv / wsync kinds):
PATH_COMPRESSED = "compressed"
PATH_RAW = "raw"

# -- broadcast schedule kinds (kind "wsync" fan-out topologies) ---------------
BROADCAST_STAR = "star"          # trainer -> every receiver directly
BROADCAST_TREE = "tree"          # k-ary tree: interior receivers forward
BROADCAST_PIPELINE = "pipeline"  # chain: every receiver forwards to one
BROADCAST_KINDS = (BROADCAST_STAR, BROADCAST_TREE, BROADCAST_PIPELINE)


@dataclasses.dataclass(frozen=True)
class BroadcastSchedule:
    """Who forwards the encoded weight-sync wire to whom (kind "wsync").

    Slot 0 is the trainer (root); slots ``1..n_receivers`` are the
    receivers, in the distributor's order (sorted replica names,
    ``route_for``).  The three kinds are one arithmetic family over the
    *effective* fan-out ``fanout``: the children of slot ``s`` are slots
    ``fanout*s + 1 .. fanout*s + fanout`` (clipped to ``n_receivers``), a
    k-ary heap rooted at the trainer.  ``star`` is ``fanout ==
    n_receivers`` (depth 1), ``pipeline`` is ``fanout == 1`` (a chain of
    depth n), ``tree`` anything between; ``compile.compile_broadcast_schedule``
    normalises a requested fan-out into this form.

    Every receiver of one schedule holds the same base version, so the
    encoded ``SyncUpdate`` is the same for all of them (the engine's
    per-(base, force) memo) and interior slots forward the received wire
    as it is: CRC-checked at every hop, never decoded and re-encoded."""

    kind: str
    fanout: int  # effective children per node (already normalised)
    n_receivers: int

    def __post_init__(self):
        if self.kind not in BROADCAST_KINDS:
            raise ValueError(f"unknown broadcast kind {self.kind!r}; "
                             f"expected one of {BROADCAST_KINDS}")
        if self.n_receivers < 0:
            raise ValueError(f"n_receivers must be >= 0, got {self.n_receivers}")
        if self.fanout < 1:
            raise ValueError(f"fanout must be >= 1, got {self.fanout}")
        if self.kind == BROADCAST_STAR and self.fanout < self.n_receivers:
            raise ValueError(f"star schedule needs fanout >= n_receivers, got "
                             f"{self.fanout} < {self.n_receivers}")
        if self.kind == BROADCAST_PIPELINE and self.fanout != 1:
            raise ValueError(f"pipeline schedule is fanout 1, got {self.fanout}")

    # -- topology (arithmetic; slot 0 = trainer) -----------------------------

    def parent_of(self, slot: int) -> int:
        if not 1 <= slot <= self.n_receivers:
            raise ValueError(f"slot {slot} outside 1..{self.n_receivers}")
        return (slot - 1) // self.fanout

    def children_of(self, slot: int) -> tuple:
        if not 0 <= slot <= self.n_receivers:
            raise ValueError(f"slot {slot} outside 0..{self.n_receivers}")
        lo = self.fanout * slot + 1
        return tuple(range(lo, min(lo + self.fanout, self.n_receivers + 1)))

    def hops_to(self, slot: int) -> int:
        """Wire hops from the trainer to ``slot`` (root children: 1)."""
        h = 0
        while slot > 0:
            slot = (slot - 1) // self.fanout
            h += 1
        return h

    @property
    def depth(self) -> int:
        """Hops to the deepest receiver (star 1, pipeline n)."""
        return self.hops_to(self.n_receivers) if self.n_receivers else 0

    @property
    def root_degree(self) -> int:
        """The trainer's own sends a broadcast: the egress multiplier that
        tree and pipeline shrink (star: n_receivers)."""
        return len(self.children_of(0))

    @property
    def n_edges(self) -> int:
        """Wire sends a broadcast: every receiver is the target of exactly
        one edge, whatever the kind."""
        return self.n_receivers

    def edges(self) -> tuple:
        """``((parent_slot, child_slot), ...)`` in slot order."""
        return tuple((self.parent_of(s), s) for s in range(1, self.n_receivers + 1))

    def levels(self) -> tuple:
        """Edges grouped by hop depth: level h (1-based) holds the edges whose
        target is h hops from the trainer, the in-mesh lowering order
        (``sched/executor.wsync_hop_perms``)."""
        by_depth: dict = {}
        for p, c in self.edges():
            by_depth.setdefault(self.hops_to(c), []).append((p, c))
        return tuple(tuple(by_depth[h]) for h in sorted(by_depth))

    def route_for(self, names) -> tuple:
        """The slot topology on concrete receiver names: the trainer's own
        sends as ``((name, subroute), ...)``, where ``subroute`` has the same
        form for that receiver's subtree.  ``names`` must hold exactly
        ``n_receivers`` entries (slot ``i + 1`` is ``names[i]``): a schedule
        compiled for another fleet size raises instead of mis-routing."""
        names = tuple(names)
        if len(names) != self.n_receivers:
            raise ValueError(f"stale broadcast schedule: compiled for "
                             f"{self.n_receivers} receivers, routing {len(names)}")

        def sub(slot):
            return (names[slot - 1], tuple(sub(c) for c in self.children_of(slot)))

        return tuple(sub(c) for c in self.children_of(0))


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static schedule for ONE flat bucket (one wire, or one two-shot pair).

    ``members`` lists the pytree leaves fused into the bucket as
    ``(flat_leaf_index, shape, size)`` in tree order.  ``chunk`` is the
    per-rank chunk length of the reduce-scatter grid (``padded / n_dev``;
    the all-gather phase reuses it); for ``all_gather``, ``kv`` and
    ``wsync`` plans it is the block-padded length of one send.
    ``wire_bytes``/``raw_bytes`` are the expected per-execution wire
    accounting (static: wire shapes do not depend on data), the sums of the
    collectives' WireReports."""

    dtype_name: str
    members: tuple  # ((leaf_index, shape, size), ...)
    length: int  # unpadded element count of the concatenated bucket
    path: str  # one of the PATH_* constants
    width: int = 0  # exponent width of the send phase
    ag_width: int = 0  # exponent width of the AG phase (two-shot only)
    block: int = 512
    exc_frac: float = 0.02
    fused: bool = True  # fused decode+reduce receive
    encode_fused: bool = True  # fused one-pass split+pack transmit
    n_dev: int = 1
    chunk: int = 0
    wire_bytes: int = 0  # expected compressed wire bytes per execution
    raw_bytes: int = 0  # uncompressed bytes the same wires would move
    # XOR-delta schedule (kind "wsync" only): the exponent-delta and lo-delta
    # widths and the expected delta wire bytes.  delta_width == 0: the bucket
    # is not delta-eligible and always rides the full send.
    delta_width: int = 0
    delta_lo_width: int = 0
    delta_wire_bytes: int = 0
    # compressibility probe, when the compiler calibrated the width from live
    # data (``sample=``): (est_exc_rate, est_ratio, entropy_bits), else None
    probe: tuple | None = None

    @property
    def ratio(self) -> float:
        return self.wire_bytes / max(self.raw_bytes, 1)

    @property
    def compressed(self) -> bool:
        return self.path in (PATH_TWO_SHOT, PATH_RING, PATH_COMPRESSED)


@dataclasses.dataclass(frozen=True)
class PhasePair:
    """ZeRO-1 bucket schedule: the RS (gradient-class) and AG (weight-class)
    phases of one dtype bucket carry different widths and are gated on
    different byte counts, so each gets its own BucketPlan."""

    rs: BucketPlan
    ag: BucketPlan


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """A compiled communication plan for one wire signature.

    ``kind``: "psum" (pytree two-shot or ring all-reduce), "reduce_scatter"
    and "all_gather" (flat single-bucket phases), "zero1" (per-dtype RS/AG
    ``PhasePair``s with the optimizer update between), "fsdp_gather" (one
    FSDP leaf's weight all-gather, ``ag_width``, and its gradient
    reduce-scatter, ``width``, in one ``BucketPlan``), "kv" (a KV-cache
    pytree shipped leaf-bucketed over the P2P pipeline) or
    "wsync" (a versioned weight pytree sent to replicas with per-bucket
    XOR-delta-vs-full gating, the delta schedule in each ``BucketPlan``) or
    "p2p" (one tensor over the P2P pipeline, ``core/split_send.p2p_send``).
    ``backend``/``use_kernels`` record the device and whether its wires run
    the CUDA kernels (``compile.probe_backend``).  ``raw_leaf_ix`` are
    leaves outside every bucket (not a codec float, or 0-d for "kv"): summed
    with ``psum_safe`` (kind "psum") or moved as they are.  ``strategy`` is
    the P2P pipeline of "p2p", "kv" and "wsync" plans ("split_send",
    "encode_send" or "chunked"); empty for the collectives.  ``broadcast``
    is the fan-out topology of a "wsync" plan compiled for a fleet size
    (``BroadcastSchedule``); None for every other kind and for wsync plans
    that hold no receiver count."""

    key: tuple  # the cache key this plan was compiled under (hashable)
    kind: str
    axis: tuple  # axis name(s) of the wire
    n_dev: int
    backend: str
    use_kernels: bool
    buckets: tuple  # BucketPlans (PhasePairs for kind "zero1")
    raw_leaf_ix: tuple = ()
    n_leaves: int = 0
    strategy: str = ""  # P2P pipeline (kinds "p2p", "kv", "wsync")
    broadcast: BroadcastSchedule | None = None  # kind "wsync" only

    def _flat_buckets(self):
        for b in self.buckets:
            if isinstance(b, PhasePair):
                yield b.rs
                yield b.ag
            else:
                yield b

    @property
    def wire_bytes(self) -> int:
        """Expected compressed wire bytes of one plan execution."""
        return sum(b.wire_bytes for b in self._flat_buckets() if b.compressed)

    @property
    def raw_bytes(self) -> int:
        return sum(b.raw_bytes for b in self._flat_buckets() if b.compressed)

    @property
    def ratio(self) -> float:
        return self.wire_bytes / max(self.raw_bytes, 1)

    @property
    def delta_wire_bytes(self) -> int:
        """Expected wire bytes of one all-delta execution (kind "wsync"):
        delta-eligible buckets ship deltas, the rest their full wires."""
        return sum(b.delta_wire_bytes if b.delta_width else b.wire_bytes
                   for b in self._flat_buckets() if b.compressed)

    def width_for_dtype(self, dtype_name: str) -> int | None:
        """Recorded send-phase codec width of the first compressed bucket
        of ``dtype_name``, or None when that dtype rides a raw path.  The
        host ``p2p/engine.Compressor`` reads it instead of probing."""
        for b in self._flat_buckets():
            if b.dtype_name == dtype_name and b.compressed:
                return b.width
        return None

    def summary(self) -> dict:
        return {
            "kind": self.kind,
            "axis": self.axis,
            "n_dev": self.n_dev,
            "backend": self.backend,
            "use_kernels": self.use_kernels,
            "n_buckets": len(self.buckets),
            "n_raw_leaves": len(self.raw_leaf_ix),
            "strategy": self.strategy,
            "paths": tuple(b.path for b in self._flat_buckets()),
            "n_encode_fused": sum(1 for b in self._flat_buckets()
                                  if b.compressed and b.encode_fused),
            "n_delta": sum(1 for b in self._flat_buckets()
                           if b.compressed and b.delta_width),
            "wire_bytes": self.wire_bytes,
            "raw_bytes": self.raw_bytes,
            "ratio": self.ratio,
            "delta_wire_bytes": self.delta_wire_bytes,
            "broadcast": (None if self.broadcast is None else
                          (self.broadcast.kind, self.broadcast.fanout,
                           self.broadcast.n_receivers)),
        }


def policy_fingerprint(policy, tensor_class: str = "gradient") -> tuple:
    """Hashable fingerprint of every policy field a plan depends on: part of
    the cache key, so any knob change misses and recompiles."""
    prof = policy.profile
    return (
        bool(policy.enabled),
        int(policy.min_bytes),
        tuple(policy.compress_axes),
        tuple(policy.raw_axes),
        str(policy.allreduce_algorithm),
        bool(policy.fused_decode_reduce),
        bool(policy.fused_encode),
        tuple(sorted(prof.widths.items())),
        int(prof.block),
        float(prof.exc_frac),
        int(prof.ag_extra_bits),
        str(tensor_class),
    )


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the numpy/JAX name of a dtype."""
    return str(dtype).removeprefix("torch.")


def tree_signature(tree) -> tuple:
    """Hashable structural signature of a pytree: structure + per-leaf
    (shape, dtype name)."""
    leaves, treedef = tree_flatten(tree)
    sig = tuple(
        (tuple(getattr(leaf, "shape", ())),
         dtype_name(leaf.dtype) if isinstance(leaf, torch.Tensor)
         else type(leaf).__name__)
        for leaf in leaves)
    return (treedef, sig)
