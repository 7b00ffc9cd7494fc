"""Selective-compression policy and wire accounting (torch port of
``repro.core.policy``).

Compression applies only to codec-supported floats above ``min_bytes``
(paper: 1 MB) on data-parallel wires.  Every compressed collective records a
:class:`WireReport` with its raw and wire bytes into the innermost open
:func:`capture_wire_reports` of its thread, or, outside any capture, into
the module ledger that :func:`wire_reports` reads and
:func:`clear_wire_reports` empties.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading

import torch

from repro_torch.core import codec
from repro_torch.core.calibrate import CompressionProfile


ALLREDUCE_ALGORITHMS = ("two_shot", "ring")


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    enabled: bool = True
    min_bytes: int = 1 << 20  # paper: 1 MB threshold
    compress_axes: tuple = ("data", "pod")  # DP/DCN wires
    raw_axes: tuple = ("model",)  # TP/EP activation wires default raw
    profile: CompressionProfile = dataclasses.field(
        default_factory=lambda: CompressionProfile.default())
    # The reference's algorithm and fusion knobs, with its defaults; they
    # enter a plan's key (``sched/plan.policy_fingerprint``).
    # ``allreduce_algorithm``: "two_shot" (the paper's, RS + AG) or "ring"
    # (the paper's negative baseline, a codec pass per hop).
    # ``fused_decode_reduce``: the receive side of a reduce streams each
    # chunk through the fused decode+reduce kernel; False decodes first and
    # sums after.  ``fused_encode``: every send encodes in one pass
    # (encode_fused); False splits the planes and packs them (the pack
    # kernel).  Both knobs give the same bits either way.
    allreduce_algorithm: str = "two_shot"
    fused_decode_reduce: bool = True
    fused_encode: bool = True

    def __post_init__(self):
        if self.allreduce_algorithm not in ALLREDUCE_ALGORITHMS:
            raise ValueError(f"unknown allreduce_algorithm "
                             f"{self.allreduce_algorithm!r}; expected one of "
                             f"{ALLREDUCE_ALGORITHMS}")

    def should_compress(self, x: torch.Tensor, axis_name="data", *,
                        tensor_class: str = "gradient") -> bool:
        if not self.enabled:
            return False
        if x.dtype not in (lay.dtype for lay in codec.LAYOUTS.values()):
            return False
        if x.numel() * x.element_size() < self.min_bytes:
            return False
        names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        return all(n in self.compress_axes for n in names)

    def width_for(self, tensor_class: str) -> int:
        return self.profile.width_for(tensor_class)

    def delta_widths(self, dtype_name: str) -> tuple:
        """(exp_width, lo_width) of the XOR-delta wire for ``dtype_name``:
        the profile's ``"delta"`` / ``"delta_lo"`` widths (defaults 2 and 4,
        aimed at warm deltas one small optimizer step apart), clamped to
        ``[1, exp_bits]`` and ``[1, lo_bits]``.  They enter the plan key
        through ``profile.widths``."""
        lay = codec.LAYOUTS[dtype_name]
        w = int(self.profile.widths.get("delta", 2))
        wl = int(self.profile.widths.get("delta_lo", 4))
        return (max(1, min(w, lay.exp_bits)), max(1, min(wl, lay.lo_bits)))

    @staticmethod
    def disabled() -> "CompressionPolicy":
        return CompressionPolicy(enabled=False)


@dataclasses.dataclass(frozen=True)
class WireReport:
    """Accounting record of one compressed wire.

    ``decode_hbm_bytes`` is the decoded-float round-trip an UNFUSED receive
    side would pay between decode and reduce (8 B/element); ``fused`` says
    it was eliminated.  ``encode_hbm_bytes`` is the transmit-side mirror:
    the split-plane round-trip an unfused encode would pay
    (``2 * (1 + itemsize)`` B/element); ``encode_fused`` says it was
    eliminated.  A collective whose decode output is its result (all-gather,
    all-to-all, ppermute) has no reduce to fuse (``fused=False``,
    ``decode_hbm_bytes=0``), as in the reference."""

    name: str
    axis: str
    raw_bytes: int
    wire_bytes: int
    fused: bool = False
    decode_hbm_bytes: int = 0
    encode_fused: bool = False
    encode_hbm_bytes: int = 0

    @property
    def ratio(self) -> float:
        return self.wire_bytes / max(self.raw_bytes, 1)


# The module ledger, shared by every thread: a report made outside any
# capture lands here, as in the reference.  The reference records once per
# jit trace, the port once per call, so the ledger keeps only the newest
# WIRE_LEDGER_CAP reports (a long run would otherwise grow it every step).
# Captures stack per thread, so a capture opened in one thread never
# swallows another thread's reports.
WIRE_LEDGER_CAP = 1 << 14
_WIRE_REPORTS: collections.deque = collections.deque(maxlen=WIRE_LEDGER_CAP)
_SINK_STACKS = threading.local()


def _sinks() -> list:
    stack = getattr(_SINK_STACKS, "stack", None)
    if stack is None:
        stack = _SINK_STACKS.stack = []
    return stack


def record_wire_report(report: WireReport) -> None:
    """Append a report to the calling thread's innermost capture, else to
    the module ledger (called by the collectives)."""
    stack = _sinks()
    (stack[-1] if stack else _WIRE_REPORTS).append(report)


def clear_wire_reports() -> None:
    _WIRE_REPORTS.clear()


def wire_reports() -> tuple:
    """The ledger's reports (recorded outside any capture since the last
    clear, the newest ``WIRE_LEDGER_CAP`` of them), in emission order."""
    return tuple(_WIRE_REPORTS)


@contextlib.contextmanager
def capture_wire_reports():
    """Collect the calling thread's wire reports into a list; they do not
    reach the module ledger.  Nestable."""
    sink: list = []
    stack = _sinks()
    stack.append(sink)
    try:
        yield sink
    finally:
        stack.pop()


def current_sinks() -> list:
    """The calling thread's capture stack, to hand to :func:`report_into`."""
    return _sinks()


@contextlib.contextmanager
def report_into(stack: list):
    """Send the calling thread's wire reports to ``stack``, another thread's
    capture stack (:func:`current_sinks`), while active.  The autograd
    engine runs a CUDA graph's backward on a device thread of its own; the
    FSDP gather's reduce-scatter and a rematerialised layer's gathers run
    there while the thread that called ``backward`` waits, and report into
    that thread's capture."""
    prev = getattr(_SINK_STACKS, "stack", None)
    _SINK_STACKS.stack = stack
    try:
        yield
    finally:
        _SINK_STACKS.stack = prev
