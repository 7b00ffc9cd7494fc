"""Per-bucket wire ledger + width-regret analytics (torch port of
``repro.obs.regret``).

Two data sources, one question — "are the frozen widths still the right
widths?":

* **Ledger** — the executor/p2p/sync paths record per-bucket
  ``bucket_wire_bytes_total`` / ``bucket_wire_raw_bytes_total`` counters
  labeled (kind, dtype, width).  For plan-driven kinds the per-kind ledger
  sums are EXACTLY the consolidated ``plan:<kind>`` WireReport sums (the
  executor forwards every bucket capture into the plan capture), so
  :func:`check_ledger_exactness` can assert the ledger against
  ``roofline.summarize_wire_reports`` byte-for-byte.  Host paths ledger
  under their own kinds (``wsync_host``, ``p2p_host``) so the exactness
  check over plan kinds stays exact under mixed workloads.

* **Samples** — the host encode paths (sync ``_encode_update``, p2p
  ``Compressor.encode``) deposit bounded, stride-downsampled copies of
  their payloads here.  :func:`width_regret` re-runs
  ``calibrate.choose_width`` / ``choose_delta_widths`` offline on those
  samples and prices the gap: *regret* = achieved wire bytes − (optimal
  predicted ratio × achieved raw bytes), per (kind, dtype).

The sample store strides on the payload's own device and copies at most
:data:`SAMPLE_MAX_ELEMS` values to the host, where the reference copies the
whole bucket first; the sampled values are the same.  Samples are CPU
tensors of the payload's dtype (bf16 and fp8 included, which numpy lacks).

Disabled mode (``REPRO_OBS=0``): :func:`record_sample` is a no-op and
the ledger counters were never emitted.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import config

SAMPLE_CAPACITY = 8       # recent samples retained per (kind, dtype)
SAMPLE_MAX_ELEMS = 1 << 16  # stride-downsample bound per sample

LEDGER_METRICS = ("bucket_wire_bytes_total", "bucket_wire_raw_bytes_total")


@dataclasses.dataclass(frozen=True)
class _Sample:
    x: torch.Tensor                # flattened (possibly strided) CPU copy
    base: Optional[torch.Tensor]   # delta-wire base twin, or None
    elems: int                     # pre-downsample element count


def _flat(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.detach().reshape(-1)


def _host_copy(flat: torch.Tensor, stride: int) -> torch.Tensor:
    """Every ``stride``-th value of ``flat`` as a new CPU tensor: the stride
    is taken on ``flat``'s device, so only the kept values cross to the
    host."""
    return flat[::stride].clone(memory_format=torch.contiguous_format).cpu()


class _SampleStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._store: dict = {}  # (kind, dtype_name) -> deque[_Sample]

    def record(self, kind: str, dtype_name: str, x, base=None) -> None:
        x = _flat(x)
        elems = x.numel()
        stride = -(-elems // SAMPLE_MAX_ELEMS) if elems > SAMPLE_MAX_ELEMS else 1
        # the base keeps its element pairing with x for the delta
        s = _Sample(x=_host_copy(x, stride),
                    base=None if base is None else _host_copy(_flat(base), stride),
                    elems=elems)
        with self._lock:
            ring = self._store.get((kind, dtype_name))
            if ring is None:
                ring = self._store[(kind, dtype_name)] = collections.deque(
                    maxlen=SAMPLE_CAPACITY)
            ring.append(s)

    def items(self) -> dict:
        with self._lock:
            return {k: tuple(v) for k, v in self._store.items()}

    def clear(self) -> None:
        with self._lock:
            self._store.clear()


_STORE = _SampleStore()


def record_sample(kind: str, dtype_name: str, x, base=None) -> None:
    """Deposit a bounded host copy of one bucket's payload (and its delta
    base, when the wire is a delta) for offline re-calibration."""
    if not config.enabled():
        return
    _STORE.record(kind, dtype_name, x, base)


def samples() -> dict:
    """(kind, dtype) -> retained samples, newest last."""
    return _STORE.items()


def clear_samples() -> None:
    _STORE.clear()


def _parse_series_key(key: str) -> tuple:
    labels = dict(p.split("=", 1) for p in key.split(",") if "=" in p)
    return labels["kind"], labels["dtype"], int(labels["width"])


def ledger_totals() -> dict:
    """The per-bucket wire ledger, read back from the registry counters.

    Returns ``{"by_bucket": {(kind, dtype, width): {raw_bytes, wire_bytes,
    ratio}}, "by_kind": {kind: {...}}}``."""
    from repro_torch import obs

    snap = obs.registry().snapshot()
    counters = snap.get("counters", {})
    wire = counters.get("bucket_wire_bytes_total", {})
    raw = counters.get("bucket_wire_raw_bytes_total", {})
    by_bucket: dict = {}
    for key in set(wire) | set(raw):
        bk = _parse_series_key(key)
        w, r = int(wire.get(key, 0)), int(raw.get(key, 0))
        by_bucket[bk] = {"raw_bytes": r, "wire_bytes": w,
                         "ratio": w / max(r, 1)}
    by_kind: dict = {}
    for (kind, _, _), v in by_bucket.items():
        agg = by_kind.setdefault(kind, {"raw_bytes": 0, "wire_bytes": 0})
        agg["raw_bytes"] += v["raw_bytes"]
        agg["wire_bytes"] += v["wire_bytes"]
    for agg in by_kind.values():
        agg["ratio"] = agg["wire_bytes"] / max(agg["raw_bytes"], 1)
    return {"by_bucket": by_bucket, "by_kind": by_kind}


def check_ledger_exactness(reports) -> dict:
    """Assertable agreement between the per-bucket ledger and the
    consolidated plan WireReports.

    ``reports`` is the wire-report list captured over the SAME window the
    ledger accumulated (``obs.reset()`` inside one
    ``policy.capture_wire_reports()``).  Every ``plan:<kind>`` name in
    ``roofline.summarize_wire_reports(reports)`` must match the per-kind
    ledger sums byte-for-byte, and vice versa — the executor forwards each
    bucket capture into the plan capture, so any diff is an accounting
    bug, not noise.  Returns ``{"ok", "diffs", "summary", "ledger"}``."""
    from repro_torch.roofline.analysis import summarize_wire_reports
    from repro_torch.sched.compile import PLAN_KINDS

    plan_reports = [r for r in reports if r.name.startswith("plan:")]
    summ = summarize_wire_reports(plan_reports)
    ledger = ledger_totals()
    by_kind = ledger["by_kind"]
    diffs: dict = {}
    for name, d in (summ.get("by_name") or {}).items():
        kind = name.split(":", 1)[1]
        led = by_kind.get(kind, {"raw_bytes": 0, "wire_bytes": 0})
        if (led["raw_bytes"], led["wire_bytes"]) != (d["raw_bytes"],
                                                     d["wire_bytes"]):
            diffs[kind] = {"ledger": (led["raw_bytes"], led["wire_bytes"]),
                           "reports": (d["raw_bytes"], d["wire_bytes"])}
    for kind, led in by_kind.items():
        if kind in PLAN_KINDS and f"plan:{kind}" not in (
                summ.get("by_name") or {}):
            diffs[kind] = {"ledger": (led["raw_bytes"], led["wire_bytes"]),
                           "reports": None}
    return {"ok": not diffs, "diffs": diffs, "summary": summ,
            "ledger": ledger}


@dataclasses.dataclass(frozen=True)
class RegretRow:
    """Achieved-vs-optimal wire pricing for one (kind, dtype) bucket set."""
    kind: str
    dtype_name: str
    achieved_width: int        # dominant ledger width (0 = raw/rANS path)
    optimal_width: int         # choose_width on the recent samples
    achieved_raw_bytes: int
    achieved_wire_bytes: int
    optimal_wire_bytes: int    # optimal est_ratio x achieved raw bytes
    regret_bytes: int          # achieved - optimal (can be < 0: est error)
    regret_frac: float         # regret / raw
    est_exc_rate: float        # at the optimal width
    entropy_bits: float        # ANS floor on the sampled exponents
    optimal_delta_widths: tuple  # (exp, lo) when delta-base samples exist
    n_samples: int

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["optimal_delta_widths"] = (
            None if self.optimal_delta_widths is None
            else list(self.optimal_delta_widths))
        return d


def width_regret(*, block: int = 512, target_exc_rate: float = 1e-3,
                 max_exc_frac: float = 0.02) -> tuple:
    """Re-calibrate on the recent samples and price every sampled (kind,
    dtype) bucket set: achieved wire bytes (ledger) vs what the freshly
    chosen width predicts for the same raw bytes.  Sorted worst-first."""
    from repro_torch.core import calibrate

    totals = ledger_totals()["by_bucket"]
    rows = []
    for (kind, dtype_name), entries in _STORE.items().items():
        achieved = [(w, v) for (k, d, w), v in totals.items()
                    if k == kind and d == dtype_name]
        if not achieved or not entries:
            continue
        a_raw = sum(v["raw_bytes"] for _, v in achieved)
        a_wire = sum(v["wire_bytes"] for _, v in achieved)
        if a_raw <= 0:
            continue
        choice = calibrate.choose_width(
            torch.cat([e.x for e in entries]), block=block,
            target_exc_rate=target_exc_rate, max_exc_frac=max_exc_frac)
        opt_wire = int(round(choice.est_ratio * a_raw))
        delta_pair = next(
            (e for e in reversed(entries) if e.base is not None), None)
        d_widths = None
        if delta_pair is not None:
            d_widths = calibrate.choose_delta_widths(
                delta_pair.x, delta_pair.base, block=block,
                target_exc_rate=target_exc_rate, max_exc_frac=max_exc_frac)
        dominant = max(achieved, key=lambda t: t[1]["wire_bytes"])[0]
        rows.append(RegretRow(
            kind=kind, dtype_name=dtype_name, achieved_width=dominant,
            optimal_width=choice.width, achieved_raw_bytes=a_raw,
            achieved_wire_bytes=a_wire, optimal_wire_bytes=opt_wire,
            regret_bytes=a_wire - opt_wire,
            regret_frac=(a_wire - opt_wire) / a_raw,
            est_exc_rate=choice.est_exc_rate,
            entropy_bits=choice.entropy_bits,
            optimal_delta_widths=d_widths, n_samples=len(entries)))
    return tuple(sorted(rows, key=lambda r: -r.regret_bytes))
