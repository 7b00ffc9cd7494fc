"""Flight recorder: bounded step-indexed time series per metric series
(torch port of ``repro.obs.recorder``).

The registry answers "what is the value now"; the recorder answers "what
were the last N observations" — ``names.metric`` tees every observation
(counter inc, gauge set, histogram observe) into a bounded ring per
series, stamped with a process-global step index, so "wire ratio for
plan:wsync over the last 200 executions" is a :meth:`FlightRecorder.window`
query instead of a re-instrumentation.

Series keys mirror the registry's: ``<metric name>`` for label-less
series, ``<metric name>|k=v,k2=v2`` with labels in the spec's declared
order.  Rings are per-series deques under one lock — recording is an
append plus an int increment, cheap enough to sit on every emit path —
and the whole module is inert when ``REPRO_OBS=0`` (``names.metric``
returns the no-op metric, which never reaches :func:`record`).

Env knobs:
  * ``REPRO_OBS_RING_CAP`` — samples retained per series (default 1024).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading

DEFAULT_RING_CAPACITY = int(os.environ.get("REPRO_OBS_RING_CAP", "1024"))

_SPARK = "▁▂▃▄▅▆▇█"


@dataclasses.dataclass(frozen=True)
class Sample:
    step: int  # process-global observation index (cross-series ordering)
    value: float


@dataclasses.dataclass(frozen=True)
class WindowStats:
    """Summary of the most recent ``count`` samples of one series."""
    series: str
    count: int
    total: float
    mean: float
    minimum: float
    maximum: float
    p50: float
    p90: float
    p99: float
    first_step: int
    last_step: int
    last: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _quantile(ordered: list, q: float) -> float:
    """Nearest-rank-with-interpolation quantile of a pre-sorted list."""
    if len(ordered) == 1:
        return ordered[0]
    pos = q * (len(ordered) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(ordered) - 1)
    frac = pos - lo
    return ordered[lo] * (1 - frac) + ordered[hi] * frac


class FlightRecorder:
    """Thread-safe bounded ring of step-indexed samples per series."""

    def __init__(self, capacity: int = None):
        self._capacity = DEFAULT_RING_CAPACITY if capacity is None else capacity
        self._lock = threading.Lock()
        self._rings: dict = {}  # series key -> deque[Sample]
        self._step = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    @staticmethod
    def series_key(name: str, labels_key: str = "") -> str:
        return f"{name}|{labels_key}" if labels_key else name

    def record(self, name: str, value, labels_key: str = "") -> int:
        """Append one observation; returns the step index it was stamped
        with.  ``labels_key`` is the registry's series key (label values in
        declared order, ``k=v`` comma-joined) or "" for label-less series."""
        key = self.series_key(name, labels_key)
        with self._lock:
            self._step += 1
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = collections.deque(
                    maxlen=self._capacity)
            ring.append(Sample(self._step, float(value)))
            return self._step

    def series(self) -> tuple:
        """All series keys currently holding samples, sorted."""
        with self._lock:
            return tuple(sorted(self._rings))

    def samples(self, name: str, *, n: int = None, labels_key: str = None,
                **labels) -> tuple:
        """The last ``n`` (default: all retained) samples of one series.

        Labels may be given either pre-joined (``labels_key="kind=psum"``)
        or as keywords (``kind="psum"``), which are joined in the metric
        spec's declared order."""
        if labels and labels_key is not None:
            raise ValueError("pass labels_key OR label kwargs, not both")
        if labels:
            labels_key = self._labels_key(name, labels)
        key = self.series_key(name, labels_key or "")
        with self._lock:
            ring = self._rings.get(key)
            out = tuple(ring) if ring else ()
        return out[-n:] if n is not None else out

    def window(self, name: str, *, n: int = None, labels_key: str = None,
               **labels):
        """Windowed stats (sum/mean/min/max/p50/p90/p99) over the last
        ``n`` samples, or ``None`` if the series is empty."""
        got = self.samples(name, n=n, labels_key=labels_key, **labels)
        if not got:
            return None
        vals = [s.value for s in got]
        ordered = sorted(vals)
        key = self.series_key(
            name, labels_key or (self._labels_key(name, labels)
                                 if labels else ""))
        return WindowStats(
            series=key, count=len(vals), total=sum(vals),
            mean=sum(vals) / len(vals), minimum=ordered[0],
            maximum=ordered[-1], p50=_quantile(ordered, 0.50),
            p90=_quantile(ordered, 0.90), p99=_quantile(ordered, 0.99),
            first_step=got[0].step, last_step=got[-1].step,
            last=vals[-1])

    def snapshot(self, *, n: int = None) -> dict:
        """JSON-safe per-series window stats (report/export surface)."""
        out = {}
        for key in self.series():
            name, _, labels_key = key.partition("|")
            st = self.window(name, n=n, labels_key=labels_key)
            if st is not None:
                out[key] = st.to_dict()
        return out

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()
            self._step = 0

    @staticmethod
    def _labels_key(name: str, labels: dict) -> str:
        from repro_torch.obs import names as names_lib  # late: recorder is a leaf
        spec = names_lib.SPECS[name]
        if set(labels) != set(spec.labels):
            raise ValueError(
                f"series {name!r} wants labels {spec.labels}, got "
                f"{tuple(labels)}")
        return ",".join(f"{k}={labels[k]}" for k in spec.labels)


def sparkline(values) -> str:
    """Unicode sparkline of a value sequence (report tables)."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi - lo <= 0:
        return _SPARK[0] * len(vals)
    top = len(_SPARK) - 1
    return "".join(
        _SPARK[min(int((v - lo) / (hi - lo) * top + 0.5), top)]
        for v in vals)


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    """The process-default flight recorder (fed by ``names.metric``)."""
    return _RECORDER


def record(name: str, value, labels_key: str = "") -> int:
    return _RECORDER.record(name, value, labels_key)
