"""Process-wide metrics registry: counters, gauges, histograms (torch port
of ``repro.obs.metrics``).

Every runtime layer records into one thread-safe registry —
counters (monotonic totals: wire bytes, plan executions, retries),
gauges (last-value state: queue depth, cache size, version lag) and
histograms with FIXED bucket boundaries (latencies — fixed bounds keep
snapshots mergeable across processes and runs).

Metrics are labeled: a metric is created once with its label NAMES
(``counter("wire_bytes_total", labels=("kind",))``) and each observation
supplies the label VALUES (``.inc(n, kind="psum")``); every label
combination is an independent series.  Re-requesting a name returns the
same metric object; re-requesting it with a different type or label set
raises (names are a contract — see ``obs/names.py`` for the canonical
table, held equal to the reference's by ``tests/test_torch_obs.py``).

``snapshot()`` returns a plain nested dict (JSON-safe) so benchmarks and
the dump CLI can persist it; ``to_markdown()`` renders the human view.
Instrumented call sites go through ``names.metric``, which short-circuits
to :data:`NOOP_METRIC` when ``REPRO_OBS=0``.
"""
from __future__ import annotations

import json
import threading
from typing import Optional


class _NoopMetric:
    """Absorbs every mutator — what instrumentation gets when obs is off."""

    __slots__ = ()

    def inc(self, value=1, **labels):
        pass

    def dec(self, value=1, **labels):
        pass

    def set(self, value, **labels):
        pass

    def observe(self, value, **labels):
        pass


NOOP_METRIC = _NoopMetric()

# Latency buckets (seconds): 100 µs .. 30 s, roughly 1-3-10 spaced — wide
# enough for trace-time plan replays and CPU train steps alike.
DEFAULT_TIME_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3,
                        1.0, 3.0, 10.0, 30.0)


class _Metric:
    """Shared plumbing: label validation + per-series storage."""

    kind = "abstract"

    def __init__(self, name: str, labels: tuple, help: str,
                 lock: threading.RLock):
        self.name = name
        self.label_names = tuple(labels)
        self.help = help
        self._lock = lock
        self._series: dict = {}

    def _key(self, labels: dict) -> str:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return ",".join(f"{k}={labels[k]}" for k in self.label_names)

    def series(self) -> dict:
        """{label-string: value} snapshot of every series."""
        with self._lock:
            return dict(self._series)


class Counter(_Metric):
    """Monotonic total.  ``inc`` only; negative increments raise."""

    kind = "counter"

    def inc(self, value=1, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name!r}: negative inc {value}")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value


class Gauge(_Metric):
    """Last-value state; settable up and down."""

    kind = "gauge"

    def set(self, value, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = value

    def inc(self, value=1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def dec(self, value=1, **labels) -> None:
        self.inc(-value, **labels)


class Histogram(_Metric):
    """Fixed-boundary histogram: per-bucket counts + count + sum.

    Buckets are NON-cumulative in the snapshot (each holds observations
    ``bound[i-1] < v <= bound[i]``; the final ``+Inf`` bucket catches the
    rest) — fixed boundaries make snapshots from different runs directly
    comparable."""

    kind = "histogram"

    def __init__(self, name, labels, help, lock,
                 buckets=DEFAULT_TIME_BUCKETS):
        super().__init__(name, labels, help, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {self.name!r} needs >= 1 bucket")

    def observe(self, value, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "count": 0, "sum": 0.0}
            i = 0
            for i, b in enumerate(self.buckets):
                if value <= b:
                    break
            else:
                i = len(self.buckets)
            s["counts"][i] += 1
            s["count"] += 1
            s["sum"] += float(value)

    def series(self) -> dict:
        with self._lock:
            out = {}
            for key, s in self._series.items():
                buckets = {f"le={b:g}": c
                           for b, c in zip(self.buckets, s["counts"])}
                buckets["le=+Inf"] = s["counts"][-1]
                out[key] = {"count": s["count"], "sum": s["sum"],
                            "buckets": buckets}
            return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe name -> metric store with get-or-create semantics."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: dict = {}

    def _get_or_create(self, kind: str, name: str, labels: tuple,
                       help: str, **kw):
        labels = tuple(labels)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.label_names != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}"
                        f"{m.label_names}, requested {kind}{labels}")
                return m
            m = _KINDS[kind](name, labels, help, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, *, labels=(), help: str = "") -> Counter:
        return self._get_or_create("counter", name, labels, help)

    def gauge(self, name: str, *, labels=(), help: str = "") -> Gauge:
        return self._get_or_create("gauge", name, labels, help)

    def histogram(self, name: str, *, labels=(), help: str = "",
                  buckets=DEFAULT_TIME_BUCKETS) -> Histogram:
        return self._get_or_create("histogram", name, labels, help,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._metrics))

    def reset(self) -> None:
        """Drop every metric (tests / dump-CLI run isolation)."""
        with self._lock:
            self._metrics.clear()

    # -- exporters -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain nested dict: {kind+'s': {name: {label-string: value}}}."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            out[m.kind + "s"][m.name] = m.series()
        return out

    def to_json(self, **json_kw) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, **json_kw)

    def to_markdown(self) -> str:
        """One table row per (metric, series): | name | type | labels | value |."""
        lines = ["| metric | type | labels | value |", "|---|---|---|---|"]
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        for m in metrics:
            for key, val in sorted(m.series().items()):
                if m.kind == "histogram":
                    val = (f"count={val['count']} sum={val['sum']:.4g}")
                elif isinstance(val, float):
                    val = f"{val:.6g}"
                lines.append(f"| {m.name} | {m.kind} | {key or '-'} | {val} |")
        return "\n".join(lines)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-default registry every instrumented module records into."""
    return _REGISTRY


def snapshot() -> dict:
    return _REGISTRY.snapshot()
