"""Runtime observability: metrics registry + comm-span tracing + the
wire-efficiency observatory (torch port of ``repro.obs``).

The sensor layer of the plan runtime: a process-wide thread-safe metrics
registry (``metrics.py``), a nestable wall-clock span tracer with
Chrome-trace/Perfetto export (``trace.py``), the canonical metric/span
name tables (``names.py``, held equal to the reference's), and a dump CLI
(``python -m repro_torch.obs.dump``).

On top of the sensors sits the analysis layer:

  * ``recorder.py`` — a bounded step-indexed flight recorder per metric
    series, fed automatically by ``names.metric`` (windowed stats are a
    query, not a re-instrumentation);
  * ``regret.py``  — per-bucket wire ledger (exact against
    ``roofline.summarize_wire_reports``) + offline width-regret
    re-calibration on recent payload samples;
  * ``drift.py``   — live-vs-predicted wire-ratio drift detection with
    hysteresis (``wire_drift_events_total`` + ``DriftReport``).

Instrumented layers: ``sched/executor`` (plan spans + wire bytes/ratio per
kind, fed from the consolidated WireReports, plus the per-bucket ledger),
``sched/cache`` (hit/miss/eviction gauges + cache events), ``serve/engine``
(admission/prefill/decode spans, queue depth, tokens/step, KV-ship drift),
``sync/engine`` (publish/encode spans, delta-vs-full counts, per-replica
version lag, host-path ledger + drift), ``p2p/engine`` and
``runtime/fault_tolerance`` (stage/step spans + latency histograms),
``sync/fleet`` and ``runtime/faults`` (fleet protocol counters, injected
faults).

The port replays plans eagerly, so an executor's ``plan:<kind>`` span and
``plan_exec_total`` fire once per execution; the reference's fire once per
trace under ``jit``.  No call here synchronises the device: a span around
kernel launches reads the host's enqueue time unless the wrapped code waits
for the device itself.

Env knobs:
  * ``REPRO_OBS=0``       — every instrumentation call becomes a near-zero
    cost no-op (shared singletons, no allocation); no kernel launch and no
    result changes;
  * ``REPRO_TRACE_DIR``   — default Chrome-trace export directory;
  * ``REPRO_OBS_SPAN_CAP`` — span ring-buffer capacity (default 65536);
  * ``REPRO_OBS_RING_CAP`` — flight-recorder samples per series (1024).
"""
from repro_torch.obs import drift, regret
from repro_torch.obs.config import enabled, set_enabled
from repro_torch.obs.metrics import (DEFAULT_TIME_BUCKETS, NOOP_METRIC, MetricsRegistry,
                                     registry, snapshot)
from repro_torch.obs.names import METRICS, SPANS, SPECS, MetricSpec, metric
from repro_torch.obs.recorder import (FlightRecorder, Sample, WindowStats, recorder,
                                      sparkline)
from repro_torch.obs.trace import (NOOP_SPAN, SpanRecord, SpanTracer, clear_spans,
                                   export_chrome_trace, instant, span, spans, trace_dir,
                                   tracer)

__all__ = [
    "DEFAULT_TIME_BUCKETS", "FlightRecorder", "METRICS", "MetricSpec",
    "MetricsRegistry", "NOOP_METRIC", "NOOP_SPAN", "SPANS", "SPECS",
    "Sample", "SpanRecord", "SpanTracer", "WindowStats",
    "clear_observatory", "clear_spans", "drift", "enabled",
    "export_chrome_trace", "instant", "metric", "recorder", "regret",
    "registry", "reset", "set_enabled", "snapshot", "span", "sparkline",
    "spans", "trace_dir", "tracer",
]


def clear_observatory() -> None:
    """Drop the analysis layer's accumulated state — flight-recorder
    rings, drift-detector windows/events, regret payload samples — while
    KEEPING the metrics registry and span buffer."""
    recorder().clear()
    drift.reset()
    regret.clear_samples()


def reset() -> None:
    """Drop all recorded metrics, buffered spans, and observatory state
    (run isolation)."""
    registry().reset()
    clear_spans()
    clear_observatory()
