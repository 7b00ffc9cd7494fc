"""Canonical metric-name table + span naming convention (torch port of
``repro.obs.names``).

Every instrumented call site goes through :func:`metric`, which resolves a
name against this table — so an instrumentation typo fails loudly instead
of silently minting a new series, and the table IS the registry's emitted
name set.  ``tests/test_torch_obs.py`` holds :data:`SPECS` and
:data:`SPANS` equal to the reference's, but for the reference's
``kernel_fallback_total``: the port has no kernel fallback to count.

Span names follow ``<subsystem>:<operation>`` (e.g. ``plan:psum``,
``sync:encode``); :data:`SPANS` is the canonical list.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs import config
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import recorder as recorder_lib

# plan_wire_ratio_hist buckets: wire/raw, so the interesting mass is
# (0, 1]; >1 catches pathological expansion (tiny payload overheads)
RATIO_BUCKETS = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.4,
                 0.5, 0.65, 0.8, 1.0, 1.25)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str  # "counter" | "gauge" | "histogram"
    labels: tuple  # label NAMES; values supplied per observation
    module: str  # emitting module (repo-relative)
    help: str
    buckets: tuple = ()  # histograms only; () = DEFAULT_TIME_BUCKETS


METRICS = (
    # -- sched/executor.py: one record per plan execution, fed from the
    #    SAME consolidated WireReport the sink receives (totals agree with
    #    roofline.summarize_wire_reports by construction)
    MetricSpec("plan_exec_total", "counter", ("kind",),
               "sched/executor.py", "plan executions per plan kind"),
    MetricSpec("plan_wire_raw_bytes_total", "counter", ("kind",),
               "sched/executor.py",
               "bytes the plan-driven wires would move raw"),
    MetricSpec("plan_wire_bytes_total", "counter", ("kind",),
               "sched/executor.py",
               "packed bytes actually moved by plan-driven wires"),
    MetricSpec("plan_wire_ratio", "gauge", ("kind",),
               "sched/executor.py",
               "last consolidated wire ratio (wire/raw) per plan kind"),
    MetricSpec("plan_wire_ratio_hist", "histogram", ("kind",),
               "sched/executor.py",
               "distribution of consolidated wire ratios per plan kind",
               buckets=RATIO_BUCKETS),
    # -- per-bucket wire ledger (obs/regret.py reads it back): plan kinds
    #    sum EXACTLY to the consolidated plan:<kind> WireReports; host
    #    paths ledger under their own kinds (wsync_host, p2p_host)
    MetricSpec("bucket_wire_raw_bytes_total", "counter",
               ("kind", "dtype", "width"), "sched/executor.py",
               "per-bucket raw bytes, by (plan kind, dtype, width)"),
    MetricSpec("bucket_wire_bytes_total", "counter",
               ("kind", "dtype", "width"), "sched/executor.py",
               "per-bucket packed wire bytes, by (plan kind, dtype, width)"),
    # -- obs/drift.py
    MetricSpec("wire_drift_events_total", "counter", ("kind",),
               "obs/drift.py",
               "drift-detector firings (live ratio left the plan's "
               "compile-time prediction)"),
    # -- sched/cache.py: gauges mirror PlanCache.cache_info() after every
    #    lookup ("default" = the process cache, "local" = private instances)
    MetricSpec("plan_cache_hits", "gauge", ("cache",),
               "sched/cache.py", "lifetime plan-cache hits"),
    MetricSpec("plan_cache_misses", "gauge", ("cache",),
               "sched/cache.py", "lifetime plan-cache misses (= compiles)"),
    MetricSpec("plan_cache_evictions", "gauge", ("cache",),
               "sched/cache.py", "lifetime LRU evictions"),
    MetricSpec("plan_cache_size", "gauge", ("cache",),
               "sched/cache.py", "plans currently stored"),
    # -- serve/engine.py
    MetricSpec("serve_admitted_total", "counter", (),
               "serve/engine.py", "requests admitted into decode slots"),
    MetricSpec("serve_decode_steps_total", "counter", (),
               "serve/engine.py", "batched decode steps executed"),
    MetricSpec("serve_tokens_total", "counter", (),
               "serve/engine.py", "decode tokens produced (all slots)"),
    MetricSpec("serve_queue_depth", "gauge", (),
               "serve/engine.py", "requests waiting for a slot"),
    MetricSpec("serve_active_slots", "gauge", (),
               "serve/engine.py", "slots holding a live request"),
    MetricSpec("serve_tokens_per_step", "gauge", (),
               "serve/engine.py", "tokens produced by the last decode step"),
    # -- sync/engine.py
    MetricSpec("sync_publish_total", "counter", (),
               "sync/engine.py", "weight versions published"),
    MetricSpec("sync_updates_total", "counter", ("mode",),
               "sync/engine.py",
               "updates encoded, by routing mode (delta/full)"),
    MetricSpec("sync_update_wire_bytes_total", "counter", ("mode",),
               "sync/engine.py", "encoded update wire bytes, by mode"),
    MetricSpec("sync_buckets_total", "counter", ("mode",),
               "sync/engine.py",
               "per-bucket wire routing decisions (delta/full/raw)"),
    MetricSpec("sync_memo_hits_total", "counter", (),
               "sync/engine.py",
               "update_for served from the per-(version, base) memo"),
    MetricSpec("sync_replica_version_lag", "gauge", ("replica",),
               "sync/engine.py",
               "latest published version minus the replica's acked version"),
    # -- p2p/engine.py
    MetricSpec("p2p_encode_seconds", "histogram", ("codec",),
               "p2p/engine.py", "host Compressor.encode wall time"),
    MetricSpec("p2p_decode_seconds", "histogram", ("codec",),
               "p2p/engine.py", "host Compressor.decode wall time"),
    # -- runtime/fault_tolerance.py
    MetricSpec("train_step_seconds", "histogram", (),
               "runtime/fault_tolerance.py",
               "fault-tolerant step wall time (incl. retries)"),
    MetricSpec("train_retries_total", "counter", (),
               "runtime/fault_tolerance.py",
               "overflow retries executed by the runner"),
    MetricSpec("train_stragglers_total", "counter", (),
               "runtime/fault_tolerance.py", "straggler steps detected"),
    MetricSpec("ckpt_resume_fallbacks_total", "counter", (),
               "runtime/fault_tolerance.py",
               "resumes that skipped a corrupt checkpoint for an older one"),
    # -- runtime/faults.py (chaos harness; zero when no FaultPlan active)
    MetricSpec("fault_injected_total", "counter", ("kind",),
               "runtime/faults.py",
               "faults injected by the active FaultPlan, per kind"),
    # -- sync/fleet.py
    MetricSpec("sync_integrity_failures_total", "counter", ("reason",),
               "sync/fleet.py",
               "updates rejected before apply (checksum/base_fence)"),
    MetricSpec("fleet_retries_total", "counter", (),
               "sync/fleet.py",
               "per-replica send failures scheduled for retry"),
    MetricSpec("fleet_escalations_total", "counter", ("to",),
               "sync/fleet.py",
               "recovery escalations down the delta->full->raw ladder"),
    MetricSpec("fleet_quarantines_total", "counter", (),
               "sync/fleet.py",
               "replicas quarantined after exhausting max_retries"),
    MetricSpec("fleet_rounds_total", "counter", (),
               "sync/fleet.py", "distribute/ack rounds driven"),
    MetricSpec("fleet_live_replicas", "gauge", (),
               "sync/fleet.py", "replicas currently alive in the fleet"),
    MetricSpec("fleet_convergence_rounds", "gauge", (),
               "sync/fleet.py",
               "rounds the last settle() took to converge the fleet"),
    MetricSpec("fleet_trainer_egress_bytes_total", "counter", (),
               "sync/fleet.py",
               "update bytes the trainer itself put on the wire"),
    MetricSpec("fleet_forwards_total", "counter", (),
               "sync/fleet.py",
               "interior-replica verbatim forwards of an encoded update"),
    MetricSpec("fleet_forwarded_bytes_total", "counter", (),
               "sync/fleet.py",
               "update bytes re-sent verbatim by interior replicas"),
    MetricSpec("fleet_hop_depth", "gauge", (),
               "sync/fleet.py",
               "deepest wire hop count any delivery has taken"),
    MetricSpec("fleet_reparents_total", "counter", (),
               "sync/fleet.py",
               "subtree replicas re-parented to a direct trainer send"),
    # -- serve/engine.py (integrity/recovery)
    MetricSpec("serve_ingest_rejects_total", "counter", ("reason",),
               "serve/engine.py",
               "hot-swap updates rejected before apply (checksum/fence)"),
    MetricSpec("serve_kv_retries_total", "counter", (),
               "serve/engine.py",
               "KV shipments re-packed after an integrity failure"),
)

SPECS = {s.name: s for s in METRICS}

# Canonical span names (<subsystem>:<operation>); "<kind>" stands for a
# plan kind from sched/compile.PLAN_KINDS.  ph "i" = instant marker.
SPANS = (
    ("plan:<kind>", "sched/executor.py",
     "one plan execution (trace-time replay of every bucket wire)"),
    ("plan_cache:compile", "sched/cache.py",
     "a cache miss running its plan compiler"),
    ("plan_cache:hit", "sched/cache.py", "instant: plan-cache hit"),
    ("serve:admit", "serve/engine.py",
     "one request admission (prefill + splice)"),
    ("serve:prefill", "serve/engine.py", "the admission's prefill step"),
    ("serve:kv_ship", "serve/engine.py",
     "PD-disaggregated prefill->decode cache shipment"),
    ("serve:decode_step", "serve/engine.py", "one batched decode step"),
    ("sync:publish", "sync/engine.py", "retaining a new weight version"),
    ("sync:update", "sync/engine.py", "resolving one replica's update"),
    ("sync:memo_hit", "sync/engine.py",
     "instant: update served from the per-base memo"),
    ("sync:encode", "sync/engine.py",
     "encoding an update (delta/full/raw per bucket)"),
    ("p2p:encode", "p2p/engine.py", "host Compressor encode"),
    ("p2p:split", "p2p/engine.py", "plane-split stage (rANS codec)"),
    ("p2p:entropy_code", "p2p/engine.py", "rANS exponent-plane encode"),
    ("p2p:pack", "p2p/engine.py", "fused split+pack pipeline (packed codec)"),
    ("p2p:decode", "p2p/engine.py", "host Compressor decode"),
    ("train:step", "runtime/fault_tolerance.py",
     "one fault-tolerant train step (incl. overflow retries)"),
    ("train:retry", "runtime/fault_tolerance.py",
     "instant: overflow retry on the fallback step"),
    ("train:checkpoint", "runtime/fault_tolerance.py",
     "async checkpoint submission"),
    ("train:resume_fallback", "runtime/fault_tolerance.py",
     "instant: resume skipped a corrupt checkpoint for an older one"),
    ("fault:inject", "runtime/faults.py",
     "instant: the FaultPlan injected one message fault"),
    ("fleet:round", "sync/fleet.py",
     "one fleet distribute/ack round (events, sends, acks, timeouts)"),
    ("fleet:restart", "sync/fleet.py",
     "trainer failover: checkpoint restore + epoch fence"),
    ("fleet:forward", "sync/fleet.py",
     "instant: an interior replica forwarded the encoded wire verbatim"),
    ("drift:fire", "obs/drift.py",
     "instant: the drift detector flagged a stale plan (live wire ratio "
     "beyond the hysteresis threshold)"),
)


class _RecordedMetric:
    """Tee wrapper: forwards each observation to the registry metric AND
    into the flight recorder (``obs/recorder.py``), keyed by the same
    declared-order label string — so every instrumented series gets a
    windowed history for free."""

    __slots__ = ("_m",)

    def __init__(self, m):
        self._m = m

    @property
    def name(self):
        return self._m.name

    @property
    def kind(self):
        return self._m.kind

    @property
    def label_names(self):
        return self._m.label_names

    def series(self):
        return self._m.series()

    def inc(self, value=1, **labels):
        self._m.inc(value, **labels)  # validates labels before we record
        recorder_lib.record(self._m.name, value, self._m._key(labels))

    def dec(self, value=1, **labels):
        self._m.dec(value, **labels)
        recorder_lib.record(self._m.name, -value, self._m._key(labels))

    def set(self, value, **labels):
        self._m.set(value, **labels)
        recorder_lib.record(self._m.name, value, self._m._key(labels))

    def observe(self, value, **labels):
        self._m.observe(value, **labels)
        recorder_lib.record(self._m.name, value, self._m._key(labels))


def metric(name: str):
    """The live metric for a canonical ``name`` (no-op when REPRO_OBS=0).

    Creates it in the default registry on first use with the spec's
    declared type/labels, so instrumentation cannot drift from the table;
    observations are teed into the flight recorder.  Unknown names raise
    KeyError."""
    if not config.enabled():
        _ = SPECS[name]  # typos still fail loudly in disabled mode
        return metrics_lib.NOOP_METRIC
    spec = SPECS[name]
    reg = metrics_lib.registry()
    if spec.kind == "histogram":
        m = reg.histogram(
            spec.name, labels=spec.labels, help=spec.help,
            buckets=spec.buckets or metrics_lib.DEFAULT_TIME_BUCKETS)
    else:
        m = getattr(reg, spec.kind)(spec.name, labels=spec.labels,
                                    help=spec.help)
    return _RecordedMetric(m)
