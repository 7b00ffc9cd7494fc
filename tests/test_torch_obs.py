"""The port's observability layer (``repro_torch.obs``) held against the
reference's (``repro.obs``); the twin of ``tests/test_obs.py``.

* the name tables: ``SPECS`` and ``SPANS`` equal the reference's but for
  ``kernel_fallback_total`` (the port has no kernel fallback), and every
  literal ``obs.metric``/``obs.span``/``obs.instant`` in ``src/repro_torch``
  resolves, the set of names equal to the reference's but that one;
* registry, tracer and Chrome-trace semantics on the same sequence of
  observations: the same snapshots, markdown, span structure and events;
* the instrumented modules on the same numpy inputs: the executor (one psum
  plan at 1 rank against the reference in ``shard_map``, and at 2 gloo
  ranks against the reference compiler's plan), the plan cache, the
  weight-sync engine, the p2p ``Compressor`` under both codecs, a PD serve
  run and the dump CLI's ``sync`` target give the reference's counters,
  gauges, ledger and span names; histograms are compared by count;
* ``REPRO_OBS=0`` (``obs.set_enabled(False)``): every path's results are
  bit-identical and nothing is recorded (on the card, with the same
  launches of every kernel: ``tests/test_torch_gpu.py``).

Integers, byte counts and counter values are compared exactly, ratios to
1e-12 relative; timings are not compared.  Plan keys hash with Python's
``hash`` and are never compared.
"""
import collections
import json
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import obs as jobs
from repro import sched as jsched
from repro.core import policy as jpolicy
from repro.core.policy import CompressionPolicy as JPolicy
from repro.obs import dump as jdump
from repro.p2p.engine import Compressor as JCompressor
from repro.sched import compile as jcompile
from repro.sync import WeightSyncEngine as JWeightSyncEngine
from repro.sync import apply_update as japply_update
from repro_torch import obs, sched
from repro_torch.core import policy
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch.train import single_process_group
from repro_torch.obs import dump
from repro_torch.obs import regret
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import SpanTracer
from repro_torch.p2p.engine import Compressor
from repro_torch.sched.cache import PlanCache
from repro_torch.sync import WeightSyncEngine, apply_update
from repro_torch.tree_util import tree_leaves
from torch_port_util import _psum_tree, np_of, obs_psum_rank, run_gloo_ranks, to_torch

ROOT = os.path.join(os.path.dirname(__file__), "..", "src")
FALLBACK = "kernel_fallback_total"


def _fresh_default_cache(module: str) -> None:
    import importlib

    cache = importlib.import_module(module).default_cache()
    cache.clear()
    cache.reset_stats()


@pytest.fixture(autouse=True)
def _isolate():
    """Both packages start every test from an empty registry, span buffer
    and observatory, obs enabled, and an empty process plan cache (whose
    lifetime counts the ``plan_cache_*`` gauges mirror)."""
    for cache in ("repro_torch.sched.cache", "repro.sched.cache"):
        _fresh_default_cache(cache)
    for o in (obs, jobs):
        o.set_enabled(True)
        o.reset()
    yield
    for o in (obs, jobs):
        o.set_enabled(None)
        o.reset()


def _histogram_counts(snap: dict) -> dict:
    return {name: {k: v["count"] for k, v in series.items()}
            for name, series in snap["histograms"].items()}


def _assert_snapshots_equal(got: dict, want: dict, ctx=""):
    """Counters and gauges exactly (floats to 1e-12 relative), histograms
    by count only (their sums are seconds)."""
    assert got["counters"] == want["counters"], ctx
    assert set(got["gauges"]) == set(want["gauges"]), ctx
    for name, series in want["gauges"].items():
        assert set(got["gauges"][name]) == set(series), (ctx, name)
        for k, v in series.items():
            assert got["gauges"][name][k] == pytest.approx(v, rel=1e-12, abs=0), (ctx, name, k)
    assert _histogram_counts(got) == _histogram_counts(want), ctx


def _span_names(o) -> collections.Counter:
    return collections.Counter(s.name for s in o.spans())


# ---------------------------------------------------------------------------
# name tables and call sites
# ---------------------------------------------------------------------------

def test_specs_and_spans_equal_the_reference_but_the_fallback_metric():
    want = [s for s in jobs.METRICS if s.name != FALLBACK]
    assert len(want) == len(jobs.METRICS) - 1
    assert [(s.name, s.kind, s.labels, s.module, s.help, s.buckets) for s in obs.METRICS] \
        == [(s.name, s.kind, s.labels, s.module, s.help, s.buckets) for s in want]
    assert set(obs.SPECS) == set(jobs.SPECS) - {FALLBACK}
    assert obs.SPANS == jobs.SPANS
    from repro.obs import names as jnames
    from repro_torch.obs import names

    assert names.RATIO_BUCKETS == jnames.RATIO_BUCKETS


_LITERAL = re.compile(r"""obs\s*\.\s*(metric|span|instant)\(\s*["']([^"']+)["']""")


def _literal_names(package: str) -> tuple:
    """Every literal obs call site of ``src/<package>``: ``{(what, name)}``
    and the (file, line) of each ``# obs seam:`` comment."""
    found, seams = set(), []
    for root, _, files in os.walk(os.path.join(ROOT, package)):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(root, fn)) as f:
                text = f.read()
            found |= set(_LITERAL.findall(text))
            seams += [(fn, i) for i, line in enumerate(text.splitlines())
                      if "# obs seam:" in line]
    return found, seams


def test_every_obs_name_literal_resolves_and_matches_the_reference():
    """The twin of ``test_every_obs_name_literal_resolves``: every literal
    name resolves against the port's tables, and the port uses exactly the
    reference's names but ``kernel_fallback_total``.  No ``# obs seam:``
    comment is left."""
    from repro_torch.sched.compile import PLAN_KINDS

    got, seams = _literal_names("repro_torch")
    want, _ = _literal_names("repro")
    span_names = {n for n, _, _ in obs.SPANS} | {f"plan:{k}" for k in PLAN_KINDS}
    unknown = [(w, n) for w, n in got
               if n not in (obs.SPECS if w == "metric" else span_names)]
    assert not unknown, unknown
    assert len(got) > 30
    assert {n for _, n in got} == {n for _, n in want} - {FALLBACK}
    assert seams == []


def test_canonical_names_resolve_and_typos_raise():
    for spec in obs.METRICS:
        m = obs.metric(spec.name)
        assert m.name == spec.name and m.kind == spec.kind
        assert m.label_names == spec.labels
    with pytest.raises(KeyError):
        obs.metric(FALLBACK)
    with pytest.raises(KeyError):
        obs.metric("no_such_metric_total")


# ---------------------------------------------------------------------------
# registry, tracer, Chrome trace: the reference's semantics
# ---------------------------------------------------------------------------

def _registry_script(reg) -> dict:
    c = reg.counter("c_total", labels=("kind",))
    c.inc(kind="a")
    c.inc(2, kind="a")
    c.inc(kind="b")
    g = reg.gauge("g")
    g.set(5)
    g.inc(2)
    g.dec()
    h = reg.histogram("h_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 5.0):
        h.observe(v)
    reg.gauge("r", labels=("kind",)).set(0.8236, kind="psum")
    return {"snapshot": reg.snapshot(), "json": reg.to_json(), "md": reg.to_markdown(),
            "names": reg.names(), "c": c.series(), "g": g.series(), "h": h.series()}


def test_registry_semantics_match_the_reference():
    from repro.obs.metrics import MetricsRegistry as JMetricsRegistry

    got, want = _registry_script(MetricsRegistry()), _registry_script(JMetricsRegistry())
    assert got == want
    assert got["c"] == {"kind=a": 3, "kind=b": 1} and got["g"] == {"": 6}
    assert got["h"][""]["buckets"] == {"le=0.1": 1, "le=1": 2, "le=+Inf": 1}
    assert got["md"].splitlines()[0] == "| metric | type | labels | value |"
    json.loads(got["json"])


def test_label_validation_and_conflicts():
    reg = MetricsRegistry()
    c = reg.counter("c", labels=("kind",))
    with pytest.raises(ValueError):
        c.inc(-1, kind="a")  # counters are monotonic
    with pytest.raises(ValueError):
        c.inc()  # missing label
    with pytest.raises(ValueError):
        c.inc(kind="a", extra="b")  # unknown label
    assert reg.counter("c", labels=("kind",)) is c
    with pytest.raises(ValueError):
        reg.gauge("c", labels=("kind",))
    with pytest.raises(ValueError):
        reg.counter("c", labels=("other",))
    with pytest.raises(ValueError):
        reg.histogram("h", buckets=())


def test_disabled_mode_is_noop():
    obs.set_enabled(False)
    m = obs.metric("plan_exec_total")
    assert m is obs.NOOP_METRIC
    m.inc(kind="psum")
    sp = obs.span("plan:psum")
    assert sp is obs.NOOP_SPAN
    with sp as s:
        s.args["kind"] = "psum"  # assignments vanish by design
    obs.instant("plan_cache:hit")
    assert obs.spans() == ()
    assert obs.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    with pytest.raises(KeyError):
        obs.metric("typo_total")  # names still validated when disabled


def test_enabled_reads_the_environment(monkeypatch):
    for value, want in (("0", False), ("off", False), ("1", True), (None, True)):
        if value is None:
            monkeypatch.delenv("REPRO_OBS", raising=False)
        else:
            monkeypatch.setenv("REPRO_OBS", value)
        obs.set_enabled(None)
        jobs.set_enabled(None)
        assert obs.enabled() is jobs.enabled() is want, value


def _span_script(o):
    with o.span("train:step", step=1):
        with o.span("plan:psum"):
            pass
        o.instant("plan_cache:hit")
    return [(r.name, r.depth, r.ph, r.args) for r in o.spans()]


def test_span_nesting_depth_and_order_match_the_reference():
    got = _span_script(obs)
    assert got == _span_script(jobs)
    assert got == [("plan:psum", 1, "X", {}), ("plan_cache:hit", 1, "i", {}),
                   ("train:step", 0, "X", {"step": 1})]
    outer, inner = obs.spans()[-1], obs.spans()[0]
    assert outer.ts <= inner.ts and outer.dur >= inner.dur


def test_span_ring_buffer_cap():
    tr = SpanTracer(capacity=4)
    for i in range(10):
        with tr.span("sync:publish", i=i):
            pass
    recs = tr.spans()
    assert len(recs) == 4 and [r.args["i"] for r in recs] == [6, 7, 8, 9]


def _trace_events(o, path) -> list:
    with o.span("sync:publish", version=3, key=("a", 1)):
        o.instant("sync:memo_hit")
    doc = json.load(open(o.export_chrome_trace(str(path))))
    assert doc["displayTimeUnit"] == "ms"
    return doc["traceEvents"]


def test_chrome_trace_schema_matches_the_reference(tmp_path):
    got = _trace_events(obs, tmp_path / "port.json")
    want = _trace_events(jobs, tmp_path / "ref.json")
    strip = lambda evs: [{k: v for k, v in e.items()  # noqa: E731
                          if k not in ("ts", "dur", "pid", "tid")} for e in evs]
    assert strip(got) == strip(want)
    assert [e["ts"] for e in got] == sorted(e["ts"] for e in got)
    (x,) = [e for e in got if e["ph"] == "X"]
    (i,) = [e for e in got if e["ph"] == "i"]
    assert x["dur"] >= 0 and x["args"] == {"version": 3, "key": "('a', 1)"}
    assert i["s"] == "t" and "dur" not in i and x["cat"] == "sync"
    assert not os.path.exists(str(tmp_path / "port.json") + ".tmp")


# ---------------------------------------------------------------------------
# the executor and the plan cache
# ---------------------------------------------------------------------------

def _port_plan_psum(tree=None):
    tree = {"w": torch.arange(4096, dtype=torch.float32)} if tree is None else tree
    with single_process_group("cpu") as g:
        return sched.psum_with_plan(tree, g, policy=CompressionPolicy(min_bytes=0),
                                    cache=PlanCache())


def _ref_plan_psum():
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    cache = jsched.PlanCache()
    tree = {"w": jnp.arange(4096, dtype=jnp.float32)}

    def fn(t):
        return jsched.psum_with_plan(t, "data", policy=JPolicy(min_bytes=0), cache=cache)

    f = jax.shard_map(fn, mesh=mesh, in_specs=(P(),), out_specs=(P(), P()),
                      axis_names={"data"}, check_vma=False)
    return f(tree)


def test_executor_metrics_and_ledger_match_the_reference_at_one_rank():
    """One psum plan outside ``jit``: the reference's body runs once, as the
    port's eager replay does, so the counts agree; the plan totals equal
    ``summarize_wire_reports`` of the window's consolidated reports."""
    from repro_torch.roofline.analysis import summarize_wire_reports

    with policy.capture_wire_reports() as reports:
        out, flag = _port_plan_psum()
    with jpolicy.capture_wire_reports() as jreports:
        _ref_plan_psum()
    assert int(flag) == 0 and torch.equal(out["w"], torch.arange(4096, dtype=torch.float32))
    snap, jsnap = obs.snapshot(), jobs.snapshot()
    _assert_snapshots_equal(snap, jsnap)
    assert snap["counters"]["plan_exec_total"] == {"kind=psum": 1}
    summ = summarize_wire_reports([r for r in reports if r.name.startswith("plan:")])
    assert snap["counters"]["plan_wire_raw_bytes_total"] == {"kind=psum": summ["raw_bytes"]}
    assert snap["counters"]["plan_wire_bytes_total"] == {"kind=psum": summ["wire_bytes"]}
    assert snap["gauges"]["plan_wire_ratio"]["kind=psum"] == pytest.approx(
        reports[-1].ratio, rel=1e-12)
    assert regret.ledger_totals() == jobs.regret.ledger_totals()
    assert regret.check_ledger_exactness(reports)["ok"]
    assert jobs.regret.check_ledger_exactness(jreports)["ok"]
    assert _span_names(obs) == _span_names(jobs)
    assert {"plan:psum", "plan_cache:compile"} <= set(_span_names(obs))
    (sp,) = [s for s in obs.spans() if s.name == "plan:psum"]
    assert sp.args["buckets"] == 1 and re.fullmatch(r"[0-9a-f]{8}", sp.args["plan_key"])


def test_executor_ledger_at_two_gloo_ranks(tmp_path):
    """A mixed tree (bf16, f32, int32) at 2 gloo ranks: one execution, and
    each compressed bucket's ledger row is the reference compiler's bucket
    (the bytes every rank's wires carry); the ledger equals the window's
    reports on each rank."""
    res = run_gloo_ranks(obs_psum_rank, 2, tmp_path)
    meta = jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), jnp.dtype(str(t.dtype).removeprefix("torch."))), _psum_tree(0))
    jplan = jcompile.compile_psum_plan(meta, "data", policy=JPolicy(min_bytes=0), n_dev=2)
    want_raw, want_wire = {}, {}
    for b in jplan.buckets:
        if b.compressed:
            key = f"kind=psum,dtype={b.dtype_name},width={b.width}"
            want_raw[key] = want_raw.get(key, 0) + b.raw_bytes
            want_wire[key] = want_wire.get(key, 0) + b.wire_bytes
    for r in res:
        counters = json.loads(str(r["counters"]))
        assert counters["plan_exec_total"] == {"kind=psum": 1}
        assert counters["bucket_wire_raw_bytes_total"] == want_raw
        assert counters["bucket_wire_bytes_total"] == want_wire
        assert counters["plan_wire_raw_bytes_total"] == {"kind=psum": jplan.raw_bytes}
        assert counters["plan_wire_bytes_total"] == {"kind=psum": jplan.wire_bytes}
        assert int(r["exact"]) == 1
        assert json.loads(str(r["spans"])).count("plan:psum") == 1


def _cache_script(cache_cls):
    cache = cache_cls(capacity=2)
    cache.get_or_compile(("k", 1), lambda: "p1")
    cache.get_or_compile(("k", 1), lambda: "p1")
    cache.get_or_compile(("k", 2), lambda: "p2")
    cache.get_or_compile(("k", 3), lambda: "p3")  # evicts ("k", 1)
    cache.clear()
    return cache.cache_info()


def test_cache_instrumentation_and_gauges_match_the_reference():
    assert _cache_script(PlanCache) == _cache_script(jsched.PlanCache)
    _assert_snapshots_equal(obs.snapshot(), jobs.snapshot())
    gauges = obs.snapshot()["gauges"]
    assert gauges["plan_cache_hits"] == {"cache=local": 1}
    assert gauges["plan_cache_misses"] == {"cache=local": 3}
    assert gauges["plan_cache_evictions"] == {"cache=local": 1}
    assert gauges["plan_cache_size"] == {"cache=local": 0}
    assert [(s.name, s.ph, s.args) for s in obs.spans()] == \
        [(s.name, s.ph, s.args) for s in jobs.spans()]


# ---------------------------------------------------------------------------
# the host engines
# ---------------------------------------------------------------------------

def _sync_script(side: str):
    """The reference test's publish / update / ack / memo sequence."""
    x = np.linspace(0, 1, 4096).astype(np.float32)
    if side == "port":
        params = {"w": torch.from_numpy(x).to(torch.bfloat16)}
        eng = WeightSyncEngine(policy=CompressionPolicy(min_bytes=0))
        apply = lambda u: apply_update(u, device="cpu")  # noqa: E731
    else:
        params = {"w": jnp.asarray(x, jnp.bfloat16)}
        eng = JWeightSyncEngine(policy=JPolicy(min_bytes=0))
        apply = japply_update
    v1 = eng.publish(params)
    upd = eng.update_for("r0")
    apply(upd)
    eng.ack("r0", v1)
    upd2 = eng.update_for("r0")  # the base moved to v1: a fresh (delta) encode
    upd3 = eng.update_for("r0")  # the same (version, base): a memo hit
    assert upd3 is upd2
    return upd, upd2


def test_sync_engine_instrumentation_matches_the_reference():
    upd, upd2 = _sync_script("port")
    jupd, jupd2 = _sync_script("ref")
    assert (upd.wire_bytes, upd2.wire_bytes) == (jupd.wire_bytes, jupd2.wire_bytes)
    snap = obs.snapshot()
    _assert_snapshots_equal(snap, jobs.snapshot())
    assert snap["counters"]["sync_publish_total"] == {"": 1}
    assert snap["counters"]["sync_memo_hits_total"] == {"": 1}
    assert sum(snap["counters"]["sync_update_wire_bytes_total"].values()) == \
        upd.wire_bytes + upd2.wire_bytes
    assert snap["gauges"]["sync_replica_version_lag"] == {"replica=r0": 0}
    assert _span_names(obs) == _span_names(jobs)
    assert [(s.name, s.ph, s.args) for s in obs.spans() if s.name.startswith("sync:")] == \
        [(s.name, s.ph, s.args) for s in jobs.spans() if s.name.startswith("sync:")]
    assert regret.ledger_totals() == jobs.regret.ledger_totals()


@pytest.mark.parametrize("codec", ["packed", "rans"])
def test_p2p_compressor_spans_histograms_and_ledger_match_the_reference(codec):
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    comp = Compressor(codec_name=codec, device="cpu")
    msg = comp.encode(torch.from_numpy(x))
    assert np.array_equal(comp.decode(msg).numpy(), x)
    jcomp = JCompressor(codec_name=codec)
    jmsg = jcomp.encode(jnp.asarray(x))
    jcomp.decode(jmsg)
    assert (msg.raw_bytes, msg.wire_bytes()) == (jmsg.raw_bytes, jmsg.wire_bytes())
    _assert_snapshots_equal(obs.snapshot(), jobs.snapshot(), codec)
    hist = obs.snapshot()["histograms"]
    assert hist["p2p_encode_seconds"][f"codec={codec}"]["count"] == 1
    assert hist["p2p_decode_seconds"][f"codec={codec}"]["count"] == 1
    assert regret.ledger_totals() == jobs.regret.ledger_totals()
    assert set(regret.ledger_totals()["by_kind"]) == {"p2p_host"}
    # the reference's packed codec warms its jit outside the p2p:pack span;
    # the spans are the same either way
    assert _span_names(obs) == _span_names(jobs)
    (sp,) = [s for s in obs.spans() if s.name == "p2p:encode"]
    assert sp.args == {"codec": codec, "tensor_class": "weight",
                       "raw_bytes": msg.raw_bytes, "wire_bytes": msg.wire_bytes()}
    (sample,) = regret.samples()[("p2p_host", "float32")]
    assert np.array_equal(sample.x.numpy(), x) and sample.elems == x.size


def test_serve_pd_run_matches_the_reference_spans_and_counters(tmp_path):
    """The dump's ``serve`` target (a PD run at smoke size, random weights
    of each package's own init): the same multiset of span names, serve
    counters and gauges, plan-cache gauges and p2p_host ledger."""
    dump.dump("serve", str(tmp_path / "port"), steps=16, device="cpu")
    port_spans, port_snap = _span_names(obs), obs.snapshot()
    jdump.dump("serve", str(tmp_path / "ref"), steps=16)
    assert port_spans == _span_names(jobs)
    _assert_snapshots_equal(port_snap, jobs.snapshot())
    assert port_snap["counters"]["serve_admitted_total"] == {"": 3}
    assert port_spans["serve:kv_ship"] == 3


def test_dump_sync_target_matches_the_reference(tmp_path):
    paths = dump.dump("sync", str(tmp_path / "port"), steps=3, report=True, device="cpu")
    jpaths = jdump.dump("sync", str(tmp_path / "ref"), steps=3, report=True)
    assert set(paths) == set(jpaths)
    for key in paths:
        assert os.path.basename(paths[key]) == os.path.basename(jpaths[key])
    load = lambda p: json.load(open(p))  # noqa: E731
    _assert_snapshots_equal(load(paths["metrics_json"]), load(jpaths["metrics_json"]))
    assert load(paths["metrics_json"])["counters"]["sync_publish_total"] == {"": 3}
    rep, jrep = load(paths["report_json"]), load(jpaths["report_json"])
    assert set(rep) == set(jrep)
    assert rep["ledger_by_bucket"] == jrep["ledger_by_bucket"]
    assert rep["ledger_by_kind"] == jrep["ledger_by_kind"]
    assert rep["regret"] == jrep["regret"]
    assert rep["drift"] == jrep["drift"]
    names = {e["name"] for e in load(paths["trace"])["traceEvents"]}
    assert {"sync:publish", "sync:encode", "sync:update"} <= names
    assert open(paths["metrics_md"]).read().startswith("| metric | type | labels | value |")
    assert open(paths["report_md"]).read().startswith("# Wire-efficiency observatory")
    with pytest.raises(KeyError):
        dump.dump("no_such_target", str(tmp_path), device="cpu")


def test_dump_cli_train_sync_on_the_cpu(tmp_path, capsys):
    dump.main(["--out", str(tmp_path), "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "trace:" in out and "metrics_json:" in out
    snap = json.load(open(tmp_path / "metrics_train_sync.json"))
    assert snap["counters"]["plan_exec_total"] == {"kind=zero1": 2}
    assert snap["histograms"]["train_step_seconds"][""]["count"] == 2
    assert snap["counters"]["sync_publish_total"] == {"": 3}
    events = json.load(open(tmp_path / "trace_train_sync.json"))["traceEvents"]
    steps = [e for e in events if e["name"] == "train:step"]
    plans = [e for e in events if e["name"] == "plan:zero1"]
    assert len(steps) == len(plans) == 2
    for s, p in zip(steps, plans):  # each plan replay nests in its step
        assert s["ts"] <= p["ts"] and p["ts"] + p["dur"] <= s["ts"] + s["dur"] + 1e-3


# ---------------------------------------------------------------------------
# thread safety
# ---------------------------------------------------------------------------

def test_concurrent_counter_increments():
    reg = MetricsRegistry()
    c = reg.counter("c_total")
    barrier = threading.Barrier(4)

    def worker():
        barrier.wait(timeout=10)
        for _ in range(1000):
            c.inc()

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert c.series() == {"": 4000}


def test_spans_from_multiple_threads_share_one_buffer():
    barrier = threading.Barrier(4)  # all alive at once: distinct idents

    def worker(i):
        barrier.wait(timeout=10)
        with obs.span("train:step", worker=i):
            with obs.span("plan:zero1"):
                pass

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    recs = [r for r in obs.spans() if r.name == "train:step"]
    assert len(recs) == 4
    assert sorted(r.args["worker"] for r in recs) == [0, 1, 2, 3]
    assert len({r.tid for r in recs}) == 4  # distinct Chrome-trace lanes
    assert all(r.depth == 0 for r in recs)  # nesting is per thread
    assert all(r.depth == 1 for r in obs.spans() if r.name == "plan:zero1")


# ---------------------------------------------------------------------------
# REPRO_OBS=0: the same bits, nothing recorded
# ---------------------------------------------------------------------------

def _paths_run():
    """psum over a plan, a weight-sync full and delta update, a p2p encode
    and decode, each codec: the results as bytes."""
    out = []
    res, flag = _port_plan_psum(_psum_tree(0))
    out += [np_of(t).tobytes() for t in tree_leaves(res)] + [int(flag)]
    eng = WeightSyncEngine(policy=CompressionPolicy(min_bytes=0))
    w = {"w": to_torch(np.arange(8192, dtype=np.uint16) % 4096 + 0x3C00, "bfloat16")}
    eng.publish(w)
    u1 = eng.update_for("r")
    held = apply_update(u1, device="cpu")
    eng.ack("r", u1.version)
    eng.publish({"w": w["w"] * 1.0078125})
    u2 = eng.update_for("r")
    held2 = apply_update(u2, base_params=held, device="cpu")
    out += [u1.wire_bytes, u1.mode, u2.wire_bytes, u2.mode, u2.checksum,
            np_of(held2["w"]).tobytes()]
    x = torch.from_numpy(np.random.default_rng(1).normal(size=3000).astype(np.float32))
    for codec in ("packed", "rans"):
        comp = Compressor(codec_name=codec, device="cpu")
        msg = comp.encode(x)
        out += [msg.wire_bytes(), msg.lo_payload.tobytes(), np_of(comp.decode(msg)).tobytes()]
    return out


def test_obs_off_gives_the_same_bits_and_records_nothing():
    on = _paths_run()
    assert obs.snapshot()["counters"] and obs.spans() and regret.samples()
    obs.reset()
    obs.set_enabled(False)
    off = _paths_run()
    assert off == on
    assert obs.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert obs.spans() == () and obs.recorder().series() == ()
    assert regret.samples() == {} and obs.drift.detector().report().events == ()
