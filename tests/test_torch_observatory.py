"""The port's wire-efficiency observatory (``repro_torch.obs``: flight
recorder, per-bucket ledger and width regret, drift detection, report)
held against the reference's; the twin of ``tests/test_observatory.py``,
with the twin of ``tests/test_faults.py::test_fleet_obs_accounting``.

* the same observations give the same windows, quantiles and sparklines,
  the same drift events and ``DriftReport.to_dict()`` (key hex aside: plan
  keys hash with Python's ``hash``), and the same payloads recorded into
  both sample stores give equal ``RegretRow``s field by field;
* the ledger of one executor psum equals the window's consolidated reports
  (``check_ledger_exactness`` ok) and a doctored report is flagged;
* the weight-sync host path on the reference's workload (the same published
  bits in both packages): the same ledger, samples, regret rows and drift
  events, also after an entropy shift;
* a fault-free fleet, a scripted-fault fleet and the seed-7 chaos fleet
  give the reference's ``fleet_*``, ``fault_injected_total`` and
  ``sync_integrity_failures_total`` counters.

Integers and byte counts exactly, ratios to 1e-12 relative.  A regret
row's ``entropy_bits`` is the calibrate probe's f32 sum over a histogram,
which the two packages add in another order: relative 1e-6, as in
``tests/test_torch_sched_collectives.py``.
"""
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs.drift import DriftDetector as JDriftDetector
from repro.obs.recorder import FlightRecorder as JFlightRecorder
from repro.obs.recorder import sparkline as jsparkline
from repro_torch import obs
from repro_torch.core.calibrate import CompressionProfile
from repro_torch.core.policy import CompressionPolicy, WireReport, capture_wire_reports
from repro_torch.models.transformer import numpy_to_torch
from repro_torch.obs import drift as drift_lib
from repro_torch.obs import dump
from repro_torch.obs import regret as regret_lib
from repro_torch.obs.drift import DriftDetector
from repro_torch.obs.recorder import FlightRecorder, sparkline
from repro_torch.sync import WeightSyncEngine, apply_update
from torch_port_util import FleetSide, fleet_params_np, np_of, perturb_np, to_torch

REF, PORT = FleetSide(port=False), FleetSide(port=True)


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


def _approx_dict(got: dict, want: dict):
    """Equal dicts, floats to 1e-12 relative (``entropy_bits`` 1e-6)."""
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            rel = 1e-6 if k == "entropy_bits" else 1e-12
            assert got[k] == pytest.approx(v, rel=rel, abs=0), k
        else:
            assert got[k] == v, k


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _recorder_script(cls):
    rec = cls(capacity=4)
    steps = [rec.record("m", float(v + 1)) for v in range(10)]
    out = {"steps": steps, "samples": rec.samples("m"), "window": rec.window("m"),
           "n2": rec.samples("m", n=2), "missing": rec.window("missing")}
    big = cls(capacity=32)
    for v in (3.5, -1.0, 7.25, 0.0, 2.0, 9.0, 1e-3, 4.0, 4.0, 6.5):
        big.record("plan_wire_ratio", v, "kind=psum")
    out["quantiles"] = big.window("plan_wire_ratio", kind="psum")
    out["snapshot"] = big.snapshot(n=5)
    rec.clear()
    out["after_clear"] = (rec.series(), rec.record("m", 1.0))
    return out


def test_recorder_matches_the_reference():
    got, want = _recorder_script(FlightRecorder), _recorder_script(JFlightRecorder)
    assert [(s.step, s.value) for s in got["samples"]] == \
        [(s.step, s.value) for s in want["samples"]] == [(7, 7.0), (8, 8.0), (9, 9.0),
                                                         (10, 10.0)]
    for key in ("window", "quantiles"):
        _approx_dict(got[key].to_dict(), want[key].to_dict())
    assert set(got["snapshot"]) == set(want["snapshot"])
    for k in want["snapshot"]:
        _approx_dict(got["snapshot"][k], want["snapshot"][k])
    assert got["steps"] == want["steps"] and got["missing"] is want["missing"] is None
    assert [s.value for s in got["n2"]] == [9.0, 10.0]
    assert got["after_clear"] == want["after_clear"] == ((), 1)


def test_recorder_quantiles():
    rec = FlightRecorder(capacity=32)
    for v in range(1, 11):
        rec.record("m", float(v))
    st = rec.window("m")
    assert st.p50 == pytest.approx(5.5)
    assert st.p90 == pytest.approx(9.1)
    assert st.p99 == pytest.approx(9.91)


def test_recorder_label_kwargs_resolve_against_specs():
    rec = FlightRecorder(capacity=8)
    rec.record("plan_exec_total", 1.0, "kind=psum")
    got = rec.samples("plan_exec_total", kind="psum")
    assert len(got) == 1 and got[0].value == 1.0
    assert rec.window("plan_exec_total", kind="psum").series == "plan_exec_total|kind=psum"
    with pytest.raises(ValueError):
        rec.samples("plan_exec_total", wrong="x")
    with pytest.raises(ValueError):
        rec.samples("plan_exec_total", labels_key="kind=psum", kind="psum")


def _tee_script(o):
    o.metric("plan_exec_total").inc(kind="psum")
    o.metric("plan_exec_total").inc(2, kind="psum")
    o.metric("serve_queue_depth").inc()
    o.metric("serve_queue_depth").dec()
    o.metric("plan_wire_ratio").set(0.25, kind="psum")
    o.metric("p2p_encode_seconds").observe(0.125, codec="width")
    with pytest.raises(ValueError):
        o.metric("plan_exec_total").inc(wrong="x")
    rec = o.recorder()
    return {k: [(s.step, s.value) for s in rec.samples(*k.split("|")[:1],
                                                       labels_key=k.partition("|")[2])]
            for k in rec.series()}


def test_registry_tee_feeds_the_recorder_as_the_reference():
    got = _tee_script(obs)
    assert got == _tee_script(jobs)
    assert [v for _, v in got["plan_exec_total|kind=psum"]] == [1.0, 2.0]
    assert [v for _, v in got["serve_queue_depth"]] == [1.0, -1.0]
    assert obs.snapshot()["counters"]["plan_exec_total"] == {"kind=psum": 3}


def test_recorder_thread_safety():
    rec = FlightRecorder(capacity=1000)

    def worker(i):
        for _ in range(250):
            rec.record("m", 1.0, f"t={i}")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    per = [rec.samples("m", labels_key=f"t={i}") for i in range(4)]
    assert [len(p) for p in per] == [250] * 4
    assert sorted(s.step for p in per for s in p) == list(range(1, 1001))


@pytest.mark.parametrize("vals", [[], [1.0, 1.0], [0, 1, 2, 3], [0.8, 0.2, 0.5, 0.51, 7.0],
                                  list(np.random.default_rng(3).normal(size=40))])
def test_sparkline_matches_the_reference(vals):
    assert sparkline(vals) == jsparkline(vals)
    assert len(sparkline(vals)) == len(vals)


# ---------------------------------------------------------------------------
# ledger: exact against the consolidated reports
# ---------------------------------------------------------------------------

def _port_psum_window():
    from repro_torch import sched
    from repro_torch.launch.train import single_process_group
    from repro_torch.sched.cache import PlanCache

    with capture_wire_reports() as reports:
        obs.reset()
        with single_process_group("cpu") as g:
            sched.psum_with_plan({"w": torch.arange(4096, dtype=torch.float32)}, g,
                                 policy=CompressionPolicy(min_bytes=0), cache=PlanCache())
    return reports


def test_bucket_ledger_agrees_exactly_with_wire_reports():
    from repro_torch.roofline.analysis import summarize_wire_reports

    reports = _port_psum_window()
    res = regret_lib.check_ledger_exactness(reports)
    assert res["ok"], res["diffs"]
    summ = summarize_wire_reports([r for r in reports if r.name.startswith("plan:")])
    led = regret_lib.ledger_totals()
    assert led["by_kind"]["psum"]["raw_bytes"] == summ["raw_bytes"]
    assert led["by_kind"]["psum"]["wire_bytes"] == summ["wire_bytes"]
    assert all(k == "psum" and d == "float32" for (k, d, _) in led["by_bucket"])
    assert res["summary"] == summ


def test_summarize_wire_reports_matches_the_reference():
    from repro.core.policy import WireReport as JWireReport
    from repro.roofline.analysis import summarize_wire_reports as jsummarize
    from repro_torch.roofline.analysis import summarize_wire_reports

    rows = [("plan:psum", 8192, 3000, True, 64, True, 96), ("plan:psum", 100, 100, False,
                                                            0, False, 0),
            ("plan:zero1", 4096, 2001, False, 32, True, 10), ("ag", 7, 3, False, 0, False, 5)]
    mk = lambda cls: [cls(name=n, axis="data", raw_bytes=r, wire_bytes=w, fused=f,  # noqa
                          decode_hbm_bytes=d, encode_fused=ef, encode_hbm_bytes=e)
                      for n, r, w, f, d, ef, e in rows]
    got, want = summarize_wire_reports(mk(WireReport)), jsummarize(mk(JWireReport))
    assert got == want
    assert summarize_wire_reports([]) == jsummarize([])


def test_ledger_exactness_flags_diffs():
    """A ledger entry with no plan counterpart, and a doctored report whose
    bytes the ledger does not hold, are both reported diffs."""
    reports = _port_psum_window()
    bad = [r if not r.name.startswith("plan:") else WireReport(
        name=r.name, axis=r.axis, raw_bytes=r.raw_bytes, wire_bytes=r.wire_bytes + 1)
        for r in reports]
    res = regret_lib.check_ledger_exactness(bad)
    assert not res["ok"] and res["diffs"]["psum"]["reports"][1] == \
        res["diffs"]["psum"]["ledger"][1] + 1
    obs.reset()
    obs.metric("bucket_wire_raw_bytes_total").inc(100, kind="psum", dtype="float32", width=5)
    obs.metric("bucket_wire_bytes_total").inc(40, kind="psum", dtype="float32", width=5)
    res = regret_lib.check_ledger_exactness([])
    assert not res["ok"] and res["diffs"]["psum"] == {"ledger": (100, 40), "reports": None}
    # host kinds stay out of the plan-kind check
    obs.reset()
    obs.metric("bucket_wire_bytes_total").inc(40, kind="wsync_host", dtype="bfloat16",
                                              width=2)
    assert regret_lib.check_ledger_exactness([])["ok"]


def test_plan_wire_ratio_hist_and_drift_observation():
    _port_psum_window()
    snap = obs.snapshot()
    h = snap["histograms"]["plan_wire_ratio_hist"]["kind=psum"]
    assert h["count"] == 1
    assert snap["gauges"]["plan_wire_ratio"]["kind=psum"] == pytest.approx(h["sum"])
    assert len(obs.recorder().samples("plan_wire_ratio_hist", kind="psum")) == 1
    st = drift_lib.detector()._state
    assert len(st) == 1
    (ks,) = st.values()
    assert ks.kind == "psum" and list(ks.ring) == [pytest.approx(1.0)]
    assert drift_lib.detector().report().events == ()


# ---------------------------------------------------------------------------
# samples + width regret
# ---------------------------------------------------------------------------

def test_sample_store_downsamples_and_bounds():
    big = np.arange(regret_lib.SAMPLE_MAX_ELEMS * 4 + 5, dtype=np.float32)
    regret_lib.record_sample("k", "float32", big, base=big + 1)
    jobs.regret.record_sample("k", "float32", big, base=big + 1)
    (s,), (js,) = regret_lib.samples()[("k", "float32")], jobs.regret.samples()[("k", "float32")]
    assert s.elems == js.elems == big.size and s.x.numel() <= regret_lib.SAMPLE_MAX_ELEMS
    assert np.array_equal(s.x.numpy(), js.x) and np.array_equal(s.base.numpy(), js.base)
    assert torch.equal(s.base, s.x + 1)  # element pairing survives the stride
    for i in range(regret_lib.SAMPLE_CAPACITY + 3):
        regret_lib.record_sample("k", "float32", np.ones(4, np.float32) * i)
    ring = regret_lib.samples()[("k", "float32")]
    assert len(ring) == regret_lib.SAMPLE_CAPACITY
    assert [float(e.x[0]) for e in ring] == list(range(3, regret_lib.SAMPLE_CAPACITY + 3))


def _record_both(kind, dtype, bits, base_bits=None, n_ledger=(1000, 700, 5)):
    """The same payload (bits of ``dtype``) into both sample stores, and the
    same ledger row into both registries."""
    raw, wire, width = n_ledger
    for o in (obs, jobs):
        o.metric("bucket_wire_raw_bytes_total").inc(raw, kind=kind, dtype=dtype, width=width)
        o.metric("bucket_wire_bytes_total").inc(wire, kind=kind, dtype=dtype, width=width)
    from torch_port_util import to_jax

    regret_lib.record_sample(kind, dtype, to_torch(bits, dtype),
                             base=None if base_bits is None else to_torch(base_bits, dtype))
    jobs.regret.record_sample(kind, dtype, to_jax(bits, dtype),
                              base=None if base_bits is None else to_jax(base_bits, dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16", "float8_e4m3fn"])
def test_regret_rows_equal_the_reference(dtype):
    from torch_port_util import grad_like_bits

    n = 70_000 if dtype == "bfloat16" else 9000  # bf16: one strided sample
    a = grad_like_bits(dtype, n, seed=5, specials=False)
    b = grad_like_bits(dtype, n, seed=6, specials=False)
    _record_both("wsync_host", dtype, a, b, (n * 2, n, 5))
    _record_both("wsync_host", dtype, b, None, (n * 2, n + 17, 2))
    _record_both("p2p_host", dtype, a, None, (999, 500, 4))
    rows, jrows = regret_lib.width_regret(), jobs.regret.width_regret()
    assert len(rows) == len(jrows) == 2
    for r, j in zip(rows, jrows):
        got, want = r.to_dict(), j.to_dict()
        _approx_dict(got, want)
        json.dumps(got)
    assert rows[0].optimal_delta_widths is not None or rows[1].optimal_delta_widths is not None


# ---------------------------------------------------------------------------
# the weight-sync host path on the reference's workload
# ---------------------------------------------------------------------------

def _sync_workloads(n=4096, warm=3, shifted=0, shift_scale=0.5):
    """The reference test's ``_sync_workload`` run by the reference; the
    port publishes the same bits at the same calibrated widths."""
    from benchmarks.fig_sync import _calibrated_policy, _make_params, _optimizer_step

    from repro.sync import WeightSyncEngine as JWeightSyncEngine
    from repro.sync import apply_update as japply_update

    params = _make_params(n, seed=7)
    v1 = _optimizer_step(params, 2e-4, seed=8)
    jpolicy, (w, wl) = _calibrated_policy(params, v1)
    jeng = JWeightSyncEngine(policy=jpolicy)
    eng = WeightSyncEngine(policy=CompressionPolicy(min_bytes=0, profile=CompressionProfile(
        widths={"gradient": 5, "weight": 5, "activation": 5, "delta": w, "delta_lo": wl})))
    held = jheld = None
    modes = []
    for it in range(warm + shifted):
        if 0 < it < warm:
            params = _optimizer_step(params, 2e-4, seed=10 + it)
        elif it >= warm:
            params = _optimizer_step(params, shift_scale, seed=50 + it)
        jeng.publish(params)
        eng.publish({k: numpy_to_torch(np.asarray(v), torch.bfloat16)
                     if v.dtype == jnp.bfloat16 else torch.from_numpy(np.array(v))
                     for k, v in params.items()})
        jupd, upd = jeng.update_for("r0"), eng.update_for("r0")
        jheld = japply_update(jupd, base_params=jheld if jupd.base_version is not None
                              else None)
        held = apply_update(upd, base_params=held if upd.base_version is not None else None,
                            device="cpu")
        jeng.ack("r0", jupd.version, jupd.epoch)
        eng.ack("r0", upd.version, upd.epoch)
        assert (upd.mode, upd.wire_bytes) == (jupd.mode, jupd.wire_bytes)
        modes.append(upd.mode)
    for k in ("wq", "wk", "wv"):
        assert np.array_equal(np_of(held[k]), np_of(jheld[k]))
    return modes


def _drift_dicts(report) -> dict:
    d = report.to_dict()
    for part in d.values():
        for e in part:
            e.pop("key_hex")
    return d


def test_wsync_host_ledger_samples_regret_and_drift_match_the_reference():
    modes = _sync_workloads(warm=3)
    assert "delta" in modes
    led = regret_lib.ledger_totals()
    assert led == jobs.regret.ledger_totals()
    assert 0 < led["by_kind"]["wsync_host"]["ratio"] < 1
    assert regret_lib.check_ledger_exactness([])["ok"]
    samp, jsamp = regret_lib.samples(), jobs.regret.samples()
    assert set(samp) == set(jsamp) == {("wsync_host", "bfloat16")}
    for s, js in zip(samp[("wsync_host", "bfloat16")], jsamp[("wsync_host", "bfloat16")]):
        assert s.elems == js.elems and np.array_equal(np_of(s.x), np_of(js.x))
        assert (s.base is None) == (js.base is None)
        if s.base is not None:
            assert np.array_equal(np_of(s.base), np_of(js.base))
    rows, jrows = regret_lib.width_regret(), jobs.regret.width_regret()
    assert len(rows) == len(jrows) == 1 and rows[0].optimal_delta_widths is not None
    _approx_dict(rows[0].to_dict(), jrows[0].to_dict())
    assert _drift_dicts(drift_lib.detector().report()) == \
        _drift_dicts(jobs.drift.detector().report())
    counters = obs.snapshot()["counters"]
    assert counters == jobs.snapshot()["counters"]


def test_sync_engine_drift_fires_on_entropy_shift_as_the_reference():
    modes = _sync_workloads(warm=4, shifted=2)
    assert modes[-1] == "full"
    rep = drift_lib.detector().report()
    assert len(rep.events) >= 1 and rep.events[0].kind == "wsync"
    assert rep.stale and rep.stale[0].live_ratio > rep.stale[0].predicted_ratio
    assert _drift_dicts(rep) == _drift_dicts(jobs.drift.detector().report())
    assert obs.snapshot()["counters"]["wire_drift_events_total"] == \
        jobs.snapshot()["counters"]["wire_drift_events_total"]


# ---------------------------------------------------------------------------
# drift detection
# ---------------------------------------------------------------------------

def _drift_script(det, o):
    fired = []
    fired += [det.observe("k", "psum", 0.5, 0.5) for _ in range(5)]
    fired += [det.observe("k", "psum", 0.5, 1.0) for _ in range(4)]
    stale_mid = _drift_dicts(det.report())
    fired += [det.observe("k", "psum", 0.5, 0.5) for _ in range(6)]
    fired += [det.observe("k", "psum", 0.5, 1.0) for _ in range(4)]
    fired += [det.observe("k2", "wsync", 0.8, 0.8)]
    fired += [det.observe("k2", "wsync", 0.2, 0.2) for _ in range(10)]
    fired += [det.observe("k3", "kv", 0.0, 5.0) for _ in range(3)]
    fired += [o.drift.observe("m", "wsync", 0.1, 1.0) for _ in range(3)]
    return fired, stale_mid, _drift_dicts(det.report())


def test_drift_detector_matches_the_reference():
    det = DriftDetector(window=4, min_count=2, enter=0.2, exit=0.05)
    jdet = JDriftDetector(window=4, min_count=2, enter=0.2, exit=0.05)
    got, want = _drift_script(det, obs), _drift_script(jdet, jobs)
    assert got == want
    fired, stale_mid, final = got
    assert sum(fired[5:9]) == 1 and sum(fired[15:19]) == 1 and fired[-1] is True
    assert len(stale_mid["stale"]) == 1 and len(final["events"]) == 2
    assert obs.snapshot()["counters"]["wire_drift_events_total"] == \
        jobs.snapshot()["counters"]["wire_drift_events_total"] == \
        {"kind=psum": 2, "kind=wsync": 1}
    assert [s.name for s in obs.spans()] == [s.name for s in jobs.spans()]
    with pytest.raises(ValueError):
        DriftDetector(enter=0.1, exit=0.2)


def test_drift_stationary_jitter_never_fires():
    det = DriftDetector()
    for i in range(50):
        assert det.observe("k", "psum", 0.5, 0.5 * (1.01 if i % 2 else 0.99)) is False
    assert det.report().events == ()


# ---------------------------------------------------------------------------
# disabled mode, clearing, the report
# ---------------------------------------------------------------------------

def test_disabled_mode_noops():
    obs.set_enabled(False)
    obs.metric("plan_exec_total").inc(kind="psum")
    assert obs.recorder().series() == ()
    regret_lib.record_sample("k", "float32", np.zeros(8, np.float32))
    assert regret_lib.samples() == {}
    assert [drift_lib.observe("k", "psum", 0.5, 5.0) for _ in range(3)] == [False] * 3
    assert drift_lib.detector().report() == drift_lib.DriftReport((), ())
    with pytest.raises(KeyError):
        obs.metric("not_a_metric")


def test_clear_observatory_keeps_registry():
    obs.metric("plan_exec_total").inc(kind="psum")
    regret_lib.record_sample("k", "float32", np.zeros(8, np.float32))
    drift_lib.observe("k", "psum", 0.5, 5.0)
    obs.clear_observatory()
    assert obs.recorder().series() == () and regret_lib.samples() == {}
    assert drift_lib.detector()._state == {}
    assert obs.snapshot()["counters"]["plan_exec_total"] == {"kind=psum": 1}


def test_dump_report_artifacts(tmp_path):
    paths = dump.dump("sync", str(tmp_path), steps=2, report=True, device="cpu")
    assert set(paths) >= {"report_json", "report_md"}
    rep = json.load(open(paths["report_json"]))
    assert set(rep) == {"regret", "drift", "ledger_by_kind", "ledger_by_bucket",
                        "ratio_series"}
    assert any(k.startswith("wsync_host/") for k in rep["ledger_by_bucket"])
    md = open(paths["report_md"]).read()
    assert md.startswith("# Wire-efficiency observatory")
    assert "regret" in md and "Drift" in md
    md = dump.report_to_markdown({"regret": [], "drift": {"events": [], "stale": []},
                                  "ratio_series": {}})
    from repro.obs.dump import report_to_markdown as jreport_to_markdown

    assert md == jreport_to_markdown({"regret": [], "drift": {"events": [], "stale": []},
                                      "ratio_series": {}})


# ---------------------------------------------------------------------------
# the fleet and its faults
# ---------------------------------------------------------------------------

FLEET_METRICS = ("fleet_retries_total", "fleet_escalations_total", "fleet_quarantines_total",
                 "fleet_rounds_total", "fleet_live_replicas", "fleet_convergence_rounds",
                 "fleet_trainer_egress_bytes_total", "fleet_forwards_total",
                 "fleet_forwarded_bytes_total", "fleet_hop_depth", "fleet_reparents_total",
                 "fault_injected_total", "sync_integrity_failures_total")


def _scripted(side, tmp):
    # msg 0 = r0's update (corrupt -> nack -> escalate), msg 3 = r1's ack
    # (drop -> timeout retry)
    fleet = side.fleet(("r0", "r1"), plan=side.faults.FaultPlan.scripted(
        {0: "corrupt", 3: "drop"}), ckpt_dir=str(tmp))
    fleet.publish(side.tree(fleet_params_np()))
    fleet.settle()
    return fleet


def _fault_free(side, tmp):
    fleet = side.fleet(("r0", "r1", "r2", "r3"), broadcast="tree", fanout=2,
                       ckpt_dir=str(tmp))
    p = fleet_params_np()
    fleet.publish(side.tree(p))
    fleet.settle()
    fleet.publish(side.tree(perturb_np(p)))
    fleet.settle()
    return fleet


def _chaos7(side, tmp):
    names = ("r0", "r1", "r2", "r3")
    cfg = side.faults.FaultConfig(seed=7, rounds=10, drop_rate=0.1, corrupt_rate=0.1,
                                  delay_rate=0.1, max_delay=2, kills=1, joins=1,
                                  trainer_restarts=1, replicas=names)
    fleet = side.fleet(names, plan=side.faults.FaultPlan.generate(cfg), broadcast="tree",
                       fanout=2, max_retries=30, backoff_cap=2, ckpt_dir=str(tmp))
    p = fleet_params_np(seed=7)
    for r in range(10):
        if r % 3 == 0:
            p = perturb_np(p, seed=100 + r)
            fleet.publish(side.tree(p))
        fleet.round()
    fleet.settle(max_rounds=80)
    return fleet


@pytest.mark.parametrize("scenario", [_scripted, _fault_free, _chaos7],
                         ids=["scripted", "fault_free", "chaos_seed7"])
def test_fleet_obs_accounting_matches_the_reference(scenario, tmp_path):
    fleet = scenario(PORT, tmp_path / "port")
    jfleet = scenario(REF, tmp_path / "ref")
    assert fleet.verify_bitexact() and jfleet.verify_bitexact()
    assert fleet.stats == jfleet.stats
    snap, jsnap = obs.snapshot(), jobs.snapshot()
    for kind in ("counters", "gauges"):
        for name in FLEET_METRICS:
            assert snap[kind].get(name) == jsnap[kind].get(name), (kind, name)
    counters = snap["counters"]
    assert counters["fleet_rounds_total"][""] > 0
    assert counters.get("fleet_retries_total", {}).get("", 0) == fleet.stats["retries"]
    assert counters["fleet_trainer_egress_bytes_total"][""] == \
        fleet.stats["trainer_egress_bytes"]
    spans = [(s.name, s.ph) for s in obs.spans() if s.name.split(":")[0] in ("fleet",
                                                                              "fault")]
    assert spans == [(s.name, s.ph) for s in jobs.spans()
                     if s.name.split(":")[0] in ("fleet", "fault")]
    if scenario is _scripted:
        assert counters["fault_injected_total"] == {"kind=corrupt": 1, "kind=drop": 1}
        assert counters["sync_integrity_failures_total"] == {"reason=checksum": 1}
        assert counters["fleet_escalations_total"] == {"to=full": 1}
    if scenario is _chaos7:
        assert sum(counters["fault_injected_total"].values()) == \
            sum(fleet.wire.counts.values()) > 0
        assert any(n == "fleet:restart" for n, _ in spans)
