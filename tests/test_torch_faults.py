"""The port's fault injection and weight-sync fleet
(``repro_torch.runtime.faults``, ``repro_torch.sync.fleet``) held against the
reference's (``repro.runtime.faults``, ``repro.sync.fleet``) on the same
seeded inputs; mirrors ``tests/test_faults.py``:

  * ``FaultPlan.generate`` and ``scripted``: the same lifecycle events and
    the same first 200 message faults for several seeds;
  * ``FaultyWire``: pass-through, drop, delay, corrupt a copy;
  * ``corrupt_payload`` flips the reference's bucket, field and bit on the
    same payload and seed, for a ``SyncUpdate`` (each mode), a
    ``RoutedUpdate`` and a KV wire;
  * every fleet scenario of ``tests/test_faults.py`` but the obs one, run by
    both packages on the same publishes: trace, stats, integrity ledger, wire
    counts, each replica's state and weight bits all equal, and the
    reference test's own checks on the port's fleet;
  * ``ServeEngine``'s KV-ship retry with ``corrupt_payload`` as its
    ``kv_fault_injector``.

The port runs on the CPU (``device="cpu"``).  Tolerance: none.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import CompressionPolicy as JPolicy
from repro.models import transformer as jtransformer
from repro.p2p.engine import Compressor as JCompressor
from repro.runtime import faults as jfaults
from repro.serve import kv_transfer as jkv_transfer
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.sync import RoutedUpdate as JRoutedUpdate
from repro.sync import WeightSyncEngine as JWeightSyncEngine
from repro_torch import configs
from repro_torch.core.integrity import WireIntegrityError
from repro_torch.core.policy import CompressionPolicy
from repro_torch.models import transformer
from repro_torch.p2p.engine import Compressor
from repro_torch.runtime import faults
from repro_torch.runtime.faults import (FaultConfig, FaultEvent, FaultPlan, FaultyWire,
                                        corrupt_payload)
from repro_torch.serve import kv_transfer
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.sync import (RoutedUpdate, WeightSyncEngine, apply_update,
                              verify_update)
from repro_torch.tree_util import bits_equal, tree_leaves
from torch_port_util import (FleetSide, fleet_params_np, fleet_summary, np_of,
                             perturb_np)

POL, JPOL = CompressionPolicy(min_bytes=0), JPolicy(min_bytes=0)
REF, PORT = FleetSide(port=False), FleetSide(port=True)


def _sides(fn, tmp_path):
    """``fn(side, tmp)`` run by the reference and by the port: (reference
    fleet, port fleet)."""
    return (fn(REF, tmp_path / "ref"), fn(PORT, tmp_path / "port"))


def assert_fleets_equal(jfleet, fleet):
    want, got = fleet_summary(jfleet, REF), fleet_summary(fleet, PORT)
    for k in want:
        assert got[k] == want[k], (k, got[k] if k != "replicas" else "bits or state",
                                   want[k] if k != "replicas" else "")


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

def _fault_cfgs(seed):
    kw = dict(seed=seed, rounds=10, drop_rate=0.2, corrupt_rate=0.2, delay_rate=0.2,
              max_delay=3, kills=2, joins=1, trainer_restarts=1, replicas=("a", "b", "c"))
    return FaultConfig(**kw), jfaults.FaultConfig(**kw)


@pytest.mark.parametrize("seed", [0, 3, 7, 13, 29])
def test_fault_plan_generate_matches_reference(seed):
    cfg, jcfg = _fault_cfgs(seed)
    plan, jplan = FaultPlan.generate(cfg), jfaults.FaultPlan.generate(jcfg)
    assert [dataclasses.astuple(e) for e in plan.events] == [
        dataclasses.astuple(e) for e in jplan.events]
    assert len(plan.events) == 4
    for r in range(1, 13):
        assert plan.events_for_round(r) == tuple(
            FaultEvent(*dataclasses.astuple(e)) for e in jplan.events_for_round(r))
    # the first 200 message faults, rounds 1-12 (past the 10-round horizon too)
    got = [plan.message_fault(1 + i // 17) for i in range(200)]
    want = [jplan.message_fault(1 + i // 17) for i in range(200)]
    assert got == want and plan.msg_index == jplan.msg_index == 199
    assert {f[0] for f in got if f} == {"drop", "corrupt", "delay"}
    assert all(f is None for f in got[170:])  # round 11 on: the quiet wire
    # the corruption stream is the reference's too
    assert plan.corrupt_rng.integers(1 << 30, size=8).tolist() == \
        jplan.corrupt_rng.integers(1 << 30, size=8).tolist()


def test_fault_plan_scripted_and_errors_match_reference():
    script = {0: "drop", 2: ("delay", 3), 3: "corrupt", 5: "delay"}
    plan, jplan = FaultPlan.scripted(script), jfaults.FaultPlan.scripted(script)
    assert [plan.message_fault(1) for _ in range(8)] == [
        jplan.message_fault(1) for _ in range(8)]
    with pytest.raises(ValueError):
        FaultPlan.scripted({0: "explode"})
    with pytest.raises(ValueError, match="replicas"):
        FaultPlan.generate(FaultConfig(kills=1))
    horizon = FaultPlan.generate(FaultConfig(seed=0, rounds=4, drop_rate=1.0))
    assert horizon.message_fault(1) == ("drop", 0) and horizon.message_fault(5) is None


# ---------------------------------------------------------------------------
# FaultyWire
# ---------------------------------------------------------------------------

def test_faulty_wire_passthrough_drop_and_delay():
    w = FaultyWire(None)
    for dst, x in (("r0", 1), ("r0", 2), ("r1", 3)):
        w.send(dst, {"x": x})
    assert w.drain("r0") == [{"x": 1}, {"x": 2}]
    assert w.drain("r1", with_flags=True) == [({"x": 3}, False)]
    assert w.drain("r0") == [] and w.pending() == 0 and w.sent == 3
    assert all(c == 0 for c in w.counts.values())

    w = FaultyWire(FaultPlan.scripted({0: "drop", 1: ("delay", 2)}))
    for x in ("lost", "late", "now"):
        w.send("r0", x)
    assert w.drain("r0") == ["now"] and w.pending() == 1
    w.advance_round()
    assert w.drain("r0") == []
    w.advance_round()
    assert w.drain("r0") == ["late"]
    assert w.counts == {"drop": 1, "corrupt": 0, "delay": 1} and w.pending() == 0


def test_faulty_wire_corrupts_copies_not_originals():
    eng = WeightSyncEngine(policy=POL)
    params = PORT.tree(fleet_params_np())
    eng.publish(params)
    update = eng.update_for("r0")
    w = FaultyWire(FaultPlan.scripted({0: "corrupt", 1: "corrupt"}))
    w.send("r0", update)
    w.send("r0", {"type": "ack", "version": 1})  # nothing to corrupt: delivered
    [(bad, flag), (ack, ack_flag)] = w.drain("r0", with_flags=True)
    assert flag and not verify_update(bad)
    assert not ack_flag and ack == {"type": "ack", "version": 1}
    assert w.counts["corrupt"] == 1
    assert verify_update(update)  # the memoised original is untouched
    assert bits_equal(apply_update(update, device="cpu"), params)


# ---------------------------------------------------------------------------
# corrupt_payload: the reference's leaf and bit
# ---------------------------------------------------------------------------

def _flipped(a, b, leaves=faults._message_leaves):
    """[(bucket or leaf, field index, byte offset, xor)] where two updates'
    payloads differ; ``leaves`` lists a bucket message's arrays."""
    out = []
    for bi, ((_, _, _, ma), (_, _, _, mb)) in enumerate(zip(a.buckets, b.buckets)):
        la, lb = leaves(ma), leaves(mb)
        for fi, (x, y) in enumerate(zip(la, lb)):
            xb, yb = np.asarray(x).tobytes(), np.asarray(y).tobytes()
            out += [(bi, fi, i, xb[i] ^ yb[i]) for i in range(len(xb)) if xb[i] != yb[i]]
    for li, ((_, x), (_, y)) in enumerate(zip(a.raw_leaves, b.raw_leaves)):
        xb, yb = np.asarray(x).tobytes(), np.asarray(y).tobytes()
        out += [("raw", li, i, xb[i] ^ yb[i]) for i in range(len(xb)) if xb[i] != yb[i]]
    return out


def _engines_at(force, delta):
    p1 = fleet_params_np()
    eng, jeng = WeightSyncEngine(policy=POL), JWeightSyncEngine(policy=JPOL)
    for e, side in ((eng, PORT), (jeng, REF)):
        e.publish(side.tree(p1))
        if delta:
            e.ack("r0", 1)
            e.publish(side.tree(perturb_np(p1)))
    return eng.update_for("r0", force=force), jeng.update_for("r0", force=force)


@pytest.mark.parametrize("force,delta", [(None, False), (None, True), ("full", True),
                                         ("raw", False)])
def test_corrupt_payload_flips_the_reference_bit(force, delta):
    u, ju = _engines_at(force, delta)
    assert [m for _, _, m, _ in u.buckets] == [m for _, _, m, _ in ju.buckets]
    # the same leaves, in the same order, at the same sizes and dtypes
    for (_, _, _, m), (_, _, _, jm) in zip(u.buckets, ju.buckets):
        got = [(np.asarray(a).dtype, np.asarray(a).shape) for a in faults._message_leaves(m)]
        want = [(np.asarray(a).dtype, np.asarray(a).shape)
                for a in jax.tree_util.tree_leaves(jm)]
        assert got == want
    for seed in range(12):
        bad = corrupt_payload(u, np.random.default_rng(seed))
        jbad = jfaults.corrupt_payload(ju, np.random.default_rng(seed))
        flips = _flipped(u, bad)
        assert flips == _flipped(ju, jbad, jax.tree_util.tree_leaves) and len(flips) == 1
        assert bin(flips[0][3]).count("1") == 1
        assert not verify_update(bad) and bad.checksum == u.checksum
    assert verify_update(u)  # the original is untouched
    # a routed envelope: the inner update is damaged, the route is not
    ru = RoutedUpdate(u, (("r1", ()),), hop=1)
    jru = JRoutedUpdate(ju, (("r1", ()),), hop=1)
    bad = corrupt_payload(ru, np.random.default_rng(0))
    jbad = jfaults.corrupt_payload(jru, np.random.default_rng(0))
    assert isinstance(bad, RoutedUpdate) and (bad.route, bad.hop) == (ru.route, ru.hop)
    assert _flipped(u, bad.update) == _flipped(ju, jbad.update, jax.tree_util.tree_leaves)
    assert not verify_update(bad.update) and verify_update(u)
    rng = np.random.default_rng(0)
    assert corrupt_payload({"type": "ack", "version": 3}, rng) is None


def _kv_cache_np():
    rng = np.random.default_rng(2)
    return {"k": np.asarray(jnp.asarray(rng.normal(0, 1, (4, 64)), jnp.bfloat16)),
            "v": np.asarray(jnp.asarray(rng.normal(0, 1, (4, 64)), jnp.bfloat16)),
            "pos": np.asarray(3, np.int32)}


def test_corrupt_payload_kv_wire_matches_reference():
    cache_np = _kv_cache_np()
    cache, jcache = PORT.tree(cache_np), REF.tree(cache_np)
    comp, jcomp = Compressor(codec_name="packed", device="cpu"), JCompressor(codec_name="packed")
    wire, jwire = kv_transfer.pack_cache(cache, comp), jkv_transfer.pack_cache(jcache, jcomp)
    # (the checksums differ: they cover each message's encode times)
    for m, jm in zip(wire["messages"], jwire["messages"]):
        got, want = faults._host_leaves(m), jfaults._host_leaves(jm)
        assert [(p, a.dtype, a.shape) for p, a in got] == [
            (p, a.dtype, a.shape) for p, a in want]
    raised = 0
    for seed in range(10):
        try:
            jbad = jfaults.corrupt_payload(jwire, np.random.default_rng(seed))
        except ValueError:
            # the reference cannot replace a raw message (the 0-d position
            # leaf is the whole message) and raises; so does the port
            with pytest.raises(ValueError, match="root payload"):
                corrupt_payload(wire, np.random.default_rng(seed))
            raised += 1
            continue
        bad = corrupt_payload(wire, np.random.default_rng(seed))
        assert not kv_transfer.verify_wire(bad) and not jkv_transfer.verify_wire(jbad)
        diffs = [(i, p) for i, (m, b) in enumerate(zip(wire["messages"], bad["messages"]))
                 for (p, x), (_, y) in zip(faults._host_leaves(m), faults._host_leaves(b))
                 if x.tobytes() != y.tobytes()]
        jdiffs = [(i, p) for i, (m, b) in enumerate(zip(jwire["messages"], jbad["messages"]))
                  for (p, x), (_, y) in zip(jfaults._host_leaves(m), jfaults._host_leaves(b))
                  if x.tobytes() != y.tobytes()]
        assert diffs == jdiffs and len(diffs) == 1
        i, path = diffs[0]
        x = dict(faults._host_leaves(bad["messages"][i]))[path]
        jx = dict(jfaults._host_leaves(jbad["messages"][i]))[path]
        assert x.tobytes() == jx.tobytes()
        with pytest.raises(WireIntegrityError):
            kv_transfer.unpack_cache(bad, comp)
    assert 0 < raised < 10
    assert kv_transfer.verify_wire(wire)  # the original survives its copies


# ---------------------------------------------------------------------------
# the fleet scenarios of tests/test_faults.py, run by both packages
# ---------------------------------------------------------------------------

def _fleet(side, tmp, names=("r0", "r1"), plan=None, **cfg_kw):
    return side.fleet(names, plan=plan, ckpt_dir=str(tmp), **cfg_kw)


def happy_path(side, tmp):
    fleet = _fleet(side, tmp)
    p1 = fleet_params_np()
    fleet.publish(side.tree(p1))
    assert fleet.settle() == 1 and fleet.verify_bitexact()
    fleet.publish(side.tree(perturb_np(p1)))
    fleet.settle()
    assert fleet.verify_bitexact()
    assert all(r.applied == 2 for r in fleet.replicas.values())
    assert fleet.stats["retries"] == 0 and fleet.stats["nacks"] == 0
    return fleet


def dropped_update(side, tmp):
    fleet = _fleet(side, tmp, plan=side.faults.FaultPlan.scripted({0: "drop"}))
    fleet.publish(side.tree(fleet_params_np()))
    assert fleet.settle() >= 2 and fleet.verify_bitexact()
    assert fleet.stats["timeouts"] == 1 and fleet.stats["retries"] == 1
    assert fleet.stats["escalations"] == 0
    return fleet


def dropped_ack(side, tmp):
    fleet = _fleet(side, tmp, plan=side.faults.FaultPlan.scripted({2: "drop"}))
    fleet.publish(side.tree(fleet_params_np()))
    fleet.settle()
    assert fleet.verify_bitexact()
    assert fleet.replicas["r0"].applied == 1 and fleet.replicas["r0"].stale_seen == 1
    return fleet


def corrupted_delta(side, tmp):
    fleet = _fleet(side, tmp)
    fleet.wire.plan = side.faults.FaultPlan.scripted({4: "corrupt"})
    p1 = fleet_params_np()
    fleet.publish(side.tree(p1))
    fleet.settle()
    fleet.publish(side.tree(perturb_np(p1)))
    fleet.settle()
    led = fleet.integrity_ledger()
    assert fleet.verify_bitexact() and led["seen"] == led["detected"] == 1
    assert led["silent"] == 0 and fleet.stats["escalations"] == 1
    return fleet


def kill_join(side, tmp):
    F = side.faults
    fleet = _fleet(side, tmp, plan=F.FaultPlan(events=[F.FaultEvent(2, "kill", "r1"),
                                                       F.FaultEvent(3, "join", "r2")]))
    fleet.publish(side.tree(fleet_params_np()))
    fleet.settle()
    fleet.round()
    assert fleet.live_replicas() == ("r0",)
    fleet.round()
    fleet.settle()
    assert fleet.live_replicas() == ("r0", "r2") and fleet.verify_bitexact()
    assert fleet.replicas["r2"].applied == 1 and fleet.replicas["r1"].params is None
    return fleet


def trainer_restart(side, tmp):
    F = side.faults
    fleet = _fleet(side, tmp, plan=F.FaultPlan(events=[F.FaultEvent(4, "trainer_restart")]),
                   ckpt_every_publishes=2)
    p = fleet_params_np()
    for i in range(3):  # a snapshot at publish 2 only
        p = perturb_np(p, seed=10 + i)
        fleet.publish(side.tree(p))
        fleet.round()
    assert fleet.engine.store.version == 3
    fleet.round()  # round 4: the restart rewinds v3 -> v2 and fences
    assert (fleet.engine.store.version, fleet.engine.store.epoch) == (2, 1)
    fleet.settle()
    assert fleet.stats["trainer_restarts"] == 1 and fleet.verify_bitexact()
    assert all(r.epoch == 1 for r in fleet.replicas.values())
    return fleet


def quarantine(side, tmp):
    plan = side.faults.FaultPlan.scripted({i: "corrupt" for i in range(0, 200, 2)})
    fleet = _fleet(side, tmp, names=("r0",), max_retries=3, backoff_base=0,
                   backoff_cap=1, plan=plan)
    fleet.publish(side.tree(fleet_params_np()))
    fleet.settle(max_rounds=50)
    assert fleet.stats["quarantines"] == 1 and fleet._links["r0"].quarantined
    assert fleet.stats["max_link_failures"] == 4
    led = fleet.integrity_ledger()
    assert led["silent"] == 0 and led["detected"] == led["seen"]
    return fleet


def _chaos(seed):
    def run(side, tmp):
        shutil.rmtree(tmp, ignore_errors=True)
        names = ("r0", "r1", "r2")
        cfg = side.faults.FaultConfig(
            seed=seed, rounds=10, drop_rate=0.12, corrupt_rate=0.12, delay_rate=0.12,
            max_delay=2, kills=1, joins=1, trainer_restarts=1, replicas=names)
        fleet = _fleet(side, tmp, names=names, plan=side.faults.FaultPlan.generate(cfg),
                       ckpt_every_publishes=2)
        p = fleet_params_np(seed=seed)
        for r in range(10):
            if r % 2 == 0:
                p = perturb_np(p, seed=100 + r)
                fleet.publish(side.tree(p))
            fleet.round()
        fleet.settle()
        led = fleet.integrity_ledger()
        assert fleet.converged() and fleet.verify_bitexact() and led["silent"] == 0
        assert led["injected"] == led["seen"] + led["lost"]
        assert fleet.stats["quarantines"] == 0 and fleet.stats["trainer_restarts"] == 1
        assert fleet.stats["max_link_failures"] <= fleet.cfg.max_retries
        return fleet
    return run


def corrupted_forward(side, tmp):
    fleet = _fleet(side, tmp, names=("r0", "r1", "r2"), broadcast="pipeline",
                   plan=side.faults.FaultPlan.scripted({2: "corrupt"}))
    fleet.publish(side.tree(fleet_params_np()))
    fleet.settle()
    assert fleet.verify_bitexact()
    assert fleet.replicas["r1"].rejects["checksum"] == 1
    assert fleet.replicas["r2"].rejects["checksum"] == 0  # never spread
    led = fleet.integrity_ledger()
    assert led["injected"] == led["seen"] == led["detected"] == 1
    assert led["silent"] == 0 and led["lost"] == 0 and fleet.stats["escalations"] == 1
    return fleet


def dead_interior(side, tmp):
    fleet = _fleet(side, tmp, names=("r0", "r1", "r2"), broadcast="pipeline")
    p1 = fleet_params_np()
    fleet.publish(side.tree(p1))
    fleet.settle()
    fleet.publish(side.tree(perturb_np(p1)))
    fleet._round += 1
    fleet.wire.advance_round()
    assert fleet._send_updates() == {"r0", "r1", "r2"}
    fleet.kill("r0")
    fleet._deliver_to_replicas()  # evaporates at the dead r0
    fleet._drain_trainer()
    assert fleet._orphans == {"r1", "r2"} and fleet.stats["reparents"] == 2
    fleet.settle()
    assert fleet._orphans == set() and fleet.verify_bitexact()
    assert fleet.replicas["r0"].params is None
    return fleet


def delayed_forward(side, tmp):
    fleet = _fleet(side, tmp, names=("r0", "r1", "r2"), broadcast="pipeline",
                   plan=side.faults.FaultPlan.scripted({4: ("delay", 1)}))
    fleet.publish(side.tree(fleet_params_np()))
    assert fleet.settle() == 2 and fleet.verify_bitexact()
    assert fleet.stats["timeouts"] == 1
    assert (fleet.replicas["r2"].applied, fleet.replicas["r2"].stale_seen) == (1, 1)
    return fleet


def delayed_envelope_killed(side, tmp):
    F = side.faults
    plan = F.FaultPlan.scripted({0: ("delay", 1)}, events=[F.FaultEvent(2, "kill", "r0")])
    fleet = _fleet(side, tmp, names=("r0", "r1", "r2"), broadcast="pipeline", plan=plan)
    fleet.publish(side.tree(fleet_params_np()))
    fleet.settle()
    assert fleet.stats["reparents"] == 2 and fleet.live_replicas() == ("r1", "r2")
    assert fleet.verify_bitexact() and fleet.stats["timeouts"] == 3
    return fleet


def corrupt_envelope_lost(side, tmp):
    fleet = _fleet(side, tmp, names=("r0", "r1", "r2"), broadcast="pipeline",
                   plan=side.faults.FaultPlan.scripted({0: "corrupt"}))
    fleet.publish(side.tree(fleet_params_np()))
    fleet._round += 1
    fleet.wire.advance_round()
    fleet._send_updates()
    fleet.kill("r0")
    fleet._deliver_to_replicas()
    fleet._drain_trainer()
    led = fleet.integrity_ledger()
    assert led["injected"] == led["lost"] == 1 and led["seen"] == led["detected"] == 0
    assert fleet._orphans == {"r1", "r2"}
    fleet.settle()
    assert fleet.verify_bitexact()
    return fleet


def _chaos_broadcast(kind, fanout):
    def run(side, tmp):
        names = ("r0", "r1", "r2", "r3", "r4")
        cfg = side.faults.FaultConfig(seed=29, rounds=12, drop_rate=0.1, corrupt_rate=0.1,
                                      delay_rate=0.1, max_delay=2, kills=1, joins=1,
                                      replicas=names)
        fleet = _fleet(side, tmp, names=names, broadcast=kind, fanout=fanout,
                       max_retries=30, backoff_cap=2,
                       plan=side.faults.FaultPlan.generate(cfg))
        p = fleet_params_np()
        for i in range(4):
            p = perturb_np(p, seed=40 + i)
            fleet.publish(side.tree(p))
            fleet.settle(max_rounds=60)
        led = fleet.integrity_ledger()
        assert fleet.converged() and fleet.verify_bitexact() and led["silent"] == 0
        assert led["injected"] == led["seen"] + led["lost"] and fleet.stats["forwards"] > 0
        return fleet
    return run


SCENARIOS = {
    "happy_path_delta_after_ack": happy_path,
    "dropped_update_times_out_and_retries": dropped_update,
    "dropped_ack_is_reacked_idempotently": dropped_ack,
    "corrupted_delta_escalates_to_full": corrupted_delta,
    "kill_join_and_full_send_to_joiner": kill_join,
    "trainer_restart_rewinds_and_fences": trainer_restart,
    "quarantine_bounds_retries": quarantine,
    "chaos_seed_13": _chaos(13),
    "chaos_seed_14": _chaos(14),
    "corrupted_forward_rejected_at_next_hop": corrupted_forward,
    "dead_interior_reparents_subtree": dead_interior,
    "delayed_forward_times_out_then_converges": delayed_forward,
    "delayed_envelope_matures_at_killed_interior": delayed_envelope_killed,
    "corrupt_envelope_lost_at_dead_interior": corrupt_envelope_lost,
    "chaos_broadcast_tree": _chaos_broadcast("tree", 2),
    "chaos_broadcast_pipeline": _chaos_broadcast("pipeline", 1),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_scenario_matches_reference(name, tmp_path):
    jfleet, fleet = _sides(SCENARIOS[name], tmp_path)
    assert_fleets_equal(jfleet, fleet)
    assert fleet.verify_bitexact() and fleet.integrity_ledger()["silent"] == 0


def test_fleet_chaos_replays_identically(tmp_path):
    """The same seed twice in the port: the same faults and the same trace;
    another seed, another schedule."""
    a, b = _chaos(13)(PORT, tmp_path / "a"), _chaos(13)(PORT, tmp_path / "b")
    assert a.trace == b.trace and a.stats == b.stats and a.wire.counts == b.wire.counts
    c = _chaos(14)(PORT, tmp_path / "c")
    assert c.trace != a.trace or c.wire.counts != a.wire.counts


def test_fleet_and_replicas_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the refusal without a GPU; the card's fleet is a gpu test")
    with pytest.raises(RuntimeError, match="cuda"):
        PORT.sync.SyncFleet(WeightSyncEngine(policy=POL), ("r0",))
    with pytest.raises(RuntimeError, match="cuda"):
        PORT.sync.Replica("r0")


def test_fleet_restart_restores_on_the_fleet_device_and_fences(tmp_path):
    """``restart_trainer`` rebuilds the store from the checkpoint as tensors
    on the fleet's device and advances the epoch; the memoised encodes go."""
    fleet = _fleet(PORT, tmp_path)
    p1 = PORT.tree(fleet_params_np())
    fleet.publish(p1)
    fleet.settle()
    fleet.restart_trainer()
    store = fleet.engine.store
    assert (store.version, store.epoch, store.retained()) == (1, 1, (1,))
    params, _ = store.latest()
    assert all(t.device.type == "cpu" for t in tree_leaves(params))
    assert bits_equal(params, p1) and fleet.engine._updates == {}
    fleet.settle()
    assert fleet.verify_bitexact() and all(r.epoch == 1 for r in fleet.replicas.values())


# ---------------------------------------------------------------------------
# serving: the KV ship's retry, corrupt_payload as its injector
# ---------------------------------------------------------------------------

def test_serve_kv_ship_retries_on_corrupt_payload():
    cfg, jcfg = configs.get_smoke("smollm_135m"), jconfigs.get_smoke("smollm_135m")
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    serve = ServeEngine(cfg, model, ServeConfig(batch_slots=1, max_len=32,
                                                pd_disaggregated=True))
    jserve = JServeEngine(jcfg, jtransformer.init(jax.random.PRNGKey(0), jcfg),
                          JServeConfig(batch_slots=1, max_len=32, pd_disaggregated=True))
    cache = transformer.init_cache(cfg, 1, 32, "cpu")
    jcache = jtransformer.init_cache(jcfg, 1, 32)
    flips = {}

    def injector(tag, corrupt, rng):
        hits = {"n": 0}

        def inject(wire):  # corrupt the first shipment only
            hits["n"] += 1
            if hits["n"] == 1:
                bad = corrupt(wire, rng) or wire
                flips[tag] = sum(x.tobytes() != y.tobytes()
                                 for m, b in zip(wire["messages"], bad["messages"])
                                 for (_, x), (_, y) in zip(faults._host_leaves(m),
                                                           faults._host_leaves(b)))
                return bad
            return wire
        return inject, hits

    serve.kv_fault_injector, hits = injector("port", corrupt_payload,
                                             np.random.default_rng(4))
    jserve.kv_fault_injector, jhits = injector("ref", jfaults.corrupt_payload,
                                               np.random.default_rng(4))
    out, jout = serve._ship_kv(cache), jserve._ship_kv(jcache)
    assert hits["n"] == jhits["n"] == 2  # one reject, one clean retry
    assert flips == {"port": 1, "ref": 1}
    assert bits_equal(out, cache)
    assert [np_of(a).tobytes() for a in tree_leaves(out)] == [
        np_of(a).tobytes() for a in jax.tree_util.tree_leaves(jout)]
    # every try corrupted: a bounded failure, nothing applied
    rng = np.random.default_rng(4)
    serve.kv_fault_injector = lambda w: corrupt_payload(w, rng) or w
    with pytest.raises(WireIntegrityError, match="times"):
        serve._ship_kv(cache)
