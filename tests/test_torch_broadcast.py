"""The port's weight-sync broadcast schedules held against the reference's
(``repro.sched`` and ``repro.sync``); mirrors ``tests/test_broadcast.py``:

  * ``BroadcastSchedule`` / ``compile_broadcast_schedule``: every field and
    method equal to the reference's for every kind, n 0-16 and fanout 1-4;
    normalisation and the validation errors; ``route_for`` and
    ``wsync_hop_perms``, their stale-schedule errors too;
  * the wsync plan with a schedule, field for field against the reference
    compiler, the schedule triple in its key, a cache hit on a stable fleet
    size and a recompile on a changed one;
  * ``execute_wsync_broadcast`` and ``sync/wire.broadcast_weights``: at one
    rank (pipelines over ``(0, 0, 0)`` and ``(0, 0, 0, 0)``, full and
    delta) bit-identical to the reference's inside ``shard_map``; at 4 gloo
    ranks a pipeline over ranks ``(0, .., k)`` delivers the trainer rank's
    bits, flag 0; a star or tree level (a source repeated) raises
    ``ValueError`` on every rank, as the reference's ``ppermute`` refuses it;
  * fleets of each kind without faults: trace, stats and every replica's
    bits equal to the reference fleet's on the same publishes, one encode a
    publish, the egress, forwards and hop depth of the schedule.

The port runs on the CPU.  Tolerance: none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from _compat import given, settings, strategies as st
from repro import sched as jsched
from repro.launch.mesh import make_mesh
from repro.sync import broadcast_weights as jbroadcast_weights
from repro_torch.launch.train import single_process_group
from repro_torch.sched import (BROADCAST_KINDS, BroadcastSchedule, cached_wsync_plan,
                               compile_broadcast_schedule, compile_wsync_plan,
                               execute_wsync_broadcast, wsync_hop_perms)
from repro_torch.sched.cache import PlanCache
from repro_torch.sync import broadcast_weights, sync_weights
from repro_torch.tree_util import bits_equal, tree_flatten
from torch_port_util import (FleetSide, assert_bits_equal, broadcast_rank,
                             fleet_params_np, fleet_summary, np_of, perturb_np, random_bits,
                             run_gloo_ranks, to_jax, weight_trees)

REF, PORT = FleetSide(port=False), FleetSide(port=True)
POL, JPOL = PORT.policy, REF.policy
KINDS = ("star", "tree", "pipeline")
BUCKET_FIELDS = ("dtype_name", "members", "length", "path", "width", "block", "exc_frac",
                 "fused", "encode_fused", "n_dev", "chunk", "wire_bytes", "raw_bytes",
                 "delta_width", "delta_lo_width", "delta_wire_bytes")


def names_of(n):
    return tuple(f"r{i:02d}" for i in range(n))


def small_params(seed=0):
    """``tests/test_broadcast.py::fleet_params``."""
    return fleet_params_np(seed, n_w=768, n_b=192, step=seed)


def jtree_of(tree):
    return {k: jax.lax.bitcast_convert_type(jnp.asarray(np_of(v)),
                                            jnp.dtype(str(v.dtype).removeprefix("torch.")))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# BroadcastSchedule: slot arithmetic against the reference's
# ---------------------------------------------------------------------------

def schedule_facts(s):
    n = s.n_receivers
    return {"record": (s.kind, s.fanout, s.n_receivers), "depth": s.depth,
            "root_degree": s.root_degree, "n_edges": s.n_edges, "edges": s.edges(),
            "levels": s.levels(),
            "children": [s.children_of(i) for i in range(n + 1)],
            "parents": [s.parent_of(i) for i in range(1, n + 1)],
            "hops": [s.hops_to(i) for i in range(n + 1)],
            "route": s.route_for(names_of(n))}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fanout", [1, 2, 3, 4])
def test_schedule_arithmetic_matches_reference(kind, fanout):
    for n in range(17):
        s = compile_broadcast_schedule(n, kind=kind, fanout=fanout)
        js = jsched.compile_broadcast_schedule(n, kind=kind, fanout=fanout)
        assert schedule_facts(s) == schedule_facts(js), (kind, fanout, n)
        assert s == BroadcastSchedule(js.kind, js.fanout, js.n_receivers)
        ranks = tuple(range(100, 101 + n))
        assert wsync_hop_perms(s, ranks) == jsched.wsync_hop_perms(js, ranks)
        assert len(wsync_hop_perms(s, ranks)) == s.depth
        dsts = sorted(d for level in wsync_hop_perms(s, ranks) for _, d in level)
        assert dsts == sorted(ranks[1:])  # every receiver exactly once


@given(st.integers(1, 64), st.integers(1, 8), st.integers(0, 2))
@settings(max_examples=10, deadline=None)
def test_route_for_and_hop_levels_cover_the_fleet(n, fanout, kind_ix):
    s = compile_broadcast_schedule(n, kind=KINDS[kind_ix], fanout=fanout)
    js = jsched.compile_broadcast_schedule(n, kind=KINDS[kind_ix], fanout=fanout)
    assert schedule_facts(s) == schedule_facts(js)
    holders = {0}
    for level in wsync_hop_perms(s, range(n + 1)):
        assert all(src in holders for src, _ in level)  # only a rank that holds it
        holders.update(d for _, d in level)
    assert holders == set(range(n + 1))


def test_schedule_validation_and_normalisation_match_reference():
    assert BROADCAST_KINDS == jsched.BROADCAST_KINDS == KINDS
    for kw in (dict(kind="ring", fanout=2, n_receivers=4),
               dict(kind="tree", fanout=0, n_receivers=4),
               dict(kind="tree", fanout=2, n_receivers=-1),
               dict(kind="star", fanout=2, n_receivers=4),
               dict(kind="pipeline", fanout=2, n_receivers=4)):
        with pytest.raises(ValueError):
            BroadcastSchedule(**kw)
        with pytest.raises(ValueError):
            jsched.BroadcastSchedule(**kw)
    s = compile_broadcast_schedule(4, kind="tree", fanout=2)
    for bad in (lambda: s.parent_of(0), lambda: s.children_of(5),
                lambda: compile_broadcast_schedule(3, kind="mesh"),
                lambda: compile_broadcast_schedule(3, kind="tree", fanout=0)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(ValueError, match="stale broadcast schedule"):
        s.route_for(names_of(3))
    with pytest.raises(ValueError, match="stale broadcast schedule"):
        wsync_hop_perms(s, (0, 1, 2, 3))
    assert compile_broadcast_schedule(8, kind="star", fanout=2).fanout == 8
    assert compile_broadcast_schedule(8, kind="pipeline", fanout=8).fanout == 1
    t = compile_broadcast_schedule(3, kind="tree", fanout=8)
    assert (t.fanout, t.depth) == (3, 1)
    empty = compile_broadcast_schedule(0, kind="tree", fanout=4)
    assert (empty.n_edges, empty.depth, empty.route_for(())) == (0, 0, ())


# ---------------------------------------------------------------------------
# the wsync plan with a schedule, and its key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,fanout,n", [("tree", 2, 8), ("tree", 3, 5),
                                           ("pipeline", 2, 6), ("star", 2, 4), (None, 2, 0)])
def test_wsync_plan_with_schedule_matches_reference(kind, fanout, n):
    tree = PORT.tree(small_params())
    plan = compile_wsync_plan(tree, "sync", policy=POL, n_dev=1, broadcast=kind,
                              fanout=fanout, n_receivers=n)
    jp = jsched.compile_wsync_plan(REF.tree(small_params()), "sync", policy=JPOL, n_dev=1,
                                   broadcast=kind, fanout=fanout, n_receivers=n)
    assert (plan.kind, plan.axis, plan.n_dev, plan.raw_leaf_ix, plan.n_leaves,
            plan.strategy) == (jp.kind, jp.axis, jp.n_dev, jp.raw_leaf_ix, jp.n_leaves,
                               jp.strategy)
    for b, jb in zip(plan.buckets, jp.buckets, strict=True):
        for f in BUCKET_FIELDS:
            assert getattr(b, f) == getattr(jb, f), f
    assert plan.summary()["broadcast"] == jp.summary()["broadcast"]
    assert plan.broadcast == (None if jp.broadcast is None else BroadcastSchedule(
        jp.broadcast.kind, jp.broadcast.fanout, jp.broadcast.n_receivers))
    assert plan.key[-1] == jp.key[-1]  # the schedule triple (or None) ends both keys
    # the bucket schedule is the same under every topology
    plain = compile_wsync_plan(tree, "sync", policy=POL, n_dev=1)
    assert (plan.buckets, plan.raw_leaf_ix) == (plain.buckets, plain.raw_leaf_ix)
    assert (plan.key == plain.key) == (kind is None)


def test_plan_cache_hits_on_a_stable_fleet_size():
    params = PORT.tree(small_params())
    keys = {compile_wsync_plan(params, "sync", policy=POL, n_dev=1, broadcast=k,
                               fanout=f, n_receivers=n).key
            for k, f, n in [("tree", 2, 8), ("tree", 3, 8), ("tree", 2, 9),
                            ("pipeline", 2, 8), ("star", 2, 8)]}
    assert len(keys) == 5
    assert compile_wsync_plan(params, "sync", policy=POL, n_dev=1).key not in keys
    cache = PlanCache()
    kw = dict(policy=POL, n_dev=1, broadcast="tree", fanout=2, cache=cache)
    p1 = cached_wsync_plan(params, "sync", n_receivers=8, **kw)
    assert cached_wsync_plan(params, "sync", n_receivers=8, **kw) is p1
    assert (cache.stats.misses, cache.stats.hits) == (1, 1)
    p3 = cached_wsync_plan(params, "sync", n_receivers=9, **kw)
    assert p3 is not p1 and p3.broadcast.n_receivers == 9 and cache.stats.misses == 2


# ---------------------------------------------------------------------------
# the in-mesh broadcast: one rank against the reference, four gloo ranks
# ---------------------------------------------------------------------------

def _in_shard_map(fn, *args):
    mesh = make_mesh((1,), ("data",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(),) * len(args),
                                 out_specs=P(), axis_names={"data"},
                                 check_vma=False))(*args)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("btag", ["full", "delta"])
def test_inmesh_broadcast_at_one_rank_matches_reference(n, btag):
    """A pipeline over ``(0,) * (n + 1)``: every level a self-send, so the
    result is the input's bits with flag 0, in both packages and both
    twins, and the single hop's (``sync_weights``)."""
    tree, base = weight_trees(0)
    b = None if btag == "full" else base
    jb = None if b is None else jtree_of(base)
    ranks = (0,) * (n + 1)
    schedule = compile_broadcast_schedule(n, kind="pipeline")
    plan = compile_wsync_plan(tree, "data", policy=POL, n_dev=1, broadcast="pipeline",
                              n_receivers=n)
    with single_process_group("cpu") as g:
        planned, pf = execute_wsync_broadcast(plan, tree, g, ranks, base=b)
        planless, lf = broadcast_weights(tree, g, schedule, ranks, policy=POL, base=b)
        single, sf = sync_weights(tree, g, [(0, 0)], policy=POL, base=b)
    jplan = jsched.compile_wsync_plan(jtree_of(tree), "data", policy=JPOL, n_dev=1,
                                      broadcast="pipeline", n_receivers=n)
    jschedule = jsched.compile_broadcast_schedule(n, kind="pipeline")
    jplanned, jpf = _in_shard_map(
        lambda t, bs: jsched.execute_wsync_broadcast(jplan, t, "data", ranks, base=bs),
        jtree_of(tree), jb)
    jplanless, jlf = _in_shard_map(
        lambda t, bs: jbroadcast_weights(t, "data", jschedule, ranks, policy=JPOL, base=bs),
        jtree_of(tree), jb)
    assert int(pf) == int(lf) == int(sf) == int(jpf) == int(jlf) == 0
    for k in tree:
        for other in (planless[k], single[k], tree[k], jplanned[k], jplanless[k]):
            assert_bits_equal(planned[k], other, k)


def test_execute_wsync_broadcast_refuses_a_plan_without_schedule_and_a_repeated_source():
    tree = weight_trees(0)[0]
    with single_process_group("cpu") as g:
        plain = compile_wsync_plan(tree, "data", policy=POL, n_dev=1)
        with pytest.raises(ValueError, match="no BroadcastSchedule"):
            execute_wsync_broadcast(plain, tree, g, (0,))
        # a star of two at one rank: one level [(0, 0), (0, 0)], refused as the
        # reference's ppermute refuses it
        star = compile_wsync_plan(tree, "data", policy=POL, n_dev=1, broadcast="star",
                                  n_receivers=2)
        with pytest.raises(ValueError, match="repeats"):
            execute_wsync_broadcast(star, tree, g, (0, 0, 0))
        with pytest.raises(ValueError, match="repeats"):
            broadcast_weights(tree, g, star.broadcast, (0, 0, 0), policy=POL)
        with pytest.raises(ValueError, match="stale broadcast schedule"):
            execute_wsync_broadcast(star, tree, g, (0, 0))
    jstar = jsched.compile_wsync_plan(jtree_of(tree), "data", policy=JPOL, n_dev=1,
                                      broadcast="star", n_receivers=2)
    with pytest.raises(ValueError):
        _in_shard_map(lambda t: jsched.execute_wsync_broadcast(jstar, t, "data", (0, 0, 0)),
                      jtree_of(tree))


def test_inmesh_pipeline_at_four_gloo_ranks(tmp_path):
    """Pipelines over ranks ``(0, .., k)``: rank k, the deepest receiver,
    ends with rank 0's bits, flag 0, full and delta, in both twins; every
    other rank is untargeted at the last level (zeros; a delta decodes its
    own base).  A star or tree level, and a raw ppermute that repeats a
    source, raise on every rank and hang none."""
    world = 4
    res = run_gloo_ranks(broadcast_rank, world, tmp_path)
    tree0 = tree_flatten(weight_trees(0)[0])[0]
    for r in range(world):
        tree_r, base_r = (tree_flatten(t)[0] for t in weight_trees(r))
        for k in range(1, world):
            for btag in ("full", "delta"):
                for tag in ("plan", "planless"):
                    assert res[r][f"flag_{tag}_{btag}_{k}"] == 0
                    for i, leaf in enumerate(tree0):
                        got = res[r][f"{tag}_{btag}_{k}_{i}"]
                        if r == k:
                            want = np_of(leaf)
                        elif btag == "delta" and leaf.dtype.is_floating_point:
                            want = np_of(base_r[i])
                        else:
                            want = np.zeros_like(np_of(tree_r[i]))
                        assert_bits_equal(got, want, (r, k, btag, tag, i))
        for key in ("raised_plan_star", "raised_planless_star", "raised_plan_tree",
                    "raised_planless_tree", "raised_raw_ppermute"):
            assert res[r][key] == 1, (r, key)


# ---------------------------------------------------------------------------
# fleets without faults, against the reference's
# ---------------------------------------------------------------------------

def count_encodes(fleet):
    captured = []
    orig = fleet.engine._encode_update

    def counting(*a, **k):
        captured.append(orig(*a, **k))
        return captured[-1]

    fleet.engine._encode_update = counting
    return captured


@pytest.mark.parametrize("kind,fanout,n", [("star", 2, 6), ("tree", 2, 7), ("tree", 3, 13),
                                           ("pipeline", 1, 5), ("tree", 2, 64)])
def test_fleet_without_faults_matches_reference(kind, fanout, n):
    fleets, encodes = {}, {}
    schedule = compile_broadcast_schedule(n, kind=kind, fanout=fanout)
    for side in (REF, PORT):
        cache = side.PlanCache()
        f = side.fleet(names_of(n), broadcast=kind, fanout=fanout, cache=cache,
                       ckpt_every_publishes=10 ** 9)
        captured = count_encodes(f)
        p = small_params()
        for i in range(3):
            before = dict(f.stats)
            p = p if i == 0 else perturb_np(p, seed=i)
            f.publish(side.tree(p))
            assert f.settle() == 1  # every hop delivers within the round
            assert len(captured) == i + 1 and len(f.engine._updates) == 1
            w = captured[-1].wire_bytes
            assert f.stats["trainer_egress_bytes"] - before["trainer_egress_bytes"] == \
                schedule.root_degree * w
            assert f.stats["forwards"] - before["forwards"] == n - schedule.root_degree
            assert f.stats["forward_bytes"] - before["forward_bytes"] == \
                (n - schedule.root_degree) * w
            assert f.verify_bitexact()
        assert f.stats["max_hop_depth"] == schedule.depth
        assert cache.cache_info()["misses"] == (1 if kind == "star" else 2)
        fleets[side.port], encodes[side.port] = f, captured
    assert fleet_summary(fleets[True], PORT) == fleet_summary(fleets[False], REF)
    assert [(u.mode, u.wire_bytes, u.checksum) for u in encodes[True]] == [
        (u.mode, u.wire_bytes, u.checksum) for u in encodes[False]]


@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["tree", "pipeline"])
def test_arbitrary_bit_payloads_survive_forwarding(fmt, kind):
    """NaN payloads, infinities and subnormals through multi-hop routes, as
    the reference's fleet delivers them and as a direct apply decodes them."""
    from repro_torch.sync import apply_update

    summaries = {}
    for side in (REF, PORT):
        f = side.fleet(names_of(5), broadcast=kind, fanout=2, cache=side.PlanCache(),
                       ckpt_every_publishes=10 ** 9)
        for seed in (3, 4):
            bits = random_bits(fmt, 257, seed)
            x = np.asarray(to_jax(bits, fmt))
            f.publish(side.tree({"x": x, "step": np.asarray(seed - 2, np.int32)}))
            f.settle()
            assert f.verify_bitexact() and f.integrity_ledger()["silent"] == 0
        summaries[side.port] = fleet_summary(f, side)
        if side.port:
            direct = apply_update(f.engine.update_for("fresh"), device="cpu")
            assert all(bits_equal(r.params, direct) for r in f.replicas.values())
    assert summaries[True] == summaries[False]


def test_fleet_size_change_and_late_joiner_match_reference():
    out = {}
    for side in (REF, PORT):
        cache = side.PlanCache()
        f = side.fleet(names_of(4), broadcast="tree", fanout=2, cache=cache,
                       ckpt_every_publishes=10 ** 9)
        captured = count_encodes(f)
        p = small_params()
        f.publish(side.tree(p))
        f.settle()
        assert cache.cache_info()["misses"] == 2
        f.join("zz")  # no base yet: its first wave is a group of its own
        f.publish(side.tree(perturb_np(p)))
        f.settle()
        assert cache.cache_info()["misses"] == 2
        assert [u.mode for u in captured] == ["full", "delta", "full"]
        f.publish(side.tree(perturb_np(p, seed=2)))  # now one group of 5
        f.settle()
        assert cache.cache_info()["misses"] == 3 and f.verify_bitexact()
        out[side.port] = fleet_summary(f, side)
    assert out[True] == out[False]


def test_fleet_refuses_an_unknown_kind_and_a_stale_schedule():
    with pytest.raises(ValueError, match="unknown broadcast kind"):
        PORT.fleet(("a", "b"), broadcast="ring")
    f = PORT.fleet(("a", "b", "c"), broadcast="tree", fanout=2, cache=PlanCache(),
                   ckpt_every_publishes=10 ** 9)
    plain = f.engine.plan_for(PORT.tree(small_params()))  # a plan without schedule
    f.engine.plan_for = lambda params, **kw: plain
    f.publish(PORT.tree(small_params()))
    with pytest.raises(RuntimeError, match="stale wsync broadcast schedule"):
        f.round()
