"""The P2P plan kinds of the port (``p2p``, and ``kv`` and ``wsync`` under
every strategy) and their executor entry points, held against the JAX
reference (``repro.sched``):

  * ``compile_p2p_plan`` / ``compile_kv_plan(strategy=)`` /
    ``compile_wsync_plan(strategy=)`` against the reference compiler, field
    by field: wire bytes, the chunk grid, ``encode_fused``, gates, dtypes
    outside the codec riding raw;
  * ``p2p_send_with_plan``, ``transfer_cache_with_plan`` (a mixed-gate
    cache, a 0-d raw leaf) and ``sync_weights_with_plan`` bit-identical to
    their planless twins, and at one rank to the reference's functions
    inside ``jax.shard_map``;
  * one consolidated ``plan:<kind>`` report an execution, of the planless
    reports' totals and the plan's expected bytes;
  * plan-cache hits on repeats, misses on a new signature or strategy;
  * a stale plan raises.

One rank of gloo on the CPU (perm ``[(0, 0)]``); the 2-rank runs of the same
entry points are in ``test_torch_split_send.py``.  Tolerance: none.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import sched as jsched
from repro.core import policy as jpolicy
from repro.core.policy import CompressionPolicy as JPolicy
from repro.launch.mesh import make_mesh
from repro.serve.kv_transfer import transfer_cache as jtransfer_cache
from repro.sync.wire import sync_weights as jsync_weights
from repro_torch import sched
from repro_torch.core import policy
from repro_torch.core.policy import CompressionPolicy
from repro_torch.core.split_send import p2p_send
from repro_torch.launch.train import single_process_group
from repro_torch.sched import compile as sched_compile
from repro_torch.sched.cache import PlanCache
from repro_torch.serve.kv_transfer import transfer_cache
from repro_torch.sync.wire import sync_weights
from repro_torch.tree_util import tree_flatten
from torch_port_util import (SPLIT_STRATEGIES, assert_bits_equal, np_of, p2p_tree,
                             report_rows, split_bits, to_jax, to_torch, weight_trees)

IDPERM = [(0, 0)]
POL = CompressionPolicy(min_bytes=0)
JPOL = JPolicy(min_bytes=0)
BUCKET_FIELDS = ("dtype_name", "members", "length", "path", "width", "block", "exc_frac",
                 "fused", "encode_fused", "n_dev", "chunk", "wire_bytes", "raw_bytes",
                 "delta_width", "delta_lo_width", "delta_wire_bytes")


def jtree_of(tree):
    """The JAX twin of a tree of tensors, the same bits."""
    return {k: jax.lax.bitcast_convert_type(jnp.asarray(np_of(v)),
                                            jnp.dtype(str(v.dtype).removeprefix("torch.")))
            for k, v in tree.items()}


def assert_plans_match(plan, jp):
    assert (plan.kind, plan.axis, plan.n_dev, plan.raw_leaf_ix, plan.n_leaves,
            plan.strategy) == (jp.kind, jp.axis, jp.n_dev, jp.raw_leaf_ix, jp.n_leaves,
                               jp.strategy)
    assert len(plan.buckets) == len(jp.buckets)
    for b, jb in zip(plan.buckets, jp.buckets):
        for f in BUCKET_FIELDS:
            assert getattr(b, f) == getattr(jb, f), (f, getattr(b, f), getattr(jb, f))
    assert (plan.wire_bytes, plan.raw_bytes) == (jp.wire_bytes, jp.raw_bytes)
    assert plan.summary()["strategy"] == jp.summary()["strategy"]


def _in_shard_map(fn, *args):
    """The reference's ``fn`` inside shard_map on a one-device mesh, with the
    WireReports its trace records."""
    mesh = make_mesh((1,), ("data",))
    with jpolicy.capture_wire_reports() as reports:
        out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(),) * len(args),
                                    out_specs=P(), axis_names={"data"},
                                    check_vma=False))(*args)
    return out, list(reports)


# ---------------------------------------------------------------------------
# the compiler against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", SPLIT_STRATEGIES)
@pytest.mark.parametrize("fmt,n", [("bfloat16", 4096), ("bfloat16", 1537),
                                   ("bfloat16", 100), ("float32", 4096 + 17),
                                   ("float8_e4m3fn", 513), ("int32", 4096)])
@pytest.mark.parametrize("axis,min_bytes,knobs", [
    ("data", 0, {}), ("data", 0, {"fused_encode": False, "fused_decode_reduce": False}),
    ("data", 1 << 30, {}), ("model", 0, {})])
def test_p2p_plan_matches_reference(strategy, fmt, n, axis, min_bytes, knobs):
    """Gate (min_bytes, a raw axis, a dtype outside the codec), width,
    chunk grid (the degenerate-chunk guard: n = 100 is one chunk),
    encode_fused (never for split_send), wire and raw bytes."""
    pol = dataclasses.replace(CompressionPolicy(min_bytes=min_bytes), **knobs)
    jpol = dataclasses.replace(JPolicy(min_bytes=min_bytes), **knobs)
    x = torch.empty((n,), dtype=getattr(torch, fmt), device="meta")
    plan = sched_compile.compile_p2p_plan(x, axis, policy=pol, n_dev=8, strategy=strategy,
                                          device="cpu")
    jp = jsched.compile_p2p_plan(jax.ShapeDtypeStruct((n,), jnp.dtype(fmt)), axis,
                                 policy=jpol, n_dev=8, strategy=strategy)
    assert_plans_match(plan, jp)
    b = plan.buckets[0]
    if b.compressed:
        assert b.encode_fused == (strategy != "split_send" and pol.fused_encode)
    if fmt == "int32" or min_bytes or axis == "model":
        assert b.path == "raw"
    assert (plan.backend, plan.use_kernels) == ("cpu", False)


def test_p2p_plan_chunked_grid_and_unknown_strategy():
    x = torch.empty((1537,), dtype=torch.bfloat16, device="meta")
    plan = sched_compile.compile_p2p_plan(x, "data", policy=POL, n_dev=8,
                                          strategy="chunked", device="cpu")
    small = sched_compile.compile_p2p_plan(x[:100], "data", policy=POL, n_dev=8,
                                           strategy="chunked", device="cpu")
    assert plan.buckets[0].chunk == small.buckets[0].chunk == 512
    assert plan.buckets[0].raw_bytes == 4 * 512 * 2  # four chunks
    assert small.buckets[0].wire_bytes < plan.buckets[0].wire_bytes * 0.3
    for fn, arg in ((sched_compile.compile_p2p_plan, x),
                    (sched_compile.compile_kv_plan, {"k": x}),
                    (sched_compile.compile_wsync_plan, {"k": x})):
        with pytest.raises(ValueError, match="strategy"):
            fn(arg, "data", policy=POL, n_dev=1, strategy="warp_send", device="cpu")
    assert set(sched_compile.PLAN_KINDS) == set(jsched.PLAN_KINDS)
    assert sched_compile.P2P_STRATEGIES == jsched.compile.P2P_STRATEGIES


@pytest.mark.parametrize("strategy", SPLIT_STRATEGIES)
@pytest.mark.parametrize("min_bytes", [0, 2048])
def test_kv_plan_matches_reference(strategy, min_bytes):
    """A KV cache (bf16 K and V fused, an f32 leaf, an int32 scalar raw)
    under each strategy; at min_bytes=2048 the f32 bucket (1200 B) rides
    raw."""
    tree = p2p_tree(0)
    pol, jpol = CompressionPolicy(min_bytes=min_bytes), JPolicy(min_bytes=min_bytes)
    plan = sched_compile.compile_kv_plan(tree, "data", policy=pol, n_dev=2,
                                         strategy=strategy)
    jp = jsched.compile_kv_plan(jtree_of(tree), "data", policy=jpol, n_dev=2,
                                strategy=strategy)
    assert_plans_match(plan, jp)
    assert plan.raw_leaf_ix == (2,) and plan.strategy == strategy
    paths = {b.dtype_name: b.path for b in plan.buckets}
    assert paths == {"bfloat16": "compressed",
                     "float32": "raw" if min_bytes else "compressed"}


@pytest.mark.parametrize("strategy", SPLIT_STRATEGIES)
@pytest.mark.parametrize("fused_encode", [True, False])
def test_wsync_plan_matches_reference(strategy, fused_encode):
    """Every field the reference's, ``encode_fused`` included."""
    tree = weight_trees(0)[0]
    pol = dataclasses.replace(POL, fused_encode=fused_encode)
    jpol = dataclasses.replace(JPOL, fused_encode=fused_encode)
    plan = sched_compile.compile_wsync_plan(tree, "data", policy=pol, n_dev=1,
                                            strategy=strategy)
    jp = jsched.compile_wsync_plan(jtree_of(tree), "data", policy=jpol, n_dev=1,
                                   strategy=strategy)
    assert_plans_match(plan, jp)


def test_default_strategy_keeps_the_host_plans():
    """The host paths (``ship_cache``, ``WeightSyncEngine``) compile the
    split_send plans of before; the strategy is part of every key."""
    tree = p2p_tree(0)
    pc = PlanCache()
    a = sched_compile.cached_kv_plan(tree, "data", policy=POL, n_dev=1, plan_cache=pc)
    b = sched_compile.cached_kv_plan(tree, "data", policy=POL, n_dev=1,
                                     strategy="split_send", plan_cache=pc)
    c = sched_compile.cached_kv_plan(tree, "data", policy=POL, n_dev=1,
                                     strategy="encode_send", plan_cache=pc)
    assert a is b and a.strategy == "split_send" and c.strategy == "encode_send"
    assert (pc.stats.misses, pc.stats.hits) == (2, 1)
    assert a == sched_compile.compile_kv_plan(tree, "data", policy=POL, n_dev=1)
    w = weight_trees(0)[0]
    assert sched_compile.wsync_plan_key(w, "data", POL, 1) == sched_compile.wsync_plan_key(
        w, "data", POL, 1, strategy="split_send") != sched_compile.wsync_plan_key(
        w, "data", POL, 1, strategy="chunked")


# ---------------------------------------------------------------------------
# plan-driven == planless, and the reference at one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", SPLIT_STRATEGIES)
@pytest.mark.parametrize("enabled", [True, False])
def test_p2p_send_with_plan_bit_identical(strategy, enabled):
    pol = POL if enabled else CompressionPolicy.disabled()
    jpol = JPOL if enabled else JPolicy.disabled()
    bits = split_bits("bfloat16", 4096 + 17, 0)
    x = to_torch(bits, "bfloat16")
    cache = PlanCache()
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        a, fa = sched.p2p_send_with_plan(x, g, IDPERM, policy=pol, strategy=strategy,
                                         cache=cache)
        b, fb = p2p_send(x, g, IDPERM, policy=pol, strategy=strategy)
    (j, jf), jreports = _in_shard_map(
        lambda v: jsched.p2p_send_with_plan(v, "data", IDPERM, policy=jpol,
                                            strategy=strategy, cache=jsched.PlanCache()),
        to_jax(bits, "bfloat16"))
    assert int(fa) == int(fb) == int(jf) == 0
    assert_bits_equal(a, b)
    assert_bits_equal(a, x)
    assert_bits_equal(a, j)
    assert cache.stats.misses == 1
    n_plan = 1 if enabled else 0
    assert [r.name for r in reports[:n_plan]] == ["plan:p2p"] * n_plan
    assert report_rows(reports[:n_plan]) == report_rows(jreports)


@pytest.mark.parametrize("strategy", SPLIT_STRATEGIES)
def test_p2p_send_with_plan_reducing_receiver(strategy):
    """The reducing receiver through the plan equals the planless one and
    ``acc + x`` in f32; split_send's is fused, and the report says so."""
    bits = split_bits("bfloat16", 2048, 0, subnormals=False)
    x = to_torch(bits, "bfloat16")
    acc = torch.from_numpy(np.random.default_rng(4).normal(0, 1, 2048).astype(np.float32))
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        a, fa = sched.p2p_send_with_plan(x, g, IDPERM, policy=POL, strategy=strategy,
                                         reduce_into=acc, cache=PlanCache())
        b, fb = p2p_send(x, g, IDPERM, policy=POL, strategy=strategy, reduce_into=acc)
    (j, _), jreports = _in_shard_map(
        lambda v, ac: jsched.p2p_send_with_plan(v, "data", IDPERM, policy=JPOL,
                                                strategy=strategy, reduce_into=ac,
                                                cache=jsched.PlanCache()),
        to_jax(bits, "bfloat16"), jnp.asarray(acc.numpy()))
    assert int(fa) == int(fb) == 0
    assert_bits_equal(a, b)
    assert_bits_equal(a, acc + x.float())
    # NaN as NaN against XLA's f32 add
    nan = a.isnan().numpy()
    assert np.array_equal(np_of(a)[~nan], np_of(j)[~nan]) and np.isnan(np.asarray(j)[nan]).all()
    assert report_rows(reports[:1]) == report_rows(jreports)
    assert reports[0].fused == (strategy == "split_send")


def test_p2p_send_plan_kwarg_and_a_dtype_outside_the_codec():
    """p2p_send(plan=) replays the plan through the executor (one plan:p2p
    report); an int32 tensor compiles to the raw path and moves as it is."""
    x = to_torch(split_bits("bfloat16", 1024, 0), "bfloat16")
    plan = sched_compile.compile_p2p_plan(x, "data", policy=POL, n_dev=1)
    ints = torch.arange(4096, dtype=torch.int32)
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        a, _ = p2p_send(x, g, IDPERM, policy=POL, plan=plan)
        b, _ = p2p_send(x, g, IDPERM, policy=POL)
        c, fc = sched.p2p_send_with_plan(ints, g, IDPERM, policy=POL, cache=PlanCache())
    assert_bits_equal(a, b)
    assert [r.name for r in reports] == ["plan:p2p", "split_send"]
    assert sched_compile.compile_p2p_plan(ints, "data", policy=POL, n_dev=1).buckets[
        0].path == "raw"
    assert torch.equal(c, ints) and int(fc) == 0


@pytest.mark.parametrize("strategy", SPLIT_STRATEGIES)
@pytest.mark.parametrize("min_bytes", [0, 2048])
def test_transfer_cache_with_plan_bit_identical(strategy, min_bytes):
    """transfer_cache_with_plan == transfer_cache == the reference's
    transfer_cache, every leaf bit for bit: both buckets compressed, or the
    f32 one raw (a mixed gate); the 0-d int32 leaf raw.  One plan:kv
    report, the reference's, of the planless reports' totals and the plan's
    bytes."""
    tree = p2p_tree(0)
    pol, jpol = CompressionPolicy(min_bytes=min_bytes), JPolicy(min_bytes=min_bytes)
    pc = PlanCache()
    with single_process_group("cpu") as g:
        with policy.capture_wire_reports() as plan_reports:
            a, fa = sched.transfer_cache_with_plan(tree, g, IDPERM, policy=pol,
                                                   strategy=strategy, plan_cache=pc)
        with policy.capture_wire_reports() as flat:
            b, fb = transfer_cache(tree, g, IDPERM, policy=pol, strategy=strategy)
    (j, _), jreports = _in_shard_map(
        lambda c: jsched.transfer_cache_with_plan(c, "data", IDPERM, policy=jpol,
                                                  strategy=strategy,
                                                  plan_cache=jsched.PlanCache()),
        jtree_of(tree))
    (jflat, _), jflat_reports = _in_shard_map(
        lambda c: jtransfer_cache(c, "data", IDPERM, policy=jpol, strategy=strategy),
        jtree_of(tree))
    assert int(fa) == int(fb) == 0
    for k in tree:
        assert a[k].dtype == tree[k].dtype and a[k].shape == tree[k].shape, k
        for other in (b[k], tree[k], j[k], jflat[k]):
            assert_bits_equal(a[k], other, k)
    (plan,) = pc._plans.values()
    assert [r.name for r in plan_reports] == ["plan:kv"]
    assert report_rows(plan_reports) == report_rows(jreports)
    assert report_rows(flat) == report_rows(jflat_reports)
    assert (plan_reports[0].raw_bytes, plan_reports[0].wire_bytes) == (
        sum(r.raw_bytes for r in flat), sum(r.wire_bytes for r in flat)) == (
        plan.raw_bytes, plan.wire_bytes)


@pytest.mark.parametrize("strategy", SPLIT_STRATEGIES)
@pytest.mark.parametrize("btag", ["full", "delta"])
def test_sync_weights_with_plan_bit_identical(strategy, btag):
    """sync_weights_with_plan == sync_weights == the reference's
    sync_weights, full (base=None) and as a delta against the base both
    ends hold; one plan:wsync report, the reference's."""
    tree, base = weight_trees(0)
    b_arg = None if btag == "full" else base
    with single_process_group("cpu") as g:
        with policy.capture_wire_reports() as plan_reports:
            a, fa = sched.sync_weights_with_plan(tree, g, IDPERM, policy=POL, base=b_arg,
                                                 strategy=strategy, cache=PlanCache())
        with policy.capture_wire_reports() as flat:
            b, fb = sync_weights(tree, g, IDPERM, policy=POL, base=b_arg, strategy=strategy)
    jbase = None if b_arg is None else jtree_of(base)
    (j, jf), jreports = _in_shard_map(
        lambda t, bs: jsched.sync_weights_with_plan(t, "data", IDPERM, policy=JPOL, base=bs,
                                                    strategy=strategy,
                                                    cache=jsched.PlanCache()),
        jtree_of(tree), jbase)
    (jflat, _), jflat_reports = _in_shard_map(
        lambda t, bs: jsync_weights(t, "data", IDPERM, policy=JPOL, base=bs,
                                    strategy=strategy), jtree_of(tree), jbase)
    assert int(fa) == int(fb) == int(jf) == 0
    for k in tree:
        for other in (b[k], tree[k], j[k], jflat[k]):
            assert_bits_equal(a[k], other, k)
    assert [r.name for r in plan_reports] == ["plan:wsync"]
    assert report_rows(plan_reports) == report_rows(jreports)
    assert report_rows(flat) == report_rows(jflat_reports)
    names = {r.name for r in flat}
    assert names == ({"delta_send"} if btag == "delta" else
                     {"split_send": {"split_send"}, "encode_send": {"encode_send"},
                      "chunked": {"encode_send"}}[strategy])


# ---------------------------------------------------------------------------
# the plan cache, and stale plans
# ---------------------------------------------------------------------------

def test_repeated_transfers_hit_the_plan_cache():
    """Repeats with the same signature hit (other values too); a longer
    sequence axis misses; the strategy is part of the key."""
    pc = PlanCache()
    with single_process_group("cpu") as g:
        for k in range(4):
            sched.transfer_cache_with_plan(p2p_tree(k % 2), g, IDPERM, policy=POL,
                                           plan_cache=pc)
            assert (pc.stats.misses, pc.stats.hits) == (1, k)
        bigger = dict(p2p_tree(0), k=torch.zeros((2, 128, 4, 8), dtype=torch.bfloat16))
        sched.transfer_cache_with_plan(bigger, g, IDPERM, policy=POL, plan_cache=pc)
        assert pc.stats.misses == 2
        x = to_torch(split_bits("bfloat16", 1 << 12, 0), "bfloat16")
        cache = PlanCache()
        for k in range(3):
            sched.p2p_send_with_plan(x, g, IDPERM, policy=POL, cache=cache)
            assert (cache.stats.misses, cache.stats.hits) == (1, k)
        sched.p2p_send_with_plan(x, g, IDPERM, policy=POL, strategy="encode_send",
                                 cache=cache)
        w = PlanCache()
        tree, base = weight_trees(0)
        for b in (None, base, base):
            sched.sync_weights_with_plan(tree, g, IDPERM, policy=POL, base=b, cache=w)
    assert cache.stats.misses == 2
    assert (w.stats.misses, w.stats.hits) == (1, 2)


def test_stale_plans_raise():
    """A plan of another signature (a leaf's shape or dtype, the leaf
    count) or of another kind raises before anything is sent."""
    tree = p2p_tree(0)
    x = to_torch(split_bits("bfloat16", 1024, 0), "bfloat16")
    kv = sched_compile.compile_kv_plan(tree, "data", policy=POL, n_dev=1)
    p2p = sched_compile.compile_p2p_plan(x, "data", policy=POL, n_dev=1)
    ws = sched_compile.compile_wsync_plan(weight_trees(0)[0], "data", policy=POL, n_dev=1)
    with single_process_group("cpu") as g:
        with pytest.raises(ValueError, match="plan recorded"):
            sched.transfer_cache_with_plan(
                dict(tree, k=torch.zeros((2, 128, 4, 8), dtype=torch.bfloat16)), g, IDPERM,
                plan=kv)
        with pytest.raises(ValueError, match="plan recorded"):
            sched.p2p_send_with_plan(x.float(), g, IDPERM, plan=p2p)
        with pytest.raises(ValueError, match="leaves"):
            sched.sync_weights_with_plan({"w": weight_trees(0)[0]["w"]}, g, IDPERM, plan=ws)
        with pytest.raises(ValueError, match="executor"):
            sched.execute_kv_transfer(p2p, tree, g, IDPERM)
        with pytest.raises(ValueError, match="structure"):
            sched.sync_weights_with_plan(weight_trees(0)[0], g, IDPERM, plan=ws,
                                         base={"w": x})
        with pytest.raises(ValueError, match="policy= or plan="):
            sched.p2p_send_with_plan(x, g, IDPERM)


def test_transfer_cache_plan_kwarg_routes_through_the_executor():
    tree = p2p_tree(1)
    plan = sched_compile.compile_kv_plan(tree, "data", policy=POL, n_dev=1,
                                         strategy="encode_send")
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        a, _ = transfer_cache(tree, g, IDPERM, policy=POL, plan=plan)
    assert [r.name for r in reports] == ["plan:kv"]
    for la, lb in zip(tree_flatten(a)[0], tree_flatten(tree)[0]):
        assert_bits_equal(la, lb)
