"""The port's plan layer for the collective kinds (``psum``,
``reduce_scatter``, ``all_gather``, ``zero1``) and its executor, held
against the JAX reference (``repro.sched``).

* the compiled plans: every bucket field (paths, widths, chunk grids,
  fused knobs, expected bytes, probe), ``summary()`` and ``wire_bytes``
  equal the reference compiler's for the same tree, policy and ``n_dev``;
  ``encoded_wire_bytes`` equals ``wire_nbytes`` of a real encode;
* the executor at one gloo rank: ``psum_with_plan`` and the flat entry
  points give the planless calls' bits, and their one consolidated
  ``plan:<kind>`` WireReport equals the reference's field by field; a
  repeated signature hits the plan cache;
* ZeRO-1 on a plan: ``zero1_step`` with a compiled plan is bit-identical
  to the same step compiling its plan on first sight and runs the very
  calls the port made before it had plans; its consolidated report is the
  reference's; the launcher compiles one plan per policy and hits after
  (the plan-driven step against the reference's, with the tolerances
  stated there, is ``test_torch_train``).

Tolerances: none, except the calibrate probe's entropy, an f32 sum over a
histogram in another order (relative 1e-6).
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
from repro.optim import optimizers as jopt
from repro.optim import zero1 as jzero1
from repro.sched import compile as jcompile
from repro_torch import configs, sched
from repro_torch.core import compressed_collectives as cc
from repro_torch.core import policy
from repro_torch.core.calibrate import CompressionProfile
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import single_process_group
from repro_torch.optim import optimizers as opt
from repro_torch.optim import zero1
from repro_torch.sched import compile as sched_compile
from repro_torch.sched.cache import PlanCache
from repro_torch.sched.plan import PhasePair
from torch_port_util import (FORMATS, assert_bits_equal, grad_like_bits,
                             np_of, psum_bits, report_rows, to_jax, to_torch)

BUCKET_FIELDS = ("dtype_name", "members", "length", "path", "width", "ag_width", "block",
                 "exc_frac", "fused", "encode_fused", "n_dev", "chunk", "wire_bytes",
                 "raw_bytes", "delta_width", "delta_lo_width", "delta_wire_bytes", "probe")
SUMMARY_KEYS = ("kind", "axis", "n_dev", "n_buckets", "n_raw_leaves", "paths",
                "n_encode_fused", "n_delta", "wire_bytes", "raw_bytes", "ratio",
                "delta_wire_bytes")
# a tree of mixed leaves: (shape, dtype name), visited in sorted key order
SHAPES = {"attn": ((96, 64), "bfloat16"), "bias": ((33,), "float32"),
          "emb": ((700, 16), "bfloat16"), "norm": ((1500,), "float32"),
          "scale": ((), "float32"), "step": ((4,), "int32")}
POLICIES = {  # name -> (policy keyword arguments, gate label)
    "two_shot": ({"min_bytes": 0}, "data"),
    "ring": ({"min_bytes": 0, "allreduce_algorithm": "ring"}, "data"),
    "unfused": ({"min_bytes": 0, "fused_encode": False, "fused_decode_reduce": False},
                "data"),
    "mixed": ({"min_bytes": 20_000}, "data"),  # bf16 compressed, f32 small: psum_safe
    "disabled": ({"enabled": False, "min_bytes": 10_000}, "data"),  # bf16 raw two-shot
    "model_axis": ({"min_bytes": 0}, "model"),
    "two_axes": ({"min_bytes": 0}, ("data", "pod")),
}


def _meta_tree():
    return {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
            for k, (s, d) in SHAPES.items()}


def _struct_tree():
    return {k: jax.ShapeDtypeStruct(s, jnp.dtype(d)) for k, (s, d) in SHAPES.items()}


def _live_trees(seed: int):
    rng = np.random.default_rng(seed)
    t, j = {}, {}
    for k, (s, d) in SHAPES.items():
        n = int(np.prod(s))
        if d == "int32":
            a = rng.integers(-50, 50, n).astype(np.int32)
            t[k], j[k] = torch.from_numpy(a).reshape(s), jnp.asarray(a).reshape(s)
        else:
            bits = psum_bits(seed, n, d)
            t[k], j[k] = to_torch(bits, d).reshape(s), to_jax(bits, d).reshape(s)
    return t, j


def _bucket_rows(plan):
    return [tuple(getattr(b, f) for f in BUCKET_FIELDS) for b in plan._flat_buckets()]


def _assert_plans_equal(plan, jplan):
    assert _bucket_rows(plan) == _bucket_rows(jplan)
    assert (plan.raw_leaf_ix, plan.n_leaves) == (jplan.raw_leaf_ix, jplan.n_leaves)
    s, js = plan.summary(), jplan.summary()
    assert {k: s[k] for k in SUMMARY_KEYS} == {k: js[k] for k in SUMMARY_KEYS}
    assert (plan.wire_bytes, plan.raw_bytes) == (jplan.wire_bytes, jplan.raw_bytes)
    assert (plan.backend, plan.use_kernels) == ("cpu", False)


def _policies(name):
    kw, axis = POLICIES[name]
    return CompressionPolicy(**kw), JPolicy(**kw), axis


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_psum_plan_matches_reference(name, n_dev):
    pol, jpol, axis = _policies(name)
    plan = sched_compile.compile_psum_plan(_meta_tree(), axis, policy=pol, n_dev=n_dev,
                                           device="cpu")
    jplan = jcompile.compile_psum_plan(_struct_tree(), axis, policy=jpol, n_dev=n_dev)
    assert plan.kind == jplan.kind == "psum"
    _assert_plans_equal(plan, jplan)


def test_psum_plan_paths_cover_every_dispatch():
    paths = {name: sched_compile.compile_psum_plan(
        _meta_tree(), POLICIES[name][1], policy=_policies(name)[0], n_dev=2,
        device="cpu").summary()["paths"] for name in POLICIES}
    assert paths["two_shot"] == ("two_shot", "two_shot")
    assert paths["ring"] == ("ring", "ring")
    assert paths["unfused"] == ("two_shot", "two_shot")
    assert paths["mixed"] == ("two_shot", "raw_psum")
    assert paths["disabled"] == ("raw_twoshot", "raw_psum")
    assert paths["two_axes"] == ("two_shot", "two_shot")  # both compress_axes
    assert paths["model_axis"] == ("raw_twoshot", "raw_twoshot")


@pytest.mark.parametrize("n_dev", [1, 4])
def test_psum_plan_probe_matches_reference(n_dev):
    """``sample=``: the calibrate probe picks each bucket's width."""
    t, j = _live_trees(3)
    pol, jpol, axis = _policies("two_shot")
    plan = sched_compile.compile_psum_plan(_meta_tree(), axis, policy=pol, n_dev=n_dev,
                                           sample=t, device="cpu")
    jplan = jcompile.compile_psum_plan(_struct_tree(), axis, policy=jpol, n_dev=n_dev,
                                       sample=j)
    strip = lambda rows: [r[:-1] + (r[-1][:2],) for r in rows]  # noqa: E731
    assert strip(_bucket_rows(plan)) == strip(_bucket_rows(jplan))
    for b, jb in zip(plan.buckets, jplan.buckets):
        assert b.probe[2] == pytest.approx(jb.probe[2], rel=1e-6)


@pytest.mark.parametrize("kind", ["reduce_scatter", "all_gather"])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("dtype,length,min_bytes", [
    ("bfloat16", 512 * 9 + 11, 0), ("float32", 3000, 0), ("float8_e4m3fn", 2048, 0),
    ("bfloat16", 5000, 10_000), ("float32", 5000, 1 << 20)])
def test_flat_plans_match_reference(kind, n_dev, dtype, length, min_bytes):
    """ZeRO-1's gate: compressed iff the global bytes reach min_bytes."""
    pol, jpol = CompressionPolicy(min_bytes=min_bytes), JPolicy(min_bytes=min_bytes)
    compile_fn = getattr(sched_compile, f"compile_{kind}_plan")
    plan = compile_fn(length, dtype, "data", policy=pol, n_dev=n_dev, device="cpu")
    jplan = getattr(jcompile, f"compile_{kind}_plan")(length, dtype, "data", policy=jpol,
                                                      n_dev=n_dev)
    assert plan.kind == kind
    _assert_plans_equal(plan, jplan)


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("name", ["two_shot", "unfused", "mixed", "disabled"])
def test_zero1_plan_matches_reference(name, n_dev):
    pol, jpol, _ = _policies(name)
    leaves = list(_meta_tree().values())[:-1]  # ZeRO-1 buckets floats only
    meta = zero1.plan_buckets(leaves, n_dev)
    jmeta = jzero1.plan_buckets({k: v for k, v in _struct_tree().items() if k != "step"},
                                n_dev)
    plan = sched_compile.compile_zero1_plan(meta, policy=pol, axis_name=("data",),
                                            n_dev=n_dev, device="cpu")
    jplan = jcompile.compile_zero1_plan(jmeta, policy=jpol, axis_name=("data",),
                                        n_dev=n_dev)
    assert plan.kind == "zero1" and all(isinstance(p, PhasePair) for p in plan.buckets)
    _assert_plans_equal(plan, jplan)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n_chunks,chunk,width", [(1, 512, 1), (3, 512 * 7, 5),
                                                  (4, 512 * 40, 8)])
def test_encoded_wire_bytes_is_a_real_encode(fmt, n_chunks, chunk, width, fused):
    x = to_torch(grad_like_bits(fmt, n_chunks * chunk, seed=5), fmt).reshape(n_chunks, chunk)
    kw = dict(width=width, block=512, exc_frac=0.02)
    got = sched_compile.encoded_wire_bytes(n_chunks, chunk, x.dtype, **kw)
    assert got == cc.wire_nbytes(cc._encode_chunks(x, fused=fused, **kw))
    assert got == jcompile.encoded_wire_bytes(n_chunks, chunk, jnp.dtype(fmt), **kw)


def test_plan_kinds_are_the_reference_kinds_ported_so_far():
    assert set(sched_compile.PLAN_KINDS) == set(jcompile.PLAN_KINDS)
    for kind, fn in sched_compile.PLAN_KINDS.items():
        assert fn.__name__ == jcompile.PLAN_KINDS[kind].__name__


# ---------------------------------------------------------------------------
# the executor at one rank
# ---------------------------------------------------------------------------

def _in_shard_map(fn, *args):
    mesh = make_mesh((1, 1), ("data", "model"))
    with jpolicy.capture_wire_reports() as reports:
        out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(),) * len(args),
                                    out_specs=P(), axis_names={"data", "model"},
                                    check_vma=False))(*args)
    return out, list(reports)


@pytest.mark.parametrize("name", ["two_shot", "ring", "unfused", "mixed", "disabled"])
def test_psum_with_plan_equals_tree_psum_and_the_reference_report(name):
    pol, jpol, axis = _policies(name)
    t, j = _live_trees(4)
    cache = PlanCache()
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        out, flag = sched.psum_with_plan(t, g, axis_name=axis, policy=pol, cache=cache)
        planless, pflag = cc.tree_psum_compressed(t, g, axis_name=axis, policy=pol)
    for k in t:
        assert_bits_equal(out[k], planless[k], k)
    assert int(flag) == int(pflag) == 0
    (_, jflag), jreports = _in_shard_map(
        lambda tree: jsched.psum_with_plan(tree, axis, policy=jpol, cache=jsched.PlanCache()),
        j)
    plan_reports = [r for r in reports if r.name.startswith("plan:")]
    assert report_rows(plan_reports) == report_rows(jreports)
    if jreports:
        assert plan_reports[0].axis == jreports[0].axis == "data"
        # the consolidated record is the sum of the planless call's wires
        wires = reports[1:]
        assert plan_reports[0].wire_bytes == sum(r.wire_bytes for r in wires)
        assert plan_reports[0].raw_bytes == sum(r.raw_bytes for r in wires)


@pytest.mark.parametrize("min_bytes", [0, 1 << 30])
def test_flat_entry_points_replay_the_planless_calls(min_bytes):
    bits = psum_bits(0, 512 * 6 + 100)
    x = to_torch(bits, "bfloat16")
    pol, jpol = CompressionPolicy(min_bytes=min_bytes), JPolicy(min_bytes=min_bytes)
    w_ag = min(pol.width_for("weight") + pol.profile.ag_extra_bits, 8)
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        rs, f1 = sched.reduce_scatter_with_plan(x, g, policy=pol, cache=PlanCache())
        ag, f2 = sched.all_gather_with_plan(x, g, policy=pol, cache=PlanCache())
        if min_bytes == 0:
            want_rs, _ = cc.reduce_scatter_compressed(x, g, width=pol.width_for("gradient"))
            want_ag, _ = cc.all_gather_compressed(x, g, width=w_ag)
        else:
            want_rs = zero1._raw_reduce_scatter(x, g, 1)
            want_ag = zero1._raw_all_gather(x, g)
    assert_bits_equal(rs, want_rs)
    assert_bits_equal(ag, want_ag)
    assert int(f1) == int(f2) == 0

    def body(v):
        return (jsched.reduce_scatter_with_plan(v, "data", policy=jpol,
                                                cache=jsched.PlanCache())[1],
                jsched.all_gather_with_plan(v, "data", policy=jpol,
                                            cache=jsched.PlanCache())[1])

    _, jreports = _in_shard_map(body, to_jax(bits, "bfloat16"))
    plan_reports = [r for r in reports if r.name.startswith("plan:")]
    assert report_rows(plan_reports) == report_rows(jreports)
    assert [r.name for r in plan_reports] == (
        ["plan:reduce_scatter", "plan:all_gather"] if min_bytes == 0 else [])


def test_plan_cache_hits_on_a_repeated_signature():
    t, _ = _live_trees(6)
    cache = PlanCache()
    pol = CompressionPolicy(min_bytes=0)
    with single_process_group("cpu") as g:
        outs = [sched.psum_with_plan(t, g, policy=pol, cache=cache)[0] for _ in range(3)]
        assert (cache.stats.misses, cache.stats.hits) == (1, 2)
        sched.psum_with_plan(_live_trees(7)[0], g, policy=pol, cache=cache)  # same shapes
        assert (cache.stats.misses, cache.stats.hits) == (1, 3)
        sched.psum_with_plan(t, g, policy=dataclasses.replace(pol, fused_encode=False),
                             cache=cache)
        sched.psum_with_plan(t, g, policy=pol, tensor_class="weight", cache=cache)
        assert (cache.stats.misses, cache.stats.hits) == (3, 3)
    for k in t:
        assert_bits_equal(outs[0][k], outs[2][k], k)
    key = sched_compile.psum_plan_key(t, "data", pol, "gradient", 1)
    assert key in cache and key[-1] == ("cpu", False)  # never replayed on the card


def test_zero1_execution_emits_only_on_success():
    meta = zero1.plan_buckets([torch.zeros(2048, dtype=torch.bfloat16)], 1)
    plan = sched_compile.compile_zero1_plan(meta, policy=CompressionPolicy(min_bytes=0),
                                            axis_name="data", n_dev=1, device="cpu")
    gb = to_torch(psum_bits(1, 2048), "bfloat16")
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        with pytest.raises(RuntimeError, match="update failed"):
            with sched.Zero1Execution(plan, g) as ex:
                ex.reduce_scatter(0, gb)
                raise RuntimeError("update failed")
        with sched.Zero1Execution(plan, g) as ex:
            ex.reduce_scatter(0, gb)
            ex.all_gather(0, gb)
    assert [r.name for r in reports] == ["plan:zero1"]


# ---------------------------------------------------------------------------
# ZeRO-1 on a plan
# ---------------------------------------------------------------------------

def _smoke_step_inputs(seed: int):
    """The smoke model's parameters (seeded bf16) and gradients."""
    from repro_torch.models import transformer

    model = transformer.init(configs.get_smoke("smollm_135m"),
                             generator=torch.Generator().manual_seed(seed), device="cpu")
    params = [p.detach() for p in model.leaves()]
    rng = np.random.default_rng(seed)
    grads = [torch.from_numpy(rng.normal(0, 0.02, p.shape).astype(np.float32)).to(p.dtype)
             for p in params]
    return params, grads


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("min_bytes", [0, 1 << 30])
def test_zero1_step_on_a_plan_is_bit_identical(optimizer, min_bytes):
    """A compiled plan, a plan compiled on first sight, and the phases the
    port ran before it had plans (reduce_scatter_compressed at the gradient
    width, all_gather_compressed at the weight width plus headroom, or the
    raw twins): the same bits, and the reference's consolidated report."""
    params, grads = _smoke_step_inputs(9)
    pol, jpol = CompressionPolicy(min_bytes=min_bytes), JPolicy(min_bytes=min_bytes)
    ocfg = opt.OptimConfig(name=optimizer, lr=1e-3, warmup_steps=2)
    meta = zero1.plan_buckets(params, 1)
    state = zero1.zero1_init_local(ocfg, meta, params, dp_index=0)
    plan = sched_compile.compile_zero1_plan(meta, policy=pol, axis_name="data", n_dev=1,
                                            device="cpu")
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        got = zero1.zero1_step(ocfg, meta, params, grads, state, group=g, policy=pol,
                               plan=plan)
        again = zero1.zero1_step(ocfg, meta, params, grads, state, group=g, policy=pol)
        (gb,) = zero1.flatten_buckets(meta, grads)
        with sched.Zero1Execution(plan, g) as ex:
            rs, _ = ex.reduce_scatter(0, gb)
            shard = got[1]["buckets"][0]["master"].to(torch.bfloat16)
            ag, _ = ex.all_gather(0, shard)
        if min_bytes == 0:
            w_ag = min(pol.width_for("weight") + pol.profile.ag_extra_bits, 8)
            want_rs, _ = cc.reduce_scatter_compressed(gb, g, width=pol.width_for("gradient"))
            want_ag, _ = cc.all_gather_compressed(shard, g, width=w_ag)
        else:
            want_rs, want_ag = zero1._raw_reduce_scatter(gb, g, 1), zero1._raw_all_gather(
                shard, g)
    assert_bits_equal(rs, want_rs)
    assert_bits_equal(ag.reshape(-1), want_ag.reshape(-1))
    for a, b in zip(got[0], again[0]):
        assert_bits_equal(a, b)
    for k in got[1]["buckets"][0]:
        assert_bits_equal(got[1]["buckets"][0][k], again[1]["buckets"][0][k], k)
    assert int(got[2]) == int(again[2]) == 0 and float(got[3]) == float(again[3])

    # the reference's zero1_step on the same inputs records the same report
    jparams = [to_jax(np_of(p), "bfloat16") for p in params]
    jgrads = [to_jax(np_of(p), "bfloat16") for p in grads]
    jocfg = jopt.OptimConfig(name=optimizer, lr=1e-3, warmup_steps=2)
    jmeta = jzero1.plan_buckets(jparams, 1)
    jst = jzero1.zero1_init_local(jocfg, jmeta, jparams, ("data",), dp_index=0)
    _, jreports = _in_shard_map(
        lambda p, gr, st: jzero1.zero1_step(jocfg, jmeta, p, gr, st, dp_axes=("data",),
                                            policy=jpol)[2], jparams, jgrads, jst)
    plan_reports = [r for r in reports if r.name == "plan:zero1"]
    # a raw plan's wires record nothing to consolidate
    assert len(plan_reports) == (3 if min_bytes == 0 else 0)
    assert report_rows(plan_reports[:1]) == report_rows(jreports)


def test_launcher_compiles_one_plan_a_policy(monkeypatch):
    """Three steps: one compile, then two hits.  Overflowing on every step
    (width 1, no exception room), each step's raw retry replays the plan of
    the disabled policy: two compiles, four hits, and the raw twin's
    losses."""
    kw = dict(steps=3, batch=2, seq=16, smoke=True, device="cpu", lr=1e-3, warmup=2)
    with single_process_group("cpu"):
        run = launch_train.train("smollm_135m", **kw)
        assert (run.plan_cache.stats.misses, run.plan_cache.stats.hits) == (1, 2)
        monkeypatch.setattr(CompressionProfile, "default", staticmethod(
            lambda dtype_name="bfloat16": CompressionProfile(
                widths={"gradient": 1, "weight": 1}, exc_frac=1e-9)))
        over = launch_train.train("smollm_135m", **kw)
        raw = launch_train.train("smollm_135m", compress=False, **kw)
    assert over.retries == 3
    assert (over.plan_cache.stats.misses, over.plan_cache.stats.hits) == (2, 4)
    assert over.losses == raw.losses == run.losses
    assert [r.name for r in run.wire_reports] == ["plan:zero1"] * 3
    assert {r.name for r in over.wire_reports} == {"plan:zero1"}
    plan = next(iter(run.plan_cache._plans.values()))
    assert plan.kind == "zero1" and plan.axis == ("data",)
    assert [r.wire_bytes for r in run.wire_reports] == [plan.wire_bytes] * 3
