"""The port's compressed FSDP (``optim/fsdp.py``, the ``fsdp_gather`` plan
kind, the FSDP train step) held against the JAX reference and against
exact arithmetic.

* planning: ``plan_fsdp`` masks and ``plan_fsdp_tree`` dims (smollm SMOKE
  and full width) equal the reference's at 1, 2 and 4 data ranks; the
  ``fsdp_gather`` plans' fields and bytes equal the reference compiler's;
* the gather at one rank: forward bits and the backward on a given
  cotangent equal the reference's ``_make_gather`` and its VJP inside
  ``shard_map``, compressed and raw, fused and unfused;
* at 2 and 4 gloo ranks: the gathered leaf is the concatenation of the
  ranks' shards, its backward the f32 sum of the ranks' cotangent slices in
  rank order cast to the leaf's dtype, compressed == raw, flag 0; a 2-step
  FSDP train at 2 microbatches is bit-identical compressed vs raw;
* one FSDP step against the reference's ``_build_fsdp_step`` at one rank
  from the same state (carried across by ``load_reference_fsdp_state``),
  at ``test_torch_train``'s tolerances for a whole step (restated below);
* the state round-trips through ``CheckpointManager`` bit for bit; the
  launcher trains under ``--partition fsdp``.

Tolerances: exact everywhere, except the whole step against the
reference: loss relative 1e-4, grad norm relative 1e-2, each bf16 weight
within ``2 lr_1 + 2**-7 |w|`` and at most 1% of them different (the bf16
backward rounds in other places in the two frameworks; see
``test_torch_train``).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core.policy import CompressionPolicy as JPolicy
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro.launch.mesh import make_mesh, make_smoke_mesh
from repro.models import transformer as jtransformer
from repro.optim import fsdp as jfsdp
from repro.optim import optimizers as jopt
from repro.sched import compile as jcompile
from repro.train import step as jstep
from repro_torch import configs, kernels
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.optim import fsdp
from repro_torch.optim import optimizers as opt
from repro_torch.sched import compile as sched_compile
from repro_torch.sched import executor
from repro_torch.sched.cache import PlanCache
from repro_torch.train import step as step_lib
from repro_torch.tree_util import bits_equal, tree_leaves
from torch_port_util import (FSDP_LOCAL, FSDP_VARIANTS, assert_bits_equal, fsdp_bits,
                             fsdp_full_shape, fsdp_rank, run_gloo_ranks, to_jax,
                             to_torch)

ARCH, BATCH, SEQ, LR, WARMUP = "smollm_135m", 4, 32, 1e-3, 2
BUCKET_FIELDS = ("dtype_name", "members", "length", "path", "width", "ag_width", "block",
                 "exc_frac", "fused", "encode_fused", "n_dev", "chunk", "wire_bytes",
                 "raw_bytes")


def _jmesh(n_dp: int):
    return AbstractMesh((n_dp, 1), ("data", "model"))


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_bytes", [0, 4096])
@pytest.mark.parametrize("n_dp", [1, 2, 4])
def test_plan_fsdp_matches_reference(n_dp, min_bytes):
    shapes = {"a": ((64, 40), "bfloat16"), "b": ((3, 6), "float32"), "c": ((7,), "float16"),
              "d": ((), "float32"), "e": ((8, 4), "int32"), "f": ((1024, 2), "bfloat16")}
    tree = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
            for k, (s, d) in shapes.items()}
    jtree = {k: jax.ShapeDtypeStruct(s, jnp.dtype(d)) for k, (s, d) in shapes.items()}
    plan = fsdp.plan_fsdp(tree, n_dp, min_shard_bytes=min_bytes)
    jplan = jfsdp.plan_fsdp(jtree, n_dp, min_shard_bytes=min_bytes)
    assert dataclasses.astuple(plan) == dataclasses.astuple(jplan)
    assert fsdp.mask_tree(plan, tree) == jfsdp.mask_tree(jplan, jtree)
    local = fsdp.shard_tree(plan, {k: torch.arange(int(np.prod(s)) or 1).reshape(s)
                                   for k, (s, _) in shapes.items()}, n_dp - 1)
    for k, m in fsdp.mask_tree(plan, tree).items():
        want = shapes[k][0][:-1] + (shapes[k][0][-1] // n_dp,) if m else shapes[k][0]
        assert tuple(local[k].shape) == want, k


@pytest.mark.parametrize("get,min_bytes", [("get_smoke", 0), ("get_smoke", 1 << 20),
                                           ("get", 1 << 20)])
@pytest.mark.parametrize("n_dp", [1, 2, 4])
def test_plan_fsdp_tree_matches_reference(get, min_bytes, n_dp):
    cfg, jcfg = getattr(configs, get)(ARCH), getattr(jconfigs, get)(ARCH)
    dims = step_lib.plan_fsdp_tree(cfg, step_lib.TrainConfig(fsdp_min_bytes=min_bytes),
                                   mesh_lib.AbstractMesh((n_dp, 1), ("data", "model")))
    jdims = jstep.plan_fsdp_tree(jcfg, jstep.TrainConfig(fsdp_min_bytes=min_bytes),
                                 _jmesh(n_dp))
    assert dims == jdims
    if get == "get":  # full width: the 7 projections and the embedding shard
        assert sum(d >= 0 for d in tree_leaves(dims)) == 8
    local = step_lib.fsdp_local_shapes(transformer.abstract_params(cfg), dims, n_dp)
    jlocal = jstep.fsdp_local_shapes(jtransformer.abstract_params(jcfg), jdims, n_dp)
    assert [tuple(t.shape) for t in tree_leaves(local)] == \
        [tuple(t.shape) for t in jax.tree_util.tree_leaves(jlocal)]


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("policy", ["default", "unfused", "disabled", "widths"])
@pytest.mark.parametrize("shape,dtype", [((576, 192), "bfloat16"), ((48,), "bfloat16"),
                                         ((3, 700), "float32"), ((512,), "float16"),
                                         ((100, 9), "float8_e4m3fn")])
def test_fsdp_gather_plan_matches_reference(shape, dtype, policy, n_dev):
    kw = {"default": {}, "unfused": {"fused_encode": False, "fused_decode_reduce": False},
          "disabled": {"enabled": False}, "widths": {"min_bytes": 0}}[policy]
    pol, jpol = CompressionPolicy(**kw), JPolicy(**kw)
    if policy == "widths":
        from repro.core.calibrate import CompressionProfile as JProfile

        from repro_torch.core.calibrate import CompressionProfile
        w = {"gradient": 3, "weight": 6}
        pol = dataclasses.replace(pol, profile=CompressionProfile(widths=w))
        jpol = dataclasses.replace(jpol, profile=JProfile(widths=w))
    plan = sched_compile.compile_fsdp_gather_plan(shape, dtype, "data", policy=pol,
                                                  n_dev=n_dev, device="cpu")
    jplan = jcompile.compile_fsdp_gather_plan(shape, dtype, "data", policy=jpol, n_dev=n_dev)
    assert plan.kind == jplan.kind == "fsdp_gather"
    rows = lambda p: [tuple(getattr(b, f) for f in BUCKET_FIELDS)  # noqa: E731
                      for b in p.buckets]
    assert rows(plan) == rows(jplan)
    assert (plan.axis, plan.n_dev, plan.n_leaves) == (jplan.axis, jplan.n_dev, jplan.n_leaves)
    assert (plan.wire_bytes, plan.raw_bytes) == (jplan.wire_bytes, jplan.raw_bytes)
    assert (plan.backend, plan.use_kernels) == ("cpu", False)
    if policy == "widths":
        assert (plan.buckets[0].width, plan.buckets[0].ag_width) == (3, 6)


def test_fsdp_gather_plan_is_cached_on_its_signature():
    cache, pol = PlanCache(), CompressionPolicy()
    get = lambda shape, **kw: sched_compile.cached_fsdp_gather_plan(  # noqa: E731
        shape, "bfloat16", "data", policy=pol, n_dev=2, device="cpu", cache=cache, **kw)
    a = get((576, 192))
    assert get((576, 192)) is a and get((192, 576)) is not a
    assert (cache.stats.misses, cache.stats.hits) == (2, 1)
    assert a.key == sched_compile.fsdp_gather_plan_key((576, 192), "bfloat16", "data", pol,
                                                       2, device="cpu")
    with pytest.raises(ValueError, match="fsdp_gather"):
        executor.gather_from_plan(sched_compile.compile_all_gather_plan(
            10, "bfloat16", "data", policy=pol, n_dev=1, device="cpu"))


def test_wire_bytes_are_the_gathers_reports():
    """A compressed gather's all-gather and reduce-scatter reports add up to
    the plan's wire and raw bytes."""
    from repro_torch.core.policy import capture_wire_reports

    pol = CompressionPolicy(min_bytes=0)
    plan = sched_compile.compile_fsdp_gather_plan((64, 40), "bfloat16", "data", policy=pol,
                                                  n_dev=1, device="cpu")
    x = to_torch(fsdp_bits((64, 40), "bfloat16", 1), "bfloat16").requires_grad_()
    with launch_train.single_process_group("cpu") as g, capture_wire_reports() as reps:
        full, _ = executor.gather_from_plan(plan, g)(x)
        full.backward(torch.ones_like(full))
    assert [r.name for r in reps] == ["all_gather", "reduce_scatter"]
    assert sum(r.wire_bytes for r in reps) == plan.wire_bytes
    assert sum(r.raw_bytes for r in reps) == plan.raw_bytes


def test_a_backward_on_another_thread_reports_into_the_callers_capture():
    """On CUDA the autograd engine runs a backward on a device thread of its
    own; a backward run from another thread stands for it here: the
    gathers' reduce-scatters and the rematerialised layers' gathers report
    into the capture of the thread that ran the forward."""
    import threading

    from repro_torch.core.policy import capture_wire_reports

    tcfg = step_lib.TrainConfig(partition="fsdp", fsdp_min_bytes=0, loss_chunk=16,
                                policy=CompressionPolicy(min_bytes=0))
    cfg = configs.get_smoke(ARCH)
    batch = {k: torch.from_numpy(v.astype(np.int64)) for k, v in JDataPipeline(
        JDataConfig(vocab=cfg.vocab, global_batch=2, seq_len=16)).batch_at(0).items()}
    with launch_train.single_process_group("cpu") as g:
        state = step_lib.build_train_state(cfg, tcfg, generator=torch.Generator().manual_seed(0),
                                           group=g, device="cpu")
        with capture_wire_reports() as reps:
            loss = step_lib.fsdp_loss_fn(state, batch, tcfg, group=g, cache=PlanCache())
            n_fwd = len(reps)
            worker = threading.Thread(target=loss.backward)
            worker.start()
            worker.join(120)
        assert not worker.is_alive()
    names = [r.name for r in reps]
    n_block = cfg.repeats * sum(d >= 0 for d in tree_leaves(state.fsdp_dims["blocks"]))
    assert n_fwd == n_block + 1 and names[:n_fwd] == ["all_gather"] * n_fwd
    assert names.count("all_gather") == n_fwd + n_block
    assert names.count("reduce_scatter") == n_fwd
    assert all(p.grad is not None for p in state.model.leaves())


# ---------------------------------------------------------------------------
# the gather at one rank, against the reference's custom VJP
# ---------------------------------------------------------------------------

GATHER_CASES = {  # name -> (local shape, dtype, compressed, use_fused, fused_encode)
    "bf16": ((64, 40), "bfloat16", True, True, True),
    "bf16_unfused": ((64, 40), "bfloat16", True, False, False),
    "bf16_3d": ((3, 40, 24), "bfloat16", True, True, True),
    "f32": ((300, 6), "float32", True, True, True),
    "f16_tail": ((1500,), "float16", True, True, True),
    "raw": ((64, 40), "bfloat16", False, True, True),
}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_and_its_backward_match_the_reference(case):
    shape, dt, compressed, use_fused, fused_encode = GATHER_CASES[case]
    args = (("data",), 6, 5, 512, 0.02, compressed, shape, dt, use_fused, fused_encode)
    x, ct = fsdp_bits(shape, dt, 7), fsdp_bits(shape, dt, 8)
    jgather = jfsdp._make_gather(*args)

    def body(local, cot):
        (full, flag), vjp = jax.vjp(jgather, local)
        (grad,) = vjp((cot, np.zeros((), jax.dtypes.float0)))
        return full, flag, grad

    mesh = make_mesh((1, 1), ("data", "model"))
    jfull, jflag, jgrad = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P(), P()),
        axis_names={"data", "model"}, check_vma=False))(to_jax(x, dt), to_jax(ct, dt))

    wire = fsdp.GatherWire(*args)
    local = to_torch(x, dt).requires_grad_()
    with launch_train.single_process_group("cpu") as g:
        full, flag = wire(local, g)
        assert not flag.requires_grad
        (grad,) = torch.autograd.grad(full, local, to_torch(ct, dt))
    assert_bits_equal(full, jfull, "forward")
    assert_bits_equal(full, local, "a one-rank gather is the shard")
    assert_bits_equal(grad, jgrad, "backward")
    assert int(flag) == int(jflag) == 0


# ---------------------------------------------------------------------------
# 2 and 4 gloo ranks: exact arithmetic, compressed == raw, training twins
# ---------------------------------------------------------------------------

_RUNS = {}


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    k = request.param
    if k not in _RUNS:
        _RUNS[k] = run_gloo_ranks(fsdp_rank, k, tmp_path_factory.mktemp(f"fsdp{k}"),
                                  2, 8, 16, timeout=300)
    return k, _RUNS[k]


def _seeded(k: str, i: int, seed: int, shape):
    return to_torch(fsdp_bits(shape, FSDP_LOCAL[k][1], seed + 10 * i), FSDP_LOCAL[k][1])


@pytest.mark.parametrize("variant", sorted(FSDP_VARIANTS))
def test_gathered_leaf_is_the_concatenation_of_the_shards(ranks, variant):
    world, res = ranks
    for i, (k, (shape, _)) in enumerate(FSDP_LOCAL.items()):
        sharded = shape[-1] % world == 0
        for r in range(world):
            assert bool(res[r][f"{variant}_mask"][i]) == sharded
            if sharded:
                want = torch.cat([_seeded(k, i, 200 + j, shape) for j in range(world)], -1)
            else:
                want = _seeded(k, i, 200 + r, shape)
            assert_bits_equal(res[r][f"{variant}_full_{k}"], want, (variant, k, r))
            assert int(res[r][f"{variant}_flag"]) == 0


@pytest.mark.parametrize("variant", sorted(FSDP_VARIANTS))
def test_gather_backward_is_the_rank_order_f32_sum(ranks, variant):
    """Rank j's gradient: zeros, then += each rank's cotangent slice j in
    f32, in rank order, cast to the leaf's dtype."""
    world, res = ranks
    for i, (k, (shape, dt)) in enumerate(FSDP_LOCAL.items()):
        if shape[-1] % world:
            assert f"{variant}_grad_{k}" not in res[0]  # replicated: no gather
            continue
        f = shape[-1]
        cts = [_seeded(k, i, 300 + r, fsdp_full_shape(shape, world)) for r in range(world)]
        for j in range(world):
            acc = torch.zeros(shape, dtype=torch.float32)
            for ct in cts:
                acc = acc + ct[..., j * f:(j + 1) * f].to(torch.float32)
            assert_bits_equal(res[j][f"{variant}_grad_{k}"], acc.to(getattr(torch, dt)),
                              (variant, k, j))


def test_fsdp_training_twins_are_bit_identical(ranks):
    """Two FSDP steps of smollm SMOKE at 2 microbatches, compressed and
    raw: the same losses on every rank, the same shards on each."""
    world, res = ranks
    for r in range(world):
        assert np.array_equal(res[r]["comp_losses"], res[r]["rawtrain_losses"])
        assert np.array_equal(res[r]["comp_gnorms"], res[r]["rawtrain_gnorms"])
        assert np.array_equal(res[r]["comp_params"], res[r]["rawtrain_params"])
        assert np.array_equal(res[r]["comp_losses"], res[0]["comp_losses"])
        assert np.isfinite(res[r]["comp_losses"]).all()
        # 4 leaf signatures (per-layer projections x 2 shapes, norms, embed):
        # one compile each, every other gather a hit
        assert int(res[r]["comp_misses"]) == int(res[r]["rawtrain_misses"]) == 4
        assert int(res[r]["comp_hits"]) == int(res[r]["rawtrain_hits"]) > 0
    assert not np.array_equal(res[0]["comp_params"], res[1]["comp_params"])


# ---------------------------------------------------------------------------
# one step against the reference's, the state, the launcher
# ---------------------------------------------------------------------------

def _tcfgs(**kw):
    common = dict(partition="fsdp", fsdp_min_bytes=0, loss_chunk=16, **kw)
    return (step_lib.TrainConfig(policy=CompressionPolicy(min_bytes=0),
                                 optim=opt.OptimConfig(lr=LR, warmup_steps=WARMUP), **common),
            jstep.TrainConfig(policy=JPolicy(min_bytes=0),
                              optim=jopt.OptimConfig(lr=LR, warmup_steps=WARMUP), **common))


def test_fsdp_step_matches_reference():
    """One compressed FSDP step at 2 microbatches on a one-rank group,
    from the reference's initial FSDP state carried across."""
    tcfg, jtcfg = _tcfgs(microbatches=2)
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    mesh = make_smoke_mesh(1)
    jstate, _ = jstep.build_train_state(jcfg, jtcfg, mesh, jax.random.PRNGKey(0))
    jfn, _ = jstep.build_train_step(jcfg, jtcfg, mesh)
    tree = jax.tree_util.tree_map(np.asarray, jstate)
    batch = JDataPipeline(JDataConfig(vocab=jcfg.vocab, global_batch=BATCH, seq_len=SEQ,
                                      seed=0)).batch_at(0)
    jnew, jm = jax.jit(jfn)(jstate, batch)

    state = step_lib.load_reference_fsdp_state(tree, cfg, tcfg, device="cpu")
    assert state.fsdp_dims == jstep.plan_fsdp_tree(jcfg, jtcfg, mesh)
    for got, want in zip(state.model.leaves(), jax.tree_util.tree_leaves(tree["params"])):
        assert_bits_equal(got, want)
    tb = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}
    with launch_train.single_process_group("cpu") as g, launch_train.deterministic():
        m = step_lib.fsdp_train_step(state, tb, tcfg, group=g, cache=PlanCache())
    assert m["overflow"] == int(jm["overflow"]) == 0
    assert state.step == int(jnew["step"]) == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(m["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=1e-2)
    lr1 = float(opt.lr_at(tcfg.optim, torch.tensor(1)))
    n_diff = n_all = 0
    for got, want in zip(state.model.leaves(), jax.tree_util.tree_leaves(jnew["params"])):
        g, w = got.detach().float().numpy(), np.asarray(want, np.float32)
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=2 * lr1)
        n_diff += int((g != w).sum())
        n_all += g.size
    assert n_diff <= 0.01 * n_all, (n_diff, n_all)
    assert int(state.opt["count"]) == 1


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_fsdp_state_round_trips_through_a_checkpoint(tmp_path, optimizer):
    tcfg = step_lib.TrainConfig(partition="fsdp", fsdp_min_bytes=0, loss_chunk=16,
                                policy=CompressionPolicy(min_bytes=0),
                                optim=opt.OptimConfig(name=optimizer, lr=LR,
                                                      warmup_steps=WARMUP))
    with launch_train.single_process_group("cpu") as g:
        state = step_lib.build_train_state(configs.get_smoke(ARCH), tcfg,
                                           generator=torch.Generator().manual_seed(0),
                                           group=g, device="cpu")
        batch = {k: torch.from_numpy(v.astype(np.int64)) for k, v in JDataPipeline(
            JDataConfig(vocab=256, global_batch=BATCH, seq_len=SEQ)).batch_at(0).items()}
        step_lib.fsdp_train_step(state, batch, tcfg, group=g)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    restored, step = mgr.restore(state, device="cpu")
    assert step == 1 and restored.step == state.step == 1
    assert restored.fsdp_dims == state.fsdp_dims and restored.meta is None
    assert bits_equal(restored.tree(), state.tree())
    assert set(restored.opt) == {"adamw": {"m", "v", "count"},
                                 "adafactor": {"f", "count"}}[optimizer]


def test_launcher_trains_fsdp_with_microbatches(capsys):
    launch_train.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "4",
                       "--seq", "16", "--device", "cpu", "--partition", "fsdp",
                       "--microbatches", "2"])
    out = capsys.readouterr().out
    assert re.search(r"step +1 loss", out)
    assert "retries 0 | compressed=True | partition=fsdp" in out


def test_fsdp_twins_through_the_launcher_launch_no_kernel_on_the_cpu():
    kernels.clear_launch_counts()
    runs = {}
    with launch_train.single_process_group("cpu"):
        for compress in (True, False):
            runs[compress] = launch_train.train(
                ARCH, steps=2, batch=BATCH, seq=SEQ, compress=compress, smoke=True,
                device="cpu", lr=LR, warmup=WARMUP, partition="fsdp", microbatches=2)
    comp, raw = runs[True], runs[False]
    assert comp.losses == raw.losses and comp.retries == raw.retries == 0
    assert bits_equal(comp.state.tree(), raw.state.tree())
    # at smoke size every leaf is under fsdp_min_bytes: all replicated
    assert all(d < 0 for d in tree_leaves(comp.state.fsdp_dims))
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_fsdp_entry_points_default_to_cuda_and_refuse_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke(ARCH)
    tcfg = step_lib.TrainConfig(partition="fsdp")
    tree = {"params": {k: np.zeros(tuple(v.shape), np.float32) for k, v in
                       transformer.abstract_params(cfg).items() if k != "blocks"},
            "opt": {}, "step": np.int32(0)}
    with pytest.raises(RuntimeError, match="cuda"):
        step_lib.load_reference_fsdp_state(tree, cfg, tcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        step_lib.build_train_state(cfg, tcfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--arch", ARCH, "--smoke", "--steps", "1", "--partition", "fsdp"])
