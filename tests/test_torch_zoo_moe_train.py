"""Training deepseek-v2-lite SMOKE (an MLA + SwiGLU prefix layer, then MLA +
MoE layers: 3-D expert leaves, a router, a shared expert) held against the
JAX reference, at 4 x 160 = 640 tokens a step: above ``dropless_below``
(512), so every MoE layer runs the capacity regime (C = int(640 * 2 / 8 *
1.25) = 200) in both.  Apart from ``test_torch_zoo_train`` so that its
reference compiles (a ZeRO-1 and an FSDP step, ~15-30 s each on the CPU)
take a worker of their own.

* the ZeRO-1 bucket holds the reference's bytes in its order, and FSDP's
  plan (``plan_fsdp_tree``, ``fsdp_local_shapes``) equals the reference's
  at 1, 2 and 4 data ranks, the experts' dim (the reference's 'model'
  axis) left alone: exact;
* one whole compressed ZeRO-1 step and one FSDP step (every leaf sharded)
  against the reference's, from its state carried across:
  ``test_torch_zoo_train``'s tolerances for a whole step (loss relative
  1e-4, grad norm relative 1e-2, each weight within ``2 lr_1`` plus one
  bf16 rounding of the larger value), and at most 1% of the weights
  different, as for the dense models, unless the MoE layers' picks part
  between the two packages: then 5%.  The layers agree as closely as
  the dense ones (``test_torch_moe_mla``: outputs within 1/64 of their
  largest magnitude, gradients within 1/64, ``we1``'s 1/32), but XLA:CPU's
  bf16 ``logistic`` moves the hidden states' last bits and with them the
  router's logits, so picks part at near ties.  Each step test counts
  them: each MoE layer's kept (token, expert) picks in the forward at the
  step's starting weights and batch, the reference's jitted forward
  against the port's; here 8 and 26 of about 1130 and 1275 kept picks
  part (a pick kept by one package and not the other counts once), and
  the test requires at most 5% of the kept picks to part (a router that
  picked otherwise would part most).  A parted pick moves the gradient
  of two experts and of every earlier layer, and a first AdamW step
  moves each weight by about ``lr_1`` in the direction of its gradient's
  sign alone, so every near-zero gradient entry whose sign parts gives a
  different weight: measured 2.9% of the weights different (ZeRO-1;
  FSDP the same), loss relative 1.7e-7, grad norm 1.9e-3.  glm4 SMOKE at
  the same 640 tokens a step, with no router: 0.5% different.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.optim import zero1 as jzero1
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import registry, transformer
from repro_torch.optim import zero1
from repro_torch.sched.cache import PlanCache
from repro_torch.train import step as step_lib
from repro_torch.tree_util import tree_flatten, tree_map
from test_torch_models import _Picks
from test_torch_zoo_train import _holds_step, _reference_step, _tcfgs
from torch_port_util import assert_bits_equal, np_of

ARCH = "deepseek_v2_lite_16b"
BATCH, SEQ = 4, 160


def _cfgs():
    return jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)


def _batches(jcfg, cfg, seed=3):
    jb = jregistry.make_batch(jcfg, BATCH, SEQ, rng=np.random.default_rng(seed))
    return jb, registry.make_batch(cfg, BATCH, SEQ, rng=np.random.default_rng(seed),
                                   device="cpu")


def test_the_step_runs_the_capacity_regime():
    _, cfg = _cfgs()
    assert BATCH * SEQ > 512
    assert L.moe_capacity(cfg, BATCH * SEQ) == 200 < BATCH * SEQ
    assert L.moe_capacity(cfg, 512) == 512


def test_zero1_bucket_holds_the_reference_bytes():
    jcfg, cfg = _cfgs()
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    jparams = jax.tree_util.tree_map(
        jnp.asarray, tree_map(lambda t: np_of(t).view(jnp.bfloat16), model.tree()))
    meta, jmeta = zero1.plan_buckets(model.leaves(), 2), jzero1.plan_buckets(jparams, 2)
    assert (meta.dtype_names, meta.members, meta.padded) == \
        (jmeta.dtype_names, jmeta.members, jmeta.padded)
    (bucket,) = zero1.flatten_buckets(meta, model.leaves())
    (jbucket,) = jzero1.flatten_buckets(jmeta, jparams)
    assert_bits_equal(bucket, jbucket)


@pytest.mark.parametrize("n_dp", [1, 2, 4])
def test_fsdp_plan_matches_reference(n_dp):
    """The reference's plan, leaf for leaf: the stacked experts (R, E, ., .)
    shard a dim past E, the router and MLA's down-projections their last."""
    jcfg, cfg = _cfgs()
    tcfg, jtcfg = _tcfgs("fsdp")
    mesh = AbstractMesh((n_dp, 1), ("data", "model"))
    dims = step_lib.plan_fsdp_tree(cfg, tcfg,
                                   mesh_lib.AbstractMesh((n_dp, 1), ("data", "model")))
    assert dims == jstep.plan_fsdp_tree(jcfg, jtcfg, mesh)
    ffn = dims["blocks"][0]["ffn"]
    assert ffn["we1"] == ffn["we3"] == 3 and ffn["we2"] in (2, 3) and ffn["router"] == 2
    local = step_lib.fsdp_local_shapes(transformer.abstract_params(cfg), dims, n_dp)
    want = jstep.fsdp_local_shapes(jtransformer.abstract_params(jcfg), dims, n_dp)
    got = [tuple(t.shape) for t in tree_flatten(local)[0]]
    assert got == [s.shape for s in jax.tree_util.tree_leaves(want)]


def _parted_picks(jcfg, cfg, params, jb, b) -> tuple:
    """(picks parted, picks the reference kept) over the MoE layers of the
    forward at ``params`` (the reference's numpy tree) on the batch: the
    reference's jitted forward against the port's (``_Picks``)."""
    with _Picks() as rec:
        jax.jit(lambda p, t: jtransformer.forward(p, {"tokens": t}, jcfg, remat=False))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(jb["tokens"]))
        with torch.no_grad():
            transformer.load_reference_params(params, cfg, "cpu")(b["tokens"], remat=False)
    assert len(rec.seen) == len(rec.mine) == cfg.repeats
    rec.parted(BATCH, SEQ)
    return rec.n_parted, rec.kept


def _holds_moe_step(state, m, jnew, jm, tcfg, parted, kept):
    assert parted <= 0.05 * kept, (parted, kept)
    _holds_step(state, m, jnew, jm, tcfg, max_diff=0.05 if parted else 0.01)


def test_zero1_step_matches_reference():
    jcfg, cfg = _cfgs()
    tcfg, jtcfg = _tcfgs("zero1")
    jb, b = _batches(jcfg, cfg)
    tree, jnew, jm = _reference_step(jcfg, jtcfg, jb)
    parted = _parted_picks(jcfg, cfg, tree["params"], jb, b)
    model = transformer.load_reference_params(tree["params"], cfg, "cpu")
    state = step_lib.TrainState(
        model=model, opt=zero1.load_reference_zero1_state(tree["opt"], "cpu"),
        meta=zero1.plan_buckets(model.leaves(), 1))
    with launch_train.single_process_group("cpu") as group, launch_train.deterministic():
        m = step_lib.train_step(state, b, tcfg, group=group)
    _holds_moe_step(state, m, jnew, jm, tcfg, *parted)


def test_fsdp_step_matches_reference():
    jcfg, cfg = _cfgs()
    tcfg, jtcfg = _tcfgs("fsdp")
    jb, b = _batches(jcfg, cfg)
    tree, jnew, jm = _reference_step(jcfg, jtcfg, jb)
    parted = _parted_picks(jcfg, cfg, tree["params"], jb, b)
    state = step_lib.load_reference_fsdp_state(tree, cfg, tcfg, device="cpu")
    with launch_train.single_process_group("cpu") as g, launch_train.deterministic():
        m = step_lib.fsdp_train_step(state, b, tcfg, group=g, cache=PlanCache())
    _holds_moe_step(state, m, jnew, jm, tcfg, *parted)


def test_launcher_trains_deepseek_on_the_cpu(capsys, tmp_path):
    launch_train.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
                       "--seq", "16", "--device", "cpu", "--partition", "fsdp",
                       "--microbatches", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss" in out and "partition=fsdp" in out


def test_launcher_trains_an_arch_config_as_given():
    """``train`` takes an ``ArchConfig`` in place of a name, as it is: here
    deepseek-v2-lite SMOKE cut to one MoE layer."""
    cfg = dataclasses.replace(configs.get_smoke(ARCH), repeats=1)
    with launch_train.single_process_group("cpu") as group:
        run = launch_train.train(cfg, steps=1, batch=2, seq=16, device="cpu", group=group)
    assert run.state.model.cfg == cfg and len(run.losses) == 1
    assert run.state.model.params["blocks/0/ffn/we1"].shape[0] == 1
