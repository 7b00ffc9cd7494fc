"""Training the dense zoo's new layouts (prefix layers, tied embeddings, the
vision stub) held against the JAX reference: gemma3 SMOKE (a prefix layer,
a sliding-window pattern, tied embeddings) and qwen2-vl SMOKE (vision
embeddings in the batch), and a gemma3 with 11 prefix layers.

* the ZeRO-1 bucket holds the reference's bytes in its order, and FSDP's
  plan (``plan_fsdp_tree``, ``fsdp_local_shapes``) equals the reference's
  at 1, 2 and 4 data ranks, prefix leaves included: exact;
* the gradient of a tied ``embed`` (the lookup's part plus the head's)
  against ``jax.grad`` of the reference's loss: within 2**-6 of the
  largest magnitude plus one bf16 ulp of each entry (the bf16 backward
  rounds in other places in the two frameworks; measured 0.0067 of it);
* one whole compressed ZeRO-1 step against the reference's
  (``build_train_step`` at one rank, from the reference's state carried
  across; the FSDP step is ``test_torch_zoo_fsdp``'s):
  ``test_torch_train``'s tolerances for a whole step (loss relative 1e-4,
  grad norm relative 1e-2, at most 1% of the bf16 weights different), each
  weight within ``2 lr_1`` plus one bf16 rounding of the larger of the two
  values (``test_torch_train`` takes the reference's value alone, which a
  near-zero weight whose sign flips can exceed by that rounding: measured
  3e-7 over ``2 lr_1`` on qwen2-vl).  The losses are not the reference's
  bits: XLA:CPU's bf16 ``logistic`` (ROADMAP Queue C) moves the forward's
  last bits, and with it the loss (measured relative 5e-5 and 3e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.core.policy import CompressionPolicy as JPolicy
from repro.launch.mesh import make_smoke_mesh
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.optim import optimizers as jopt
from repro.optim import zero1 as jzero1
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch_train
from repro_torch.models import registry, transformer
from repro_torch.models.config import LayerSpec
from repro_torch.optim import optimizers as opt
from repro_torch.optim import zero1
from repro_torch.train import step as step_lib
from repro_torch.tree_util import tree_flatten, tree_map
from torch_port_util import assert_bits_equal, np_of

ARCHS = ("gemma3_27b", "qwen2_vl_72b")
BATCH, SEQ, LR, WARMUP = 4, 16, 1e-3, 2


def _prefix11(get):
    cfg = get("gemma3_27b")
    return dataclasses.replace(cfg, prefix=(cfg.prefix[0],) * 11)


def _cfgs(case):
    if case == "prefix11":
        return (_prefix11(jconfigs.get_smoke),
                dataclasses.replace(_prefix11(configs.get_smoke),
                                    prefix=(LayerSpec(window=8),) * 11))
    return jconfigs.get_smoke(case), configs.get_smoke(case)


def _batches(jcfg, cfg, seed=3):
    jb = jregistry.make_batch(jcfg, BATCH, SEQ, rng=np.random.default_rng(seed))
    return jb, registry.make_batch(cfg, BATCH, SEQ, rng=np.random.default_rng(seed),
                                   device="cpu")


def _tcfgs(partition, **kw):
    # remat off: the reference compiles its rematted layers' scans for
    # seconds more; the port's remat is held by the smollm step tests
    common = dict(partition=partition, fsdp_min_bytes=0, loss_chunk=8, remat=False, **kw)
    return (step_lib.TrainConfig(policy=CompressionPolicy(min_bytes=0),
                                 optim=opt.OptimConfig(lr=LR, warmup_steps=WARMUP), **common),
            jstep.TrainConfig(policy=JPolicy(min_bytes=0),
                              optim=jopt.OptimConfig(lr=LR, warmup_steps=WARMUP), **common))


# ---------------------------------------------------------------------------
# layouts: the bucket, the FSDP plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [*ARCHS, "prefix11"])
def test_zero1_bucket_holds_the_reference_bytes(case):
    jcfg, cfg = _cfgs(case)
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
@pytest.mark.parametrize("case", ["gemma3_27b", "prefix11"])
def test_fsdp_plan_covers_prefix_leaves(case, n_dp):
    jcfg, cfg = _cfgs(case)
    tcfg, jtcfg = _tcfgs("fsdp")
    mesh = AbstractMesh((n_dp, 1), ("data", "model"))
    dims = step_lib.plan_fsdp_tree(cfg, tcfg,
                                   mesh_lib.AbstractMesh((n_dp, 1), ("data", "model")))
    assert dims == jstep.plan_fsdp_tree(jcfg, jtcfg, mesh)
    assert any(d >= 0 for k, d in transformer.tree_paths(dims) if k.startswith("prefix_"))
    local = step_lib.fsdp_local_shapes(transformer.abstract_params(cfg), dims, n_dp)
    want = jstep.fsdp_local_shapes(jtransformer.abstract_params(jcfg), dims, n_dp)
    got = [tuple(t.shape) for t in tree_flatten(local)[0]]
    assert got == [s.shape for s in jax.tree_util.tree_leaves(want)]


# ---------------------------------------------------------------------------
# the tied embedding's gradient, whole steps
# ---------------------------------------------------------------------------

def test_tied_embedding_gradient_sums_lookup_and_head():
    jcfg, cfg = _cfgs("gemma3_27b")
    assert cfg.tie_embeddings and "lm_head" not in dict(transformer.tree_paths(
        transformer.abstract_params(cfg)))
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    jparams = jax.tree_util.tree_map(
        jnp.asarray, tree_map(lambda t: np_of(t).view(jnp.bfloat16), model.tree()))
    jb, b = _batches(jcfg, cfg)

    def jloss(p):
        h = jtransformer.forward(p, jb, jcfg, remat=False)
        return jstep.chunked_ce_loss(p, h, jb["labels"], jcfg, 8)

    want = np.asarray(jax.jit(jax.grad(jloss))(jparams)["embed"].astype(jnp.float32))
    tcfg = step_lib.TrainConfig(loss_chunk=8, remat=False)
    step_lib.loss_fn(model, b, tcfg).backward()
    got = model.params["embed"].grad.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=np.abs(want).max() / 64)
    # without the head's part it is another gradient
    model.params["embed"].grad = None
    hidden = model(b["tokens"])
    step_lib.chunked_ce_loss(model.params["embed"].detach(), hidden, b["labels"],
                             8).backward()
    assert not np.allclose(model.params["embed"].grad.float().numpy(), want,
                           atol=np.abs(want).max() / 64)


def _reference_step(jcfg, jtcfg, jb):
    mesh = make_smoke_mesh(1)
    jstate, _ = jstep.build_train_state(jcfg, jtcfg, mesh, jax.random.PRNGKey(0))
    jfn, _ = jstep.build_train_step(jcfg, jtcfg, mesh)
    tree = jax.tree_util.tree_map(np.asarray, jstate)
    jnew, jm = jax.jit(jfn)(jstate, jb)
    return tree, jnew, jm


def _holds_step(state, m, jnew, jm, tcfg, max_diff=0.01, loss_rel=1e-4, gnorm_rel=1e-2):
    assert m["overflow"] == int(jm["overflow"]) == 0
    assert state.step == int(jnew["step"]) == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=loss_rel)
    assert float(m["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=gnorm_rel)
    lr1 = float(opt.lr_at(tcfg.optim, torch.tensor(1)))
    n_diff = n_all = 0
    for got, want in zip(state.model.leaves(), jax.tree_util.tree_leaves(jnew["params"]),
                         strict=True):
        g, w = got.detach().float().numpy(), np.asarray(want, np.float32)
        bound = 2 * lr1 + 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w))
        assert (np.abs(g - w) <= bound).all(), np.abs(g - w).max()
        n_diff += int((g != w).sum())
        n_all += g.size
    assert n_diff <= max_diff * n_all, (n_diff, n_all)
    return abs(float(m["loss"]) - float(jm["loss"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_step_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    tcfg, jtcfg = _tcfgs("zero1")
    jb, b = _batches(jcfg, cfg)
    tree, jnew, jm = _reference_step(jcfg, jtcfg, jb)
    model = transformer.load_reference_params(tree["params"], cfg, "cpu")
    state = step_lib.TrainState(
        model=model, opt=zero1.load_reference_zero1_state(tree["opt"], "cpu"),
        meta=zero1.plan_buckets(model.leaves(), 1))
    with launch_train.single_process_group("cpu") as group, launch_train.deterministic():
        m = step_lib.train_step(state, b, tcfg, group=group)
    _holds_step(state, m, jnew, jm, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_each_new_layout_on_the_cpu(arch, capsys, tmp_path):
    launch_train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                       "--seq", "16", "--device", "cpu", "--partition", "fsdp",
                       "--microbatches", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss" in out and "partition=fsdp" in out
