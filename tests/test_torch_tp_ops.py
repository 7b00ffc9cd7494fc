"""Tensor parallelism over 'model' (``repro_torch.models.tp``) at 1, 2 and 4
gloo ranks (``torch_port_util.tp_ops_rank``), each held against the
unsplit computation on one rank:

* ``copy`` (identity forward, the input gradient summed over the ranks),
  ``reduce`` (the ranks' partial outputs summed, the gradient passed
  through) and ``gather`` (the blocks joined along a dim, the gradient
  reduce-scattered), forward and backward;
* the vocabulary-parallel embedding (``vocab_embed``) and cross-entropy
  (``vocab_ce_sum``), the latter on labels spread over the vocabulary and
  on labels that all fall in the last rank's block;
* SwiGLU with ``w1``/``w3`` column-parallel and ``w2`` row-parallel in
  bf16, forward and backward;
* expert parallelism in bf16: deepseek-v2-lite SMOKE's MoE layer (8
  experts over 1, 2 and 4 ranks, the shared expert column/row parallel),
  dropless and at capacity, held against the JAX reference's ``moe`` on
  one device and its ``jax.vjp``.

Tolerances: the Functions and the embedding run on f32 multiples of 1/8,
whose sums and products are exact in any order: bit for bit.  The
cross-entropy's sum of exponentials adds in another order than one
``logsumexp``: relative 1e-6.  The bf16 SwiGLU rounds each rank's partial
product before the f32 sum over the ranks, where one rank rounds the
whole product once: within 2**-7 of the largest magnitude (one bf16 ulp
at it), plus 1% of each value.  The MoE layer: the slot table every rank
computes (expert picks, slot order, the capacity regime's C-1 drop) is
the reference's bit for bit; the output and the gradients take
``test_torch_moe_mla``'s bounds, 1/64 of each one's largest magnitude
(``we1``'s gradient 1/32): XLA:CPU rounds a bf16 ``logistic`` inside the
expert SwiGLU, and each rank rounds its experts' partial combine and its
shared-expert product before the f32 sum over the ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.models import layers as jL
from repro_torch import configs
from repro_torch.models import layers, tp, transformer
from torch_port_util import (TP_D, TP_F, TP_MOE_ARCH, TP_MOE_CASES, TP_V, nest_paths,
                             run_gloo_ranks, tp_exact, tp_moe_layer, tp_moe_x, tp_ops_rank)

WORLDS = (1, 2, 4)
_RUNS = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def get(world):
        if world not in _RUNS:
            _RUNS[world] = run_gloo_ranks(tp_ops_rank, world,
                                          tmp_path_factory.mktemp(f"tp{world}"))
        return _RUNS[world]
    return get


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_identity_without_a_group():
    x = torch.ones(3)
    for fn in (tp.copy, tp.reduce):
        assert fn(x, None) is x
    assert tp.gather(x, None) is x and tp.all_sum(x, None) is x and tp.all_max(x, None) is x


@pytest.mark.parametrize("world", WORLDS)
def test_copy_sums_the_input_gradient(ranks, world):
    x = t(tp_exact((4, TP_D), 0))
    dx = sum(t(tp_exact((4, 5), 200 + r)) @ t(tp_exact((TP_D, 5), 100 + r)).T
             for r in range(world))
    for r, res in enumerate(ranks(world)):
        np.testing.assert_array_equal(res["copy_y"], (x @ t(tp_exact((TP_D, 5), 100 + r))).numpy())
        np.testing.assert_array_equal(res["copy_dx"], dx.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_reduce_sums_the_outputs(ranks, world):
    y = sum(tp_exact((4, TP_D), 300 + r) for r in range(world))
    for res in ranks(world):
        np.testing.assert_array_equal(res["reduce_y"], y)
        np.testing.assert_array_equal(res["reduce_dx"], tp_exact((4, TP_D), 400))


@pytest.mark.parametrize("world", WORLDS)
def test_gather_joins_blocks_and_reduce_scatters_the_gradient(ranks, world):
    y = np.concatenate([tp_exact((3, 2, 4), 500 + r) for r in range(world)], 1)
    g = sum(tp_exact((3, 2 * world, 4), 600 + r) for r in range(world))
    for r, res in enumerate(ranks(world)):
        np.testing.assert_array_equal(res["gather_y"], y)
        np.testing.assert_array_equal(res["gather_dx"], g[:, 2 * r:2 * r + 2])


@pytest.mark.parametrize("world", WORLDS)
def test_vocab_embed_equals_one_table(ranks, world):
    table = t(tp_exact((TP_V, TP_D), 700)).requires_grad_()
    tokens = t(np.random.default_rng(701).integers(0, TP_V, (3, 7)))
    e = F.embedding(tokens, table)
    e.backward(t(tp_exact((3, 7, TP_D), 702)))
    rows = TP_V // world
    for r, res in enumerate(ranks(world)):
        np.testing.assert_array_equal(res["embed_y"], e.detach().numpy())
        np.testing.assert_array_equal(res["embed_dt"],
                                      table.grad.numpy()[r * rows:(r + 1) * rows])


@pytest.mark.parametrize("tag", ["ce", "ce_last"])
@pytest.mark.parametrize("world", WORLDS)
def test_vocab_ce_equals_one_logsumexp(ranks, world, tag):
    """Labels over the whole vocabulary, and labels all in the last rank's
    block (the other ranks hold none of the gold logits)."""
    seed, lo = {"ce": (801, 0), "ce_last": (802, TP_V - TP_V // world)}[tag]
    labels = t(np.random.default_rng(seed).integers(lo, TP_V, (2, 5)))
    logits = t(np.random.default_rng(800).normal(0, 3, (2, 5, TP_V)).astype(np.float32))
    logits.requires_grad_()
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    loss = torch.sum(torch.logsumexp(logits, -1) - gold)
    loss.backward()
    rows = TP_V // world
    for r, res in enumerate(ranks(world)):
        assert float(res[tag]) == pytest.approx(float(loss.detach()), rel=1e-6)
        np.testing.assert_allclose(res[f"{tag}_dlogits"],
                                   logits.grad.numpy()[..., r * rows:(r + 1) * rows],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_swiglu_split_over_the_ranks(ranks, world):
    bf = lambda a: t(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    x = bf(np.random.default_rng(900).normal(0, 1, (3, TP_D))).requires_grad_()
    p = {k: bf(np.random.default_rng(s).normal(0, 0.5, sh)).requires_grad_()
         for k, s, sh in (("w1", 901, (TP_D, TP_F)), ("w3", 902, (TP_D, TP_F)),
                          ("w2", 903, (TP_F, TP_D)))}
    y = layers.swiglu(p, x)
    y.backward(bf(np.random.default_rng(904).normal(0, 1, (3, TP_D))))
    f = TP_F // world

    def close(got, want, ctx):
        want = want.float().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=2.0 ** -7 * np.abs(want).max(),
                                   err_msg=ctx)

    for r, res in enumerate(ranks(world)):
        close(res["swiglu_y"], y.detach(), "y")
        close(res["swiglu_dx"], x.grad, "dx")
        close(res["swiglu_dw1"], p["w1"].grad[:, r * f:(r + 1) * f], "dw1")
        close(res["swiglu_dw3"], p["w3"].grad[:, r * f:(r + 1) * f], "dw3")
        close(res["swiglu_dw2"], p["w2"].grad[r * f:(r + 1) * f], "dw2")
        if world == 1:  # one rank: the unsplit computation itself
            np.testing.assert_array_equal(res["swiglu_y"], y.detach().float().numpy())


@pytest.fixture(scope="module")
def moe_reference():
    """Per ``TP_MOE_CASES`` input: the reference's output, the slot table's
    tokens it hands ``_expert_sharding_hint`` and its ``jax.vjp``'s
    gradients by path."""
    jcfg, cfg = jconfigs.get_smoke(TP_MOE_ARCH), configs.get_smoke(TP_MOE_ARCH)
    flat = tp_moe_layer(cfg)
    jp = nest_paths({k: jnp.asarray(v, jnp.bfloat16) for k, v in flat.items()})
    out = {}
    hint = jL._expert_sharding_hint
    for tag, (n_tok, kw) in TP_MOE_CASES.items():
        jx, jdy = (jnp.asarray(tp_moe_x(cfg, n_tok, s), jnp.bfloat16) for s in (6, 9))
        seen = []
        jL._expert_sharding_hint = lambda x, n: seen.append(np.asarray(x)) or x
        try:
            y = jL.moe(jp, jx, jcfg, **kw)
        finally:
            jL._expert_sharding_hint = hint
        jgp, jgx = jax.jit(lambda prm, xx, ct, kw=kw: jax.vjp(
            lambda a, b: jL.moe(a, b, jcfg, **kw), prm, xx)[1](ct))(jp, jx, jdy)
        grads = {path: np.asarray(g.astype(jnp.float32)) for (path, _), g in zip(
            transformer.tree_paths(nest_paths(flat)),
            jax.tree_util.tree_leaves(jgp), strict=True)}
        out[tag] = (np.asarray(y.astype(jnp.float32)), seen[0],
                    np.asarray(jgx.astype(jnp.float32)), grads)
    return cfg, out


MOE_GRAD_TOL = {"we1": 1 / 32}  # every other gradient: 1/64, as test_torch_moe_mla


@pytest.mark.parametrize("tag", list(TP_MOE_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_bf16_moe_experts_split_over_the_ranks(ranks, moe_reference, world, tag):
    """Every rank's slot table is the reference's bit for bit; its output
    and input gradient the reference's, its gradients of the router (whole
    on every rank), of its block of the experts and of its block of the
    shared expert the reference's blocks, within the bounds above."""
    cfg, ref = moe_reference
    want_y, want_tok, want_dx, want_grads = ref[tag]
    specs = dict(transformer.tree_paths(layers.spec_moe(cfg)))

    def close(got, want, frac, ctx):
        assert got.shape == want.shape, ctx
        np.testing.assert_allclose(got, want, rtol=0, atol=np.abs(want).max() * frac,
                                   err_msg=ctx)

    for r, res in enumerate(ranks(world)):
        np.testing.assert_array_equal(res[f"moe_{tag}_tok"], want_tok)
        close(res[f"moe_{tag}_y"], want_y, 1 / 64, "y")
        close(res[f"moe_{tag}_dx"], want_dx, 1 / 64, "dx")
        for path, want in want_grads.items():
            for d, e in enumerate(specs[path]):
                if e == "model":
                    want = np.split(want, world, d)[r]
            close(res[f"moe_{tag}_d/{path}"], want,
                  MOE_GRAD_TOL.get(path.split("/")[-1], 1 / 64), path)
