"""MoE and MLA (``layers.moe``, ``layers.mla_attention`` and its latent
cache) held against the JAX reference's layers at deepseek-v2-lite SMOKE
widths (d_model 64, 4 heads of 16, kv_lora 32, rope_dim 8; 8 experts, top
2, one shared), on numpy-seeded inputs and weights at the reference's init
scales.

The reference's MoE exposes its dispatch through ``_expert_sharding_hint``,
which it calls on the slot table's tokens (E, C), the gathered tokens and
the expert outputs: the tests record those calls.

Tolerances, with their reasons:
* the latents a prefill or a decode step writes (``c_kv``, the rotated
  ``k_rope``), the slot table's tokens (expert picks, slot order, dropped
  picks: the capacity regime's C-1 quirk included), the gathered tokens,
  and the combine's f32 sums: exact;
* MLA outputs: within one bf16 ulp of the largest magnitude (2**-8; on
  these inputs measured 0, bit-equal, for the training form, the prefill
  and each decode step): both take f32 scores and softmax, but the port's
  training form takes one softmax where the reference goes online over
  tiles, which may sum in another order before the cast to bf16;
* MoE expert outputs and the layer's output: within 1/64 of the largest
  magnitude (measured 0.0044 and 0.0039 dropless; 0.0037 and 0.0067 at
  capacity factor 0.5, 0.0035 and 0.0048 at 1.0): XLA:CPU rounds a bf16
  ``logistic`` inside (ROADMAP Queue C), so the expert SwiGLU differs in
  the last bf16 bits, as the dense SwiGLU's does (``test_torch_models``).
  Through a whole model the differences reach the router, whose picks
  can then part at near ties: deepseek SMOKE's forward and logits stay
  within ``test_torch_models``' 1/32 (measured 0.0265 and 0.0240 for
  v2-lite, 0.0251 and 0.0268 for v3).
* MoE gradients (input, router, experts, shared expert; the reference's
  ``jax.vjp`` against torch autograd): within 1/64 of each one's largest
  magnitude (measured up to 0.0095 for the input, 0.0064 for the router),
  but the experts' first matrix ``we1`` within 1/32 (measured 0.0217, 3
  bf16 ulps at its largest entry): its gradient passes through the
  derivative of the SwiGLU's silu, which both round to bf16 around the
  logistic above.  A router gradient that is zero, detached, sign-flipped
  or taken with the renormalisation detached fails this.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jL
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.tree_util import tree_map
from torch_port_util import assert_bits_equal, np_of

ARCH = "deepseek_v2_lite_16b"
B, S, MAX_LEN, N_DECODE = 2, 16, 32, 4


def _cfgs():
    return jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)


def _draw(shapes: dict, seed: int) -> dict:
    """Weights of one layer's ``(shape, scale)`` tree drawn with numpy in
    path order, rounded to bf16: ``{path: torch bf16}``."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, (shape, scale) in transformer.tree_paths(shapes):
        a = np.ones(shape, np.float32) if scale is None else \
            (rng.normal(0, 1, shape) * scale).astype(np.float32)
        out[path] = torch.from_numpy(a).to(torch.bfloat16)
    return out


def _trees(flat: dict, prefix: str) -> tuple:
    """(port tree, reference tree) of the leaves under ``prefix``."""
    def nest(fn):
        tree = {}
        for path, t in flat.items():
            if not path.startswith(prefix):
                continue
            *keys, last = path[len(prefix):].split("/")
            node = tree
            for k in keys:
                node = node.setdefault(k, {})
            node[last] = fn(t)
        return tree

    return nest(lambda t: t), nest(lambda t: jnp.asarray(np_of(t).view(jnp.bfloat16)))


def _layer(cfg, seed=0):
    """One MoE + MLA layer's weights (the SMOKE pattern's spec)."""
    return _draw(transformer._layer_shapes(cfg, cfg.pattern[0]), seed)


def _x(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).normal(0, scale, shape)).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16), jnp.asarray(a, jnp.bfloat16)


def _close(got, want, frac):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=np.abs(want).max() * frac)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    jcfg, cfg = _cfgs()
    p, jp = _trees(_layer(cfg, 1), "mixer/")
    return jcfg, cfg, p, jp


def _mla_ropes(cfg, positions):
    return L.rope_table(torch.as_tensor(positions), cfg.mla.rope_dim, cfg.rope_theta)


def test_mla_leaves_and_cache_are_the_reference_shapes(mla):
    jcfg, cfg, p, _ = mla
    want = jax.eval_shape(lambda: jL.init_mla(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    assert {k: tuple(t.shape) for k, t in p.items()} == {k: v.shape for k, v in want.items()}
    assert tuple(p["wq"].shape) == (cfg.d_model, cfg.n_heads * (cfg.hd + cfg.mla.rope_dim))
    cache = transformer.init_cache(cfg, B, MAX_LEN, "cpu")
    assert {k: tuple(t.shape) for k, t in cache["prefix_0"]["kv"].items()} == \
        {"c_kv": (B, MAX_LEN, 32), "k_rope": (B, MAX_LEN, 8)}
    assert tuple(cache["blocks"][0]["kv"]["c_kv"].shape) == (cfg.repeats, B, MAX_LEN, 32)


def test_mla_training_forward_matches_reference(mla):
    """The training form: the port's one softmax against the reference's
    tiled online softmax, the scale 1/sqrt(hd + rope_dim) in both."""
    jcfg, cfg, p, jp = mla
    x, jx = _x((B, S, cfg.d_model), 2)
    want, _ = jL.mla_attention(jp, jx, jcfg, spec=jcfg.pattern[0], positions=jnp.arange(S))
    with torch.no_grad():
        got = L.mla_attention(p, x, cfg, cfg.pattern[0], *_mla_ropes(cfg, np.arange(S)))
    _close(got, want, 2.0 ** -8)


def test_mla_prefill_and_decode_match_reference(mla):
    """A prefill writes c_kv and k_rope at [0, S) exactly; then 4 decode
    steps, each splicing its latents at cache_pos exactly and attending
    over every position up to it."""
    jcfg, cfg, p, jp = mla
    spec = cfg.pattern[0]
    x, jx = _x((B, S, cfg.d_model), 3)
    cache = {k: t[0] for k, t in transformer.init_cache(cfg, B, MAX_LEN, "cpu")["blocks"][0]
             ["kv"].items()}
    jcache = {k: jnp.zeros(t.shape, jnp.bfloat16) for k, t in cache.items()}
    want, jcache = jL.mla_attention(jp, jx, jcfg, spec=jcfg.pattern[0],
                                    positions=jnp.arange(S), cache=jcache, prefill=True)
    with torch.no_grad():
        got = L.mla_attention(p, x, cfg, spec, *_mla_ropes(cfg, np.arange(S)), cache)
    _close(got, want, 2.0 ** -8)
    for k in ("c_kv", "k_rope"):
        assert_bits_equal(cache[k], jcache[k], k)
    assert not cache["c_kv"][:, S:].any()
    for step in range(N_DECODE):
        pos = S + step
        x, jx = _x((B, 1, cfg.d_model), 10 + step)
        want, jcache = jL.mla_attention(jp, jx, jcfg, spec=jcfg.pattern[0],
                                        positions=jnp.full((B, 1), pos), cache=jcache,
                                        cache_pos=pos)
        with torch.no_grad():
            got = L.mla_attention(p, x, cfg, spec, *_mla_ropes(cfg, [pos]), cache, pos)
        _close(got, want, 2.0 ** -8)
        for k in ("c_kv", "k_rope"):
            assert_bits_equal(cache[k], jcache[k], f"step {step} {k}")
        assert cache["c_kv"][:, pos].any() and not cache["c_kv"][:, pos + 1:].any()


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_layer():
    jcfg, cfg = _cfgs()
    p, jp = _trees(_layer(cfg, 4), "ffn/")
    return jcfg, cfg, p, jp


def _reference_moe(jp, jx, jcfg, monkeypatch, **kw):
    """The reference's output and what it hands ``_expert_sharding_hint``:
    the slot table's tokens (E, C), the gathered tokens (E, C, D) and the
    expert outputs (E, C, D)."""
    seen = []

    def hint(x, n_experts):
        seen.append(np.asarray(x))
        return x

    monkeypatch.setattr(jL, "_expert_sharding_hint", hint)
    y = jL.moe(jp, jx, jcfg, **kw)
    monkeypatch.undo()
    return y, seen


def _port_moe(p, x, cfg, **kw):
    """The port's output and its slot table's tokens, gathered tokens and
    expert outputs, as ``layers.moe`` computes them (``moe_dispatch``)."""
    T, D = x.shape[0] * x.shape[1], x.shape[2]
    d = L.moe_dispatch(p, x.reshape(T, D), cfg, L.moe_capacity(cfg, T, **kw))
    return L.moe(p, x, cfg, **kw), (d.tok, d.xg, d.h), d.eids, d.where


def _holds_moe(moe_layer, monkeypatch, x_seed, n_tok, **kw):
    jcfg, cfg, p, jp = moe_layer
    x, jx = _x((1, n_tok, cfg.d_model), x_seed)
    want, (jtok, jxg, jh) = _reference_moe(jp, jx, jcfg, monkeypatch, **kw)
    with torch.no_grad():
        got, (tok, xg, h), eids, where = _port_moe(p, x, cfg, **kw)
    assert np.array_equal(tok.numpy(), jtok)
    assert_bits_equal(xg, jxg, "gathered tokens")
    _close(h, jh, 1 / 64)
    _close(got, want, 1 / 64)
    return cfg, tok, eids, where


def test_moe_dropless_regime_matches_reference(moe_layer, monkeypatch):
    """32 tokens (<= dropless_below): C = T, every pick kept, each expert's
    slots its tokens in order."""
    cfg, tok, eids, where = _holds_moe(moe_layer, monkeypatch, 5, 32)
    E, C = tok.shape
    assert C == 32
    assert (where < E * C).all()
    counts = torch.bincount(eids.reshape(-1), minlength=E)
    assert torch.equal((tok < 32).sum(1), counts)


@pytest.mark.parametrize("factor,capacity", [(0.5, 10), (1.0, 20)])
def test_moe_capacity_regime_keeps_the_reference_c_minus_1_drop(moe_layer, monkeypatch,
                                                                factor, capacity):
    """80 tokens at dropless_below=0: C = int(80 * 2 / 8 * factor).  An
    expert with more than C picks keeps C-1 of them (the reference's slot
    table, ROADMAP Queue C), one with at most C keeps all: at factor 0.5
    every expert overflows and keeps 9; at 1.0 some overflow, one has
    exactly C and keeps C, others fewer."""
    cfg, tok, eids, where = _holds_moe(moe_layer, monkeypatch, 6, 80, dropless_below=0,
                                       capacity_factor=factor)
    E, C = tok.shape
    assert C == capacity
    counts = torch.bincount(eids.reshape(-1), minlength=E)
    kept = (tok < 80).sum(1)
    assert (counts > C).any()
    if factor == 1.0:
        assert (counts == C).any() and (counts < C).any()
    assert torch.equal(kept, torch.where(counts > C, C - 1, counts))
    assert int((where < E * C).sum()) == int(kept.sum())


GRAD_TOL = {"we1": 1 / 32}  # every other gradient: 1/64


@pytest.mark.parametrize("n_tok,kw", [(32, {}),
                                      (80, {"dropless_below": 0, "capacity_factor": 0.5}),
                                      (80, {"dropless_below": 0, "capacity_factor": 1.0})],
                         ids=["dropless", "capacity0.5", "capacity1.0"])
def test_moe_backward_matches_reference(moe_layer, n_tok, kw):
    """The gradients of the MoE layer (``jax.vjp`` of the reference's
    ``moe`` against torch autograd of the port's, one cotangent drawn with
    numpy) with respect to its input, the router, the experts and the
    shared expert, in the dropless regime and at capacity: each within
    ``GRAD_TOL`` of its largest magnitude.  The router's gradient runs
    through the sort, the gates' renormalisation and the gate gather of
    the combine: a zero, detached or sign-flipped one fails."""
    jcfg, cfg, p, jp = moe_layer
    x, jx = _x((1, n_tok, cfg.d_model), 6)
    dy, jdy = _x((1, n_tok, cfg.d_model), 9)
    jgp, jgx = jax.jit(lambda prm, xx, ct: jax.vjp(
        lambda a, b: jL.moe(a, b, jcfg, **kw), prm, xx)[1](ct))(jp, jx, jdy)
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), p)
    xx = x.clone().requires_grad_(True)
    L.moe(leaves, xx, cfg, **kw).backward(dy)
    _close(xx.grad, jgx, 1 / 64)
    for (path, t), want in zip(transformer.tree_paths(leaves), jax.tree_util.tree_leaves(jgp),
                               strict=True):
        _close(t.grad, want, GRAD_TOL.get(path, 1 / 64))
        if path == "router":
            for wrong in (torch.zeros_like(t.grad), -t.grad):
                with pytest.raises(AssertionError):
                    _close(wrong, want, 1 / 64)


def test_moe_router_ties_pick_the_lowest_experts(moe_layer, monkeypatch):
    """A router of zeros ties every expert: the picks are experts 0..k-1,
    as ``jax.lax.top_k``'s, with equal gates."""
    jcfg, cfg, p, jp = moe_layer
    p = dict(p, router=torch.zeros_like(p["router"]))
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    x, jx = _x((2, 8, cfg.d_model), 7)
    want, (jtok, _, _) = _reference_moe(jp, jx, jcfg, monkeypatch)
    with torch.no_grad():
        got, (tok, _, _), eids, _ = _port_moe(p, x, cfg)
    k = cfg.moe.top_k
    assert torch.equal(eids, torch.arange(k).expand(16, k))
    assert np.array_equal(tok.numpy(), jtok)
    assert (jtok[:k] == np.arange(16)).all() and (jtok[k:] == 16).all()
    _close(got, want, 1 / 64)


def test_moe_combine_adds_in_ascending_expert_order_as_the_reference():
    """The combine alone on f32 values of mixed magnitude, where the order
    of a sum shows in its bits: the port's against the reference's
    scatter-add into zeros in slot order (its own lines), exact; the same
    picks in the router's (gate) order give other bits."""
    rng = np.random.default_rng(8)
    T, E, k, C, D = 24, 8, 3, 24, 16
    eids = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    flat = eids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    start = np.searchsorted(flat[order], np.arange(E))
    rank = np.arange(T * k) - start[flat[order]]
    where = np.empty(T * k, np.int64)
    where[order] = flat[order] * C + rank
    vals = (rng.normal(0, 1, (E * C, D)) * 10.0 ** rng.integers(-6, 7, (E * C, D)))
    vals = vals.astype(np.float32)
    tok_of_slot = np.full(E * C, T)
    tok_of_slot[where] = np.arange(T * k) // k
    want = jax.jit(lambda v, t: jnp.zeros((T + 1, D), jnp.float32).at[t].add(v, mode="drop"))(
        jnp.asarray(vals), jnp.asarray(tok_of_slot))
    got = L.moe_combine(torch.from_numpy(vals), torch.from_numpy(where),
                        torch.from_numpy(eids))
    assert_bits_equal(got, np.asarray(want)[:T])
    by_gate = torch.zeros(T, D)
    picked = torch.from_numpy(vals)[torch.from_numpy(where).reshape(T, k)]
    for j in range(k):
        by_gate = by_gate + picked[:, j]
    assert not torch.equal(by_gate, got)


def test_moe_leaves_init_scales_and_axis_dims(moe_layer):
    """Leaf order by sorted keys, the experts' scale 1/sqrt(n_experts) (the
    reference's ``_dense_init`` takes shape[0]), the router's 0.02, and the
    dims the reference's 'model' axis takes."""
    jcfg, cfg, p, _ = moe_layer
    shapes = transformer._layer_shapes(cfg, cfg.pattern[0])
    paths = [k for k, _ in transformer.tree_paths(shapes["ffn"])]
    assert paths == ["router", "shared/w1", "shared/w2", "shared/w3", "we1", "we2", "we3"]
    assert shapes["ffn"]["we1"] == ((8, 64, 32), 1 / np.sqrt(8))
    assert shapes["ffn"]["we2"] == ((8, 32, 64), 1 / np.sqrt(8))
    assert shapes["ffn"]["router"] == ((64, 8), 0.02)
    want = jax.eval_shape(lambda: jL.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    assert [s.shape for s in jax.tree_util.tree_leaves(want)] == \
        [tuple(t.shape) for _, t in transformer.tree_paths(p)]
    dims = transformer.model_axis_dims(cfg)
    assert dims["blocks"][0]["ffn"]["we1"] == (1,) and dims["blocks"][0]["ffn"]["router"] == ()
    assert dims["blocks"][0]["mixer"]["w_dkv"] == () and dims["prefix_0"]["mixer"]["w_uk"] == (1,)
    assert dims["blocks"][0]["ffn"]["shared"]["w2"] == (1,)


def test_moe_init_draws_experts_at_one_over_sqrt_n_experts():
    cfg = dataclasses.replace(configs.get_smoke(ARCH), repeats=1)
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    we1 = model.params["blocks/0/ffn/we1"].detach().float()
    assert abs(float(we1.std()) - 1 / np.sqrt(8)) < 0.02
    assert abs(float(model.params["blocks/0/ffn/router"].detach().float().std()) - 0.02) < 0.003


def test_full_deepseek_counts_and_widths():
    """deepseek-v2-lite: 27 layers, 15.65 B parameters, 2.60 B active;
    deepseek-v3: 677.7 B; both equal to the reference's counts."""
    for arch, total, active in (("deepseek_v2_lite_16b", 15_647_881_216, 2_602_547_200),
                                ("deepseek_v3_671b", 677_740_835_840, None)):
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        assert cfg.param_count() == jcfg.param_count() == total
        assert cfg.active_param_count() == jcfg.active_param_count()
        if active is not None:
            assert cfg.active_param_count() == active
    v2 = configs.get("deepseek_v2_lite_16b")
    assert (v2.n_layers, v2.hd, v2.mla.kv_lora, v2.mla.rope_dim) == (27, 128, 512, 64)
    # 576 latent values a token and layer against 2 x 16 x 128 for GQA
    assert v2.mla.kv_lora + v2.mla.rope_dim == 576
    dense = configs.get("glm4_9b")
    assert dense.active_param_count() == dense.param_count()


def test_q_lora_is_counted_but_not_built_as_in_the_reference():
    """The reference's count of a q_lora path disagrees with its own init
    (always a full-rank wq, ROADMAP Queue C); the port keeps both."""
    jcfg, cfg = _cfgs()
    jq = dataclasses.replace(jcfg, mla=dataclasses.replace(jcfg.mla, q_lora=16))
    q = dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, q_lora=16))
    assert q.param_count() == jq.param_count() != cfg.param_count()
    n = sum(t.numel() for _, t in transformer.tree_paths(transformer.abstract_params(q)))
    assert n == cfg.param_count() != q.param_count()
