"""The remaining mixers (``layers.mamba``, ``layers.mlstm``,
``layers.slstm``, ``layers.attention(kv_src=)`` and the encoder)
held against the JAX reference's at SMOKE widths (jamba: d_model 64,
inner width 128, d_state 8, d_conv 4; xlstm: d_model 64, 2 heads of 32;
whisper: d_model 64, 4 heads of 16), on numpy-seeded inputs and weights
at the reference's init scales; the model's structure (leaf dtypes, the
'model' axis dims, the state caches), and jamba and xlstm at
``repeats=2``, where a wrong ``[r]`` slice of a stacked state shows.

Tolerances, with their reasons:
* Mamba's output and its state ``h``: within 1/64 of the largest
  magnitude (measured 0.0051 and 0.0050 at S 64, 0.0045 and 0.0079 at 512,
  0.0064 and 0.0044 at 520; decode steps from the returned state 0.0091
  and 0.0097).  In f32 both agree within 5e-7: the bf16 differences come
  from XLA:CPU's bf16 ``logistic`` (ROADMAP Queue C) inside ``silu`` of
  the conv, which parts the last bit of 40% of its outputs, and from the
  in-chunk scan's f32 products, taken in another order than XLA's
  associative scan (a doubling scan here);
* Mamba's ``conv`` state: the port's holds its own pre-activation inputs
  (``x @ in_proj``'s first half) bit for bit, after a prefill and after
  each decode step; against the reference's, each value within one bf16
  ulp (2**-7 of it): the two frameworks' bf16 products part in the last
  bit of about one value in 30 000 at these shapes;
* decode steps from a returned Mamba state against the full-sequence
  forward's last positions: within 2**-8 of the largest magnitude
  (measured 0, bit-equal);
* mLSTM and sLSTM outputs: within 2**-8 of the largest magnitude
  (measured 0, bit-equal), their f32 states within 1e-5 of each one's
  largest magnitude (measured up to 1.8e-7): the same steps in f32, the
  products' sums in another order;
* cross-attention and the encoder's bidirectional attention alone: within
  2**-8 of the largest magnitude (both take f32 scores and the same online
  softmax); the whole encoder within 1/32 (its SwiGLU's bf16 logistic, as
  the decoder layers' in ``test_torch_models``);
* the ``repeats=2`` variants: ``test_torch_models``' tolerances; jamba's
  prefill and decode there at float32, within 1e-4 of the largest
  magnitude (measured 2.5e-6 for the logits, 4.9e-7 for ``h``, 2.0e-7
  for ``conv``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import config as jconfig
from repro.models import layers as jL
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import transformer
from test_torch_models import _forward_matches, _ported, _serve_matches
from torch_port_util import assert_bits_equal, np_of

NEW = ("jamba_v0_1_52b", "xlstm_350m", "whisper_small")
B = 2


def _cfgs(arch):
    return jconfigs.get_smoke(arch), configs.get_smoke(arch)


def _draw(cfg, spec, seed, cross=False) -> tuple:
    """One layer's weights of ``spec`` drawn with numpy in path order at the
    reference's init (f32 leaves as they are, the rest rounded to bf16):
    (port tree, reference tree)."""
    rng = np.random.default_rng(seed)
    port, ref = {}, {}
    for path, (shape, init) in transformer.tree_paths(transformer._layer_shapes(cfg, spec,
                                                                               cross)):
        if init in (None, "ones"):
            a = np.ones(shape, np.float32)
        elif init == "zeros":
            a = np.zeros(shape, np.float32)
        elif init == "uniform":
            a = (rng.random(shape) * 2 + 0.5).astype(np.float32)
        else:
            a = (rng.normal(0, 1, shape) * init).astype(np.float32)
        t = torch.from_numpy(a)
        if init not in transformer.F32_INITS:
            t = t.to(torch.bfloat16)
        port[path] = t
        ref[path] = jnp.asarray(a) if t.dtype == torch.float32 else \
            jnp.asarray(np_of(t).view(jnp.bfloat16))

    def nest(flat):
        tree = {}
        for path, t in flat.items():
            *keys, last = path.split("/")
            node = tree
            for k in keys:
                node = node.setdefault(k, {})
            node[last] = t
        return tree

    return nest(port), nest(ref)


def _x(shape, seed):
    a = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16), jnp.asarray(a, jnp.bfloat16)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, frac):
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=np.abs(w).max() * frac)


def _within_ulp(got, want):
    g, w = _f32(got), _f32(want)
    assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w)).all()


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_layer():
    jcfg, cfg = _cfgs("jamba_v0_1_52b")
    p, jp = _draw(cfg, cfg.pattern[0], 0)
    fwd = jax.jit(lambda p, x: jL.mamba(p, x, jcfg, return_state=True))
    step = jax.jit(lambda p, x, s: jL.mamba(p, x, jcfg, state=s))
    return cfg, p["mixer"], jp["mixer"], fwd, step


def _inputs_of(cfg, p, x) -> torch.Tensor:
    """Mamba's pre-activation inputs: the first half of ``x @ in_proj``."""
    return (x @ p["in_proj"])[..., :cfg.mamba.expand * cfg.d_model]


@pytest.mark.parametrize("S", [64, 512, 520])
def test_mamba_forward_and_state_match_reference(mamba_layer, S):
    """One chunk (64), two of 256 (512), two of 260 (520): h carried
    across chunks."""
    cfg, p, jp, fwd, _ = mamba_layer
    assert max(1, S // 256) == (1 if S < 512 else 2)
    x, jx = _x((B, S, cfg.d_model), S)
    with torch.no_grad():
        out, st = L.mamba(p, x, cfg, return_state=True)
        plain, none = L.mamba(p, x, cfg)
    jout, jst = fwd(jp, jx)
    assert none is None and torch.equal(plain, out)
    assert st["h"].dtype == torch.float32 and st["conv"].dtype == torch.bfloat16
    _close(out, jout, 1 / 64)
    _close(st["h"], jst["h"], 1 / 64)
    assert_bits_equal(st["conv"], _inputs_of(cfg, p, x)[:, S - 3:])
    _within_ulp(st["conv"], jst["conv"])


def test_mamba_raises_where_the_reference_asserts(mamba_layer):
    """513 positions: max(1, 513 // 256) = 2 chunks do not split them."""
    cfg, p, jp, fwd, _ = mamba_layer
    x, jx = _x((1, 513, cfg.d_model), 0)
    with pytest.raises(ValueError, match="513"):
        L.mamba(p, x, cfg)
    with pytest.raises(AssertionError):
        fwd(jp, jx)


def test_mamba_decode_from_its_state_continues_the_sequence(mamba_layer):
    """A prefill of 64 positions returning its state, then 3 decode steps:
    each equals the 67-position forward's position, and the reference's
    decode from its own state; the conv history shifts by one input a
    step."""
    cfg, p, jp, fwd, step = mamba_layer
    S = 64
    x, jx = _x((B, S + 3, cfg.d_model), 7)
    with torch.no_grad():
        full, _ = L.mamba(p, x, cfg)
        _, st = L.mamba(p, x[:, :S], cfg, return_state=True)
        _, jst = fwd(jp, jx[:, :S])
        for t in range(S, S + 3):
            out, st = L.mamba(p, x[:, t:t + 1], cfg, state=st)
            jout, jst = step(jp, jx[:, t:t + 1], jst)
            _close(out, full[:, t:t + 1], 2.0 ** -8)
            _close(out, jout, 1 / 64)
            _close(st["h"], jst["h"], 1 / 64)
            assert_bits_equal(st["conv"], _inputs_of(cfg, p, x)[:, t - 2:t + 1])
            _within_ulp(st["conv"], jst["conv"])


# ---------------------------------------------------------------------------
# mLSTM, sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_xlstm_cells_and_decode_match_reference(mixer):
    """16 positions from no state, then 3 steps from the returned state."""
    jcfg, cfg = _cfgs("xlstm_350m")
    spec = next(s for s in cfg.pattern if s.mixer == mixer)
    p, jp = _draw(cfg, spec, 1)
    fn = getattr(L, mixer)
    jfn = jax.jit(lambda p, x, s: getattr(jL, mixer)(p, x, jcfg, state=s))
    x, jx = _x((B, 19, cfg.d_model), 3)
    with torch.no_grad():
        out, st = fn(p["mixer"], x[:, :16], cfg)
        jout, jst = jfn(jp["mixer"], jx[:, :16], None)
        for t in range(16, 20):
            _close(out, jout, 2.0 ** -8)
            assert sorted(st) == sorted(jst)
            for k in st:
                assert st[k].dtype == torch.float32
                _close(st[k], jst[k], 1e-5)
            if t == 19:
                break
            out, st = fn(p["mixer"], x[:, t:t + 1], cfg, state=st)
            jout, jst = jfn(jp["mixer"], jx[:, t:t + 1], jst)


def test_xlstm_state_starts_at_the_reference_stabiliser():
    """No state: m = -1e30, so the first step's forget gate is exp(-1e30
    ...) = 0 and the first output is the input gate's alone."""
    _, cfg = _cfgs("xlstm_350m")
    cache = transformer.init_cache(cfg, B, 8, "cpu")
    rnn = cache["blocks"][0]["rnn"]
    assert torch.equal(rnn["m"], torch.full_like(rnn["m"], -1e30))
    assert sorted(rnn) == ["C", "m", "n"] and sorted(cache["blocks"][1]["rnn"]) == ["c", "m",
                                                                                      "n"]


# ---------------------------------------------------------------------------
# cross-attention, the encoder
# ---------------------------------------------------------------------------

def test_cross_attention_matches_reference():
    """Queries of 16 decoder positions over K/V projected from 30 encoder
    positions (``kv_src``), no RoPE, no mask, the layer's window applied
    as the reference applies it.  The reference gets the port's own K/V
    projections as its ``kv_override``, so the two attend over the same
    bits."""
    jcfg, cfg = _cfgs("whisper_small")
    p, jp = _draw(cfg, cfg.pattern[0], 2, cross=True)
    x, jx = _x((B, 16, cfg.d_model), 4)
    src, _ = _x((B, cfg.enc_seq, cfg.d_model), 5)
    kv = tuple(jnp.asarray(np_of((src @ p["cross"][w]).reshape(
        B, cfg.enc_seq, cfg.kv_heads, cfg.hd)).view(jnp.bfloat16)) for w in ("wk", "wv"))
    for window in (None, 8):
        spec = dataclasses.replace(cfg.pattern[0], window=window)
        jspec = jconfig.LayerSpec(window=window)
        with torch.no_grad():
            got = L.attention(p["cross"], x, cfg, spec, None, None, kv_src=src)
        want, _ = jL.attention(jp["cross"], jx, jcfg, spec=jspec, positions=jnp.arange(16),
                               kv_override=kv)
        _close(got, want, 2.0 ** -8)


def test_encoder_matches_reference():
    """``run_encoder`` over ``frames`` against the reference's
    ``_run_encoder``; and its first layer's attention is bidirectional:
    the first position's output depends on the last frame."""
    jcfg, cfg = _cfgs("whisper_small")
    jparams, model = _ported(jcfg, cfg, seed=3)
    frames, jframes = _x((B, cfg.enc_seq, cfg.d_model), 8)
    with torch.no_grad():
        got = model.run_encoder(frames)
        moved = frames.clone()
        moved[:, -1] += 1
        other = model.run_encoder(moved)
    want = jax.jit(jtransformer._run_encoder, static_argnums=2)(jparams, jframes, jcfg)
    _close(got, want, 1 / 32)
    assert not torch.equal(got[:, 0], other[:, 0])
    with pytest.raises(ValueError, match="frames"):
        model.encode(None)


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def _dims_of(spec) -> tuple:
    return tuple(i for i, e in enumerate(tuple(spec)) if e == "model")


@pytest.mark.parametrize("arch", NEW)
def test_model_axis_dims_equal_the_reference_specs(arch):
    jcfg, cfg = _cfgs(arch)
    want = jax.tree.map(_dims_of, jtransformer.specs(jcfg), is_leaf=lambda s: isinstance(s, P))
    got = transformer.model_axis_dims(cfg)
    assert list(transformer.tree_paths(got)) == list(transformer.tree_paths(want))


@pytest.mark.parametrize("arch", NEW)
def test_leaf_dtypes_and_init_scales(arch):
    """Mamba's a_log, d_skip and dt_bias are f32, drawn uniform * 2 + 0.5,
    ones and zeros; every other leaf bf16; the xLSTM gates at 0.02."""
    _, cfg = _cfgs(arch)
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    f32 = {k for k, p in model.params.items() if p.dtype == torch.float32}
    assert f32 == {k for k in model.params if k.rsplit("/", 1)[-1] in
                   ("a_log", "d_skip", "dt_bias")}
    assert transformer.leaf_dtypes(cfg) == {k: p.dtype for k, p in model.params.items()}
    for k in f32:
        t = model.params[k].detach()
        if k.endswith("a_log"):
            assert 0.5 <= float(t.min()) and float(t.max()) < 2.5 and float(t.std()) > 0.5
        else:
            assert torch.equal(t, torch.full_like(t, 1.0 if k.endswith("d_skip") else 0.0))
    if arch == "xlstm_350m":
        assert 0.01 < float(model.params["blocks/0/mixer/wi"].float().std()) < 0.03
        assert "blocks/0/norm2" not in model.params
    if arch == "whisper_small":
        assert model.params["enc_blocks/mixer/wq"].shape[0] == cfg.n_enc_layers
        assert 0.01 < float(model.params["enc_pos"].float().std()) < 0.03


@pytest.mark.parametrize("arch", NEW)
def test_init_cache_matches_the_reference(arch):
    jcfg, cfg = _cfgs(arch)
    want = jtransformer.init_cache(jcfg, 3, 8)
    got = transformer.init_cache(cfg, 3, 8, "cpu")
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = list(transformer.tree_paths(got))
    assert [p for p, _ in gl] == [jax.tree_util.keystr(k, simple=True, separator="/")
                                  for k, _ in jl]
    for (_, g), (_, w) in zip(gl, jl):
        assert_bits_equal(g, w)
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name


# ---------------------------------------------------------------------------
# stacked states: repeats = 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "xlstm_350m"])
def test_repeats_two_matches_reference(arch):
    """Each pattern position's state stacked over 2 repeats: prefill and
    decode write and read repeat r's slice.  Against the reference
    (``test_torch_models``' checks); jamba's prefill and decode at float32
    as well as its forward in bf16: in bf16 the MoE picks of both rows part
    in the prefill (a near tie of the router meeting XLA:CPU's bf16
    ``logistic``), which would leave no row's logits held, while at
    float32 no pick parts and both rows are held through every decode
    step.  And the port's prefill of 16 positions and 3 decode steps
    against its own forward over the 19: the logits within 1/64 of the
    largest."""
    jcfg, cfg = (dataclasses.replace(c, repeats=2) for c in _cfgs(arch))
    jparams, model = _ported(jcfg, cfg, seed=4)
    _forward_matches(jcfg, jparams, cfg, model)
    if arch == "jamba_v0_1_52b":
        jcfg32, cfg32 = (dataclasses.replace(c, dtype="float32") for c in (jcfg, cfg))
        jparams32, model32 = _ported(jcfg32, cfg32, seed=4)
        assert _serve_matches(jcfg32, jparams32, cfg32, model32).all()
    else:
        _serve_matches(jcfg, jparams, cfg, model)
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab, (B, 19)))
    cache = transformer.init_cache(cfg, B, 32, "cpu")
    logits, cache = transformer.prefill(model, toks[:, :16], cache)
    for leaf in transformer.tree_paths(cache["blocks"]):
        t = leaf[1]
        assert not torch.equal(t[0], t[1]), leaf[0]  # each repeat its own state
    got = [logits]
    for t in range(16, 19):
        logits, cache = transformer.decode_step(model, toks[:, t:t + 1], cache)
        got.append(logits)
    with torch.no_grad():
        want = transformer.logits_from_hidden(model, model(toks))[:, 15:]
    _close(torch.cat(got, 1), want, 1 / 64)
