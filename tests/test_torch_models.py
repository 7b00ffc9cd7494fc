"""The port's model zoo (``configs``, ``models/config.py``,
``models/registry.py``, prefix layers, sliding windows, tied embeddings,
the vision stub, MoE and MLA, Mamba, mLSTM and sLSTM, the encoder-decoder)
held against the JAX reference, every arch at its SMOKE size with the
reference's weights carried across by ``load_reference_params``.

Tolerances, with their reasons:
* configs, parameter counts, leaf order and dtypes, batches (frames
  included), caches' structure and dtypes, and the first layer's K (MLA:
  its latents c_kv and k_rope) after a prefill: exact; a first layer's
  recurrent state within the logits' tolerance, Mamba's conv history
  within one bf16 ulp (``test_torch_mixers``);
* ``forward``'s hidden states and ``prefill``/``decode_step`` logits: within
  1/32 of the largest magnitude.  XLA:CPU rounds a bf16 ``logistic``
  inside (ROADMAP Queue C), so the SwiGLU output, and every later layer,
  differs in the last bf16 bits; ``test_torch_serve`` measured 1/64 on
  smollm.  Measured here, the largest difference over the largest
  magnitude (forward; prefill and decode), against the limit 0.0313:
  smollm 0.0082; 0.0138, tinyllama 0.0084; 0.0083, mistral-nemo 0.0101;
  0.0146, glm4 0.0115; 0.0137, gemma3 0.0082; 0.0151, qwen2-vl 0.0112;
  0.0086, the head_dim override 0.0103; 0.0100, 11 prefix layers 0.0200;
  0.0126 (the error grows with depth: 11 layers of the logistic's bits),
  deepseek-v2-lite 0.0265; 0.0240, deepseek-v3 0.0251; 0.0268 (the
  routers' picks part where the differences meet a near tie:
  ``test_torch_moe_mla`` holds the layers alone far closer), xlstm 0.0053;
  0.0044, whisper 0.0100; 0.0161;
* with Mamba layers (jamba) within 1/16: XLA:CPU's bf16 ``logistic``
  inside Mamba's ``silu(conv)`` parts the last bit of 40% of its outputs
  and the scan carries it (``test_torch_mixers``: a layer alone within
  1/64; in f32 both agree within 1e-5), and jamba's MoE experts (drawn
  at 1/sqrt(n_experts), the reference's scale) amplify what reaches
  them: measured 0.0210; 0.0453.  Where a router pick parts between the
  two packages (a near tie of the top k; recorded for each MoE layer,
  the reference's slot table through ``_expert_sharding_hint``), the
  positions from it on in its row hold other values in the two: the
  forward is held before the first parted position of each row (parted
  picks at most 5% of the positions), prefill and decode on the rows
  with no parted pick, of which there must be at least one (jamba SMOKE
  holds one of its two rows; at ``repeats=2`` both rows part in the
  prefill, so ``test_torch_mixers`` takes that variant's prefill and
  decode at float32, where no pick parts);
* a float32 model: within 1e-4 of the largest magnitude (the same f32
  operations, sums in another order);
* greedy tokens: each decode step is fed the reference's token, and the
  port's greedy pick must be the reference's wherever the reference's top
  two logits are further apart than twice the largest logit difference of
  the step (there the pick is decided); elsewhere it must be within that
  difference of the reference's top logit (a near tie: tinyllama's third
  step, top two 0.0034 of the largest logit apart).
* attention with a sliding window, alone: within one bf16 ulp of the
  output's magnitude (2**-8 of the largest |value|): both take f32 scores
  and softmax but sum in other orders before the cast back to bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import config as jconfig
from repro.models import layers as jL
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.models import config as config_lib
from repro_torch.models import layers as L
from repro_torch.models import registry, transformer
from repro_torch.tree_util import tree_flatten, tree_map
from torch_port_util import assert_bits_equal, ref_array

ARCHS = configs.ARCHS
PROMPT, MAX_LEN, N_DECODE = 16, 32, 4
# the reference's functions jitted: one compile a config, where eager
# dispatch compiles each layer's scan and attention at every call
_jforward = jax.jit(lambda p, b, cfg: jtransformer.forward(p, b, cfg, remat=False),
                    static_argnums=2)
_jprefill = jax.jit(jtransformer.prefill, static_argnums=2)
_jdecode = jax.jit(jtransformer.decode_step, static_argnums=3)
_jencode = jax.jit(lambda p, f, cfg: jtransformer._run_encoder(p, f, cfg), static_argnums=2)


def _ported(jcfg, cfg, seed=0):
    """Random weights at the reference's init scales (drawn by the port, as
    drawing them with the reference takes seconds an arch on the CPU) as
    the reference's numpy tree, run by the reference and carried into the
    port by ``load_reference_params``."""
    init = transformer.init(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    tree = tree_map(ref_array, init.tree())
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            transformer.load_reference_params(tree, cfg, "cpu"))


def _reference_paths(jcfg) -> list:
    """(path, shape, dtype name) of each leaf of the reference's own
    ``init``, in ``tree_leaves`` order (traced, not run)."""
    shapes = jax.eval_shape(lambda: jtransformer.init(jax.random.PRNGKey(0), jcfg))
    return [(jax.tree_util.keystr(k, simple=True, separator="/"), s.shape, s.dtype.name)
            for k, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def _paths(model) -> list:
    return [(k, tuple(p.shape), str(p.dtype).removeprefix("torch."))
            for k, p in model.params.items()]


@pytest.fixture(scope="module")
def zoo():
    """Per arch: (reference config, reference weights, port config, port
    model holding them), built once."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
        jparams, model = _ported(jcfg, cfg)
        out[arch] = (jcfg, jparams, cfg, model)
    return out


def _variants():
    """The replaced configs no SMOKE config exercises: head_dim apart from
    d_model / n_heads (as the full mistral-nemo and gemma3 have), and 11
    prefix layers (``prefix_10`` sorts before ``prefix_2``)."""
    g = jconfigs.get_smoke("glm4_9b")
    m = jconfigs.get_smoke("gemma3_27b")
    spec = m.prefix[0]
    jvars = {"head_dim": dataclasses.replace(g, head_dim=24),
             "prefix11": dataclasses.replace(m, prefix=(spec,) * 11)}
    pg, pm = configs.get_smoke("glm4_9b"), configs.get_smoke("gemma3_27b")
    pspec = config_lib.LayerSpec(**dataclasses.asdict(spec))
    ports = {"head_dim": dataclasses.replace(pg, head_dim=24),
             "prefix11": dataclasses.replace(pm, prefix=(pspec,) * 11)}
    return jvars, ports


@pytest.fixture(scope="module")
def variants():
    jvars, ports = _variants()
    out = {}
    for k in jvars:
        jparams, model = _ported(jvars[k], ports[k])
        out[k] = (jvars[k], jparams, ports[k], model)
    return out


def _reference_defaults():
    return {f.name: f.default for f in dataclasses.fields(jconfig.ArchConfig)
            if f.default is not dataclasses.MISSING}


def _same_config(port, ref):
    names = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name in ("pattern", "prefix"):
            assert len(got) == len(want), f.name
            for a, b in zip(got, want):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        elif dataclasses.is_dataclass(got):  # MoECfg, MLACfg: one class a package
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    # the reference's fields the port does not have hold their defaults
    for name, default in _reference_defaults().items():
        if name not in names:
            assert getattr(ref, name) == default, name
    assert port.n_layers == ref.n_layers and port.hd == ref.hd


# ---------------------------------------------------------------------------
# configs, registry
# ---------------------------------------------------------------------------

def test_archs_are_the_ported_ones_in_the_reference_order():
    assert ARCHS == jconfigs.ARCHS
    assert ARCHS == ["tinyllama_1_1b", "mistral_nemo_12b", "gemma3_27b", "smollm_135m",
                     "xlstm_350m", "qwen2_vl_72b", "deepseek_v2_lite_16b", "deepseek_v3_671b",
                     "jamba_v0_1_52b", "whisper_small", "glm4_9b"]
    assert configs.list_archs() == ARCHS
    assert configs.get("glm4-9b") is configs.get("glm4_9b")
    assert configs.get("jamba-v0-1-52b") is configs.get("jamba_v0_1_52b")
    with pytest.raises(ValueError, match="unknown architecture"):
        configs.get("llama_7b")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("get", ["get", "get_smoke"])
def test_config_equals_reference_field_for_field(arch, get):
    port, ref = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
    _same_config(port, ref)
    assert port.param_count() == ref.param_count()
    assert registry.get_config(arch, smoke=get == "get_smoke") is port


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_count_is_the_element_count(arch):
    cfg = configs.get(arch)
    n = sum(t.numel() for _, t in transformer.tree_paths(transformer.abstract_params(cfg)))
    assert cfg.param_count() == n == jconfigs.get(arch).param_count()


def test_full_zoo_widths():
    """The shapes the card runs: glm4-9b 9.40 B, gemma3-27b 27.0 B with 2
    prefix layers and ten 5:1 local:global patterns, tied."""
    g, m = configs.get("glm4_9b"), configs.get("gemma3_27b")
    assert (g.n_layers, g.d_model, g.kv_heads, g.hd, g.vocab) == (40, 4096, 2, 128, 151552)
    assert round(g.param_count() / 1e9, 2) == 9.40
    assert (m.n_layers, m.hd, m.kv_heads, len(m.prefix), m.repeats) == (62, 128, 16, 2, 10)
    assert [s.window for s in m.pattern] == [1024] * 5 + [None]
    assert m.tie_embeddings and round(m.param_count() / 1e9, 1) == 27.0
    assert configs.get("mistral_nemo_12b").hd == 128 != 5120 // 32


def test_unknown_layer_kinds_raise_value_error_as_the_reference():
    """An unknown mixer or FFN raises ValueError, in the counts as in the
    reference's, and in the parameter tree."""
    for field, kind in (("mixer", "rwkv"), ("ffn", "geglu")):
        spec = config_lib.LayerSpec(**{field: kind})
        cfg = dataclasses.replace(configs.get_smoke("glm4_9b"), pattern=(spec,))
        jcfg = dataclasses.replace(jconfigs.get_smoke("glm4_9b"),
                                   pattern=(jconfig.LayerSpec(**{field: kind}),))
        for c in (cfg, jcfg):
            with pytest.raises(ValueError, match=kind):
                c.param_count()
        with pytest.raises(ValueError, match=kind):
            transformer.abstract_params(cfg)
        with pytest.raises(ValueError, match=kind):
            transformer.init(cfg, generator=torch.Generator(), device="cpu")
    # the kinds the reference has are all built
    for spec in (config_lib.LayerSpec(mixer=m, ffn=f) for m in ("attn", "mla", "mamba",
                                                                 "mlstm", "slstm")
                 for f in ("swiglu", "moe", "none")):
        cfg = dataclasses.replace(configs.get_smoke("jamba_v0_1_52b"), pattern=(spec,))
        n = sum(t.numel() for _, t in transformer.tree_paths(transformer.abstract_params(cfg)))
        assert n == cfg.param_count(), spec


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_and_specs_match_reference(arch):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    want = jregistry.make_batch(jcfg, 3, 20, rng=np.random.default_rng(5))
    got = registry.make_batch(cfg, 3, 20, rng=np.random.default_rng(5), device="cpu")
    assert sorted(got) == sorted(want)
    assert ("vision_embeds" in got) == (cfg.frontend == "vision_stub")
    assert ("frames" in got) == cfg.enc_dec
    for k, w in want.items():
        if k in ("vision_embeds", "frames"):
            assert_bits_equal(got[k], np.asarray(w), k)
        else:
            assert got[k].dtype == torch.int64
            assert np.array_equal(got[k].numpy(), np.asarray(w)), k
    jspecs = jregistry.batch_specs(jcfg, 3, 20)
    for k, s in registry.batch_specs(cfg, 3, 20).items():
        assert s.device.type == "meta" and tuple(s.shape) == jspecs[k].shape, k
    assert registry.model is transformer


# ---------------------------------------------------------------------------
# parameters: counts, leaf order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_leaves_match_reference(zoo, arch):
    jcfg, jparams, cfg, model = zoo[arch]
    assert _paths(model) == _reference_paths(jcfg)
    assert cfg.param_count() == sum(p.numel() for p in model.leaves()) == \
        jcfg.param_count()
    jleaves = jax.tree_util.tree_leaves(jparams)
    assert len(model.leaves()) == len(jleaves)
    for got, want in zip(model.leaves(), jleaves):
        assert_bits_equal(got, want)
    assert model.head() is model.params["embed" if cfg.tie_embeddings else "lm_head"]


def test_eleven_prefix_layers_keep_the_reference_leaf_order(variants):
    jcfg, jparams, cfg, model = variants["prefix11"]
    assert _paths(model) == _reference_paths(jcfg)
    want = [p for p, _, _ in _reference_paths(jcfg)]
    prefixes = [p.split("/")[0] for p in want if p.startswith("prefix_")]
    assert list(dict.fromkeys(prefixes))[:4] == ["prefix_0", "prefix_1", "prefix_10",
                                                 "prefix_2"]
    for got, w in zip(model.leaves(), jax.tree_util.tree_leaves(jparams)):
        assert_bits_equal(got, w)
    assert cfg.param_count() == jcfg.param_count() == sum(p.numel() for p in model.leaves())
    paths = lambda t: [p for p, _ in transformer.tree_paths(t)]  # noqa: E731
    assert paths(transformer.model_axis_dims(cfg)) == \
        paths(transformer.abstract_params(cfg)) == want


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

class _Picks:
    """Records the MoE picks (token, expert) of each MoE layer call, the
    reference's (its ``_expert_sharding_hint`` sees each layer's slot table
    first, through a debug callback) beside the port's
    (``layers.moe_dispatch``), over the calls made inside ``with``.
    :meth:`parted` gives the first position, per batch row, at which a
    call's picks part between the two (``n`` where none part), and adds to
    ``kept`` (the reference's picks) and ``n_parted`` (picks kept by one
    package and not the other).

    A parted pick is a near tie of the router's top-k meeting the bf16
    differences XLA:CPU's ``logistic`` leaves in the hidden states; the
    position it parts at and every later one of its row (causal attention,
    Mamba's recurrence) then hold other values in the two packages."""

    def __init__(self, on: bool = True):
        self.on, self.seen, self.mine, self.kept, self.n_parted = on, [], [], 0, 0

    def __enter__(self):
        self._patch = pytest.MonkeyPatch()
        if not self.on:
            return self
        n_hints = [0]

        def hint(x, n_experts):  # the slot table's tokens, then xg and h
            if n_hints[0] % 3 == 0:
                jax.debug.callback(lambda v: self.seen.append(np.asarray(v)), x,
                                   ordered=True)
            n_hints[0] += 1
            return x

        dispatch = L.moe_dispatch

        def mine(*args):
            d = dispatch(*args)
            self.mine.append(d.tok.numpy())
            return d

        self._patch.setattr(jL, "_expert_sharding_hint", hint)
        self._patch.setattr(L, "moe_dispatch", mine)
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        self._patch.undo()

    def parted(self, batch: int, seq: int) -> np.ndarray:
        """Per row of a (batch, seq) call, the first parted position; the
        recorded calls are then cleared.  Off, no pick parts."""
        assert len(self.seen) == len(self.mine)
        assert self.on or not self.seen
        n = batch * seq
        first = np.full(batch, seq)

        def picks(tok):
            return {(int(t), e) for e, row in enumerate(tok) for t in row if t < n}

        for a, w in zip(self.mine, self.seen):
            self.kept += len(picks(w))
            self.n_parted += len(picks(a) ^ picks(w))
            for t, _ in picks(a) ^ picks(w):
                first[t // seq] = min(first[t // seq], t % seq)
        self.seen.clear()
        self.mine.clear()
        return first


def _tol(cfg) -> float:
    """The hidden states' and logits' tolerance, a fraction of the largest
    magnitude: 1/32, or 1/16 with Mamba layers (see the module docstring);
    1e-4 for a float32 model (the same f32 operations, sums in another
    order)."""
    if cfg.dtype == "float32":
        return 1e-4
    return 1 / 16 if any(s.mixer == "mamba" for s in (*cfg.prefix, *cfg.pattern)) else 1 / 32


def _parting(cfg) -> bool:
    """Whether the tests follow parted MoE picks (:class:`_Picks`): with
    Mamba and MoE layers, whose parted picks move the logits past the
    tolerance (elsewhere the picks that part move them less)."""
    return _tol(cfg) > 1 / 32 and any(s.ffn == "moe" for s in (*cfg.prefix, *cfg.pattern))


def _forward_matches(jcfg, jparams, cfg, model, seed=1):
    """The training forward's hidden states within :func:`_tol` of the
    largest, at every position before a parted MoE pick where
    :func:`_parting` (picks part at at most 5% of the positions)."""
    jb = jregistry.make_batch(jcfg, 2, PROMPT, rng=np.random.default_rng(seed))
    b = registry.make_batch(cfg, 2, PROMPT, rng=np.random.default_rng(seed), device="cpu")
    with _Picks(_parting(cfg)) as rec:
        want = np.asarray(_jforward(jparams, jb, jcfg).astype(jnp.float32))
        with torch.no_grad():
            got = model(b["tokens"], vision_embeds=b.get("vision_embeds"),
                        frames=b.get("frames")).float().numpy()
    first = rec.parted(2, PROMPT)
    assert got.shape == want.shape == (2, PROMPT, cfg.d_model)
    assert (PROMPT - first).sum() <= 0.05 * rec.kept, first
    for row in range(2):
        np.testing.assert_allclose(got[row, :first[row]], want[row, :first[row]], rtol=0,
                                   atol=np.abs(want).max() * _tol(cfg))
    return b


def _serve_matches(jcfg, jparams, cfg, model, seed=2):
    """Prefill (vision embeddings included for the stub, frames for an
    encoder-decoder model, whose decode steps take the encoder's output)
    and greedy decode steps against the reference's: the caches' structure
    and dtypes, the first layer's K bits (or its recurrent state), the
    logits (within :func:`_tol`), and the greedy tokens, of each row until
    an MoE pick of it parts between the two where :func:`_parting`.  At
    least one row must be held past the prefill (measured: both rows
    through every step for each arch but jamba SMOKE, which holds one of
    its two).  Returns the rows held through the last step."""
    jb = jregistry.make_batch(jcfg, 2, PROMPT, rng=np.random.default_rng(seed))
    b = registry.make_batch(cfg, 2, PROMPT, rng=np.random.default_rng(seed), device="cpu")
    jcache = jtransformer.init_cache(jcfg, 2, MAX_LEN)
    cache = transformer.init_cache(cfg, 2, MAX_LEN, "cpu")
    with _Picks(_parting(cfg)) as rec:
        jl, jc = _jprefill(jparams, {k: v for k, v in jb.items() if k != "labels"}, jcfg,
                           jcache)
        logits, cache = transformer.prefill(model, b["tokens"], cache,
                                            vision_embeds=b.get("vision_embeds"),
                                            frames=b.get("frames"))
    held = rec.parted(2, PROMPT) == PROMPT  # the rows whose logits are held
    assert held.any(), "every row's MoE picks part in the prefill: nothing is held"
    jenc = enc = None
    if cfg.enc_dec:
        jenc = _jencode(jparams, jb["frames"], jcfg)
        with torch.no_grad():
            enc = model.encode(b["frames"])
    jleaves, jdef = jax.tree_util.tree_flatten_with_path(jc)
    leaves = tree_flatten(cache)[0]
    assert [jax.tree_util.keystr(k, simple=True, separator="/") for k, _ in jleaves] == \
        [p for p, _ in transformer.tree_paths(cache)]
    for got, (_, want) in zip(leaves, jleaves):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    # the first layer's K (MLA: its latents c_kv and k_rope) exactly; a
    # recurrent state within the logits' tolerance, Mamba's conv history
    # (the in_proj product's bf16 bits) within one bf16 ulp (in a float32
    # model, within the logits' tolerance)
    first = "prefix_0" if cfg.prefix else "blocks"
    c0 = cache[first] if cfg.prefix else cache["blocks"][0]
    jc0 = jc[first] if cfg.prefix else jc["blocks"][0]
    (kind,) = c0
    for name in c0[kind]:
        got, want = c0[kind][name], jc0[kind][name]
        if not cfg.prefix:
            got, want = got[0], want[0]
        if kind == "kv" and name in ("c_kv", "k_rope", "k"):
            assert_bits_equal(got, want, f"first layer's {name}")
        elif kind != "kv":
            g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
            ulp = name == "conv" and cfg.dtype != "float32"
            bound = 2.0 ** -7 * np.abs(w) if ulp else np.abs(w).max() * _tol(cfg)
            assert (np.abs(g - w) <= bound).all(), (name, np.abs(g - w).max())
    assert int(cache["pos"]) == int(jc["pos"]) == PROMPT
    decided = 0
    for step in range(N_DECODE):
        want = np.asarray(jl.astype(jnp.float32))[held]
        got = logits.float().numpy()[held]
        if held.any():
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=np.abs(want).max() * _tol(cfg),
                                       err_msg=f"step {step}")
            err = np.abs(got - want).max()
            top2 = np.sort(want[:, -1], -1)[:, -2:]
            pick = got[:, -1].argmax(-1)
        for row in range(want.shape[0]):
            if top2[row, 1] - top2[row, 0] > 2 * err:
                assert pick[row] == want[row, -1].argmax(), (step, row)
                decided += 1
            else:
                assert want[row, -1, pick[row]] >= top2[row, 1] - err, (step, row)
        jtok = jnp.argmax(jl[:, -1], -1)
        with rec:
            jl, jc = _jdecode(jparams, jtok[:, None].astype(jnp.int32), jc, jcfg,
                              enc_out=jenc)
            logits, cache = transformer.decode_step(
                model, torch.from_numpy(np.asarray(jtok, np.int64))[:, None], cache,
                enc_out=enc)
        held &= rec.parted(2, 1) == 1
        assert int(cache["pos"]) == int(jc["pos"])
    assert decided >= N_DECODE * held.sum() // 2  # most picks are decided, not ties
    return held


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_states_match_reference(zoo, arch):
    jcfg, jparams, cfg, model = zoo[arch]
    b = _forward_matches(jcfg, jparams, cfg, model)
    if cfg.frontend == "vision_stub":  # the patches replace the leading positions
        with torch.no_grad():
            plain = model(b["tokens"])
            mixed = model(b["tokens"], vision_embeds=b["vision_embeds"])
        assert not torch.equal(plain[:, 0], mixed[:, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(zoo, arch):
    _serve_matches(*zoo[arch])


@pytest.mark.parametrize("case", ["head_dim", "prefix11"])
def test_replaced_configs_match_reference(variants, case):
    jcfg, jparams, cfg, model = variants[case]
    if case == "head_dim":
        assert cfg.hd == 24 != cfg.d_model // cfg.n_heads
        assert tuple(model.params["blocks/0/mixer/wq"].shape) == (cfg.repeats, 64, 96)
    _forward_matches(jcfg, jparams, cfg, model)
    _serve_matches(jcfg, jparams, cfg, model)


# ---------------------------------------------------------------------------
# sliding-window attention
# ---------------------------------------------------------------------------

def _qkv(seed, B=2, S=32, H=4, Hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (B, S, h, hd)).astype(np.float32) for h in (H, Hkv, Hkv)]


def _close_bf16(got, want):
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=np.abs(want).max() * 2.0 ** -8)


@pytest.mark.parametrize("window", [5, 8, 12])
def test_sliding_window_across_chunk_boundaries_matches_reference(window):
    """Prefill's chunked attention at q and kv chunks of 8 over 32
    positions: a window of 5, 8 or 12 reaches back across chunk edges; and
    the training form (one softmax)."""
    arrs = _qkv(window)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    want = jL._attend_chunked(jq, jk, jv, causal=True, window=window, q_chunk=8, kv_chunk=8)
    got = L._attend_chunked(tq, tk, tv, causal=True, window=window, q_chunk=8, kv_chunk=8)
    _close_bf16(got, want)
    _close_bf16(L._attend(tq, tk, tv, window), want)
    full = L._attend_chunked(tq, tk, tv, causal=True, window=None, q_chunk=8, kv_chunk=8)
    assert torch.equal(got[:, :window], full[:, :window])  # inside the window
    assert not torch.equal(got[:, window:], full[:, window:])


@pytest.mark.parametrize("cache_pos", [3, 9, 30])
def test_decode_attention_with_a_window_matches_reference(cache_pos):
    arrs = _qkv(cache_pos, S=32)
    q = arrs[0][:, :1]
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs[1:])
    jq = jnp.asarray(q, jnp.bfloat16)
    jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs[1:])
    want = jL._decode_attend(jq, jk, jv, cache_pos, 8, None)
    _close_bf16(L._decode_attend(tq, tk, tv, cache_pos, 8), want)
