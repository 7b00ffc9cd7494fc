"""Serving the dense zoo's new layouts against the JAX reference: the
engine's cache with ``prefix_<i>`` entries, the splice of an admitted cache
into its slot (batch dim 0 for a prefix layer, 1 for a stacked pattern
position), the ``kv`` plan over leaves of two shapes, greedy serving
colocated and PD-disaggregated on gemma3 SMOKE (prompts longer than its
window of 8), recurrent state (jamba's Mamba h and conv, xlstm's mLSTM and
sLSTM) spliced and shipped, and the serve launcher for every arch.

Tolerances: exact everywhere (splices, plans, caches after a shipment, and
PD tokens against colocated ones, both the port's own; ``test_torch_models``
holds greedy decoding against the reference's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import sched as jsched
from repro.core.policy import CompressionPolicy as JPolicy
from repro.models import transformer as jtransformer
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer
from repro_torch.p2p.engine import Compressor
from repro_torch.sched import compile as sched_compile
from repro_torch.sched.cache import PlanCache
from repro_torch.serve import kv_transfer
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
from repro_torch.tree_util import bits_equal, tree_leaves, tree_map
from torch_port_util import assert_bits_equal, np_of

ARCH = "gemma3_27b"
N_PROMPTS, PROMPT, SLOTS, MAX_LEN, CHUNK, MAX_NEW = 3, 12, 2, 32, 12, 5


@pytest.fixture(scope="module")
def gemma():
    cfg = configs.get_smoke(ARCH)
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    return cfg, model


def _jtree(tree):
    return jax.tree_util.tree_map(
        jnp.asarray, tree_map(lambda t: np_of(t).view(jnp.bfloat16)
                              if t.dtype == torch.bfloat16 else t.numpy(), tree))


def _filled_cache(cfg, batch, seed):
    """A cache whose every K/V position and state value holds seeded random
    values."""
    cache = transformer.init_cache(cfg, batch, MAX_LEN, "cpu")
    g = torch.Generator().manual_seed(seed)
    for t in tree_leaves(cache):
        if t.dim():
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    return cache


def test_engine_cache_has_the_reference_prefix_entries(gemma):
    cfg, model = gemma
    eng = ServeEngine(cfg, model, ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN))
    want = jtransformer.init_cache(jconfigs.get_smoke(ARCH), SLOTS, MAX_LEN)
    assert sorted(eng.cache) == sorted(want) == ["blocks", "pos", "prefix_0"]
    got = [(p, tuple(t.shape)) for p, t in transformer.tree_paths(eng.cache)]
    assert got == [(jax.tree_util.keystr(k, simple=True, separator="/"), v.shape)
                   for k, v in jax.tree_util.tree_flatten_with_path(want)[0]]


@pytest.mark.parametrize("slots,slot", [(4, 0), (4, 1), (4, 3), (1, 0)])
def test_splice_into_a_prefix_cache_matches_reference(gemma, slots, slot):
    """The reference's batch-dim rule, bit for bit.  At one slot it finds
    no batch dim in a prefix layer's leaf (its batch and the admitted
    one's are both 1, and dim 1 is the cache length), so that leaf is not
    written: a fault of the reference that the port keeps (ROADMAP Queue
    C)."""
    cfg, _ = gemma
    batched, one = _filled_cache(cfg, slots, 1), _filled_cache(cfg, 1, 2)
    before = batched["prefix_0"]["kv"]["k"].clone()
    want = JServeEngine._splice_impl(_jtree(batched), _jtree(one), slot)
    got = ServeEngine._splice_impl(batched, one, slot)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
        assert_bits_equal(g, w)
    assert torch.equal(got["blocks"][1]["kv"]["v"][:, slot], one["blocks"][1]["kv"]["v"][:, 0])
    spliced = got["prefix_0"]["kv"]["k"][slot]
    assert torch.equal(spliced, one["prefix_0"]["kv"]["k"][0] if slots > 1 else before[0])


def test_kv_plan_of_two_leaf_shapes_matches_reference(gemma):
    """gemma3's cache: the prefix layer's (B, L, Hkv, hd) leaves and the
    pattern positions' stacked (R, B, L, Hkv, hd) ones, one bucket a
    dtype; the host wire ships every leaf bit for bit."""
    cfg, _ = gemma
    cache = _filled_cache(cfg, 1, 3)
    policy = CompressionPolicy(min_bytes=0)
    plan = sched_compile.compile_kv_plan(cache, "data", policy=policy, n_dev=1,
                                         device="cpu")
    jplan = jsched.compile_kv_plan(_jtree(cache), "data", policy=JPolicy(min_bytes=0),
                                   n_dev=1)
    shapes = {tuple(t.shape) for t in tree_leaves(cache) if t.dim()}
    assert len(shapes) == 2
    assert plan.n_leaves == jplan.n_leaves == len(tree_leaves(cache))
    for b, jb in zip(plan.buckets, jplan.buckets, strict=True):
        assert (b.members, b.length, b.width, b.path) == (jb.members, jb.length, jb.width,
                                                          jb.path)
    assert plan.raw_leaf_ix == jplan.raw_leaf_ix
    eng = Compressor(codec_name="packed", device="cpu")
    back = kv_transfer.unpack_cache(kv_transfer.pack_cache(cache, eng, plan=plan), eng)
    assert bits_equal(back, cache)


def _serve(cfg, model, prompts, **kw):
    pd = kw.pop("pd", False)
    eng = ServeEngine(cfg, model, ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN,
                                              prefill_chunk=CHUNK, pd_disaggregated=pd), **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=MAX_NEW))
    return sorted((r.rid, tuple(r.out)) for r in eng.run())


def test_pd_serving_past_the_window_equals_colocated(gemma):
    """Prompts of 12 tokens against a window of 8: the local layers' mask
    decides the tokens.  PD ships each admission's 6 leaves (2 shapes)
    under one kv plan: 1 miss, then hits."""
    cfg, model = gemma
    assert PROMPT > cfg.prefix[0].window
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, PROMPT).astype(np.int32) for _ in range(N_PROMPTS)]
    colocated = _serve(cfg, model, prompts)
    pc = PlanCache()
    pd = _serve(cfg, model, prompts, pd=True, kv_policy=CompressionPolicy(min_bytes=0),
                kv_plan_cache=pc)
    assert pd == colocated and all(len(o) == MAX_NEW for _, o in pd)
    assert (pc.stats.misses, pc.stats.hits) == (1, N_PROMPTS - 1)
    # the window matters: a global-attention twin decodes other tokens
    glob = dataclasses.replace(cfg, prefix=(dataclasses.replace(cfg.prefix[0], window=None),),
                               pattern=tuple(dataclasses.replace(s, window=None)
                                             for s in cfg.pattern))
    twin = transformer.Transformer(glob, dict(transformer.tree_paths(model.tree())))
    assert _serve(glob, twin, prompts) != colocated


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_serve_cli_serves_every_arch_on_the_cpu(arch, capsys):
    """Every decoder-only arch serves; whisper (encoder-decoder) is refused
    with the reference's SystemExit: its engine feeds no frames."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--pd", "--requests", "2",
            "--max-new", "3", "--slots", "2", "--max-len", "64", "--prompt-len", "16"]
    if configs.get(arch).enc_dec:
        with pytest.raises(SystemExit, match="enc-dec"):
            launch_serve.main(argv)
        return
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens" in out and "pd=True" in out


@pytest.mark.parametrize("arch,slots,slot", [("jamba_v0_1_52b", 4, 2), ("xlstm_350m", 3, 0),
                                             ("xlstm_350m", 1, 0)])
def test_splice_of_recurrent_states_matches_reference(arch, slots, slot):
    """Stacked (R, B, ...) state leaves, f32 and bf16, with R = 1 and 2:
    the reference's splice bit for bit, the admitted state in its slot."""
    cfg = dataclasses.replace(configs.get_smoke(arch), repeats=2 if slots == 4 else 1)
    batched, one = _filled_cache(cfg, slots, 4), _filled_cache(cfg, 1, 5)
    want = JServeEngine._splice_impl(_jtree(batched), _jtree(one), slot)
    got = ServeEngine._splice_impl(batched, one, slot)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
        assert_bits_equal(g, w)
    for path, t in transformer.tree_paths(got["blocks"]):
        assert torch.equal(t[:, slot], dict(transformer.tree_paths(one["blocks"]))[path][:, 0])


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "xlstm_350m"])
def test_pd_serving_ships_recurrent_state_bit_identical(arch):
    """A state cache (jamba: bf16 K/V, f32 h, bf16 conv; xlstm: f32 C, n,
    m, c, the smallest leaves 2 values a repeat) over the host wire under
    its kv plan, one bucket a dtype, every leaf bit-identical; PD tokens
    equal colocated ones."""
    cfg = configs.get_smoke(arch)
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    cache = _filled_cache(cfg, 1, 6)
    plan = sched_compile.compile_kv_plan(cache, "data", policy=CompressionPolicy(min_bytes=0),
                                         n_dev=1, device="cpu")
    jplan = jsched.compile_kv_plan(_jtree(cache), "data", policy=JPolicy(min_bytes=0), n_dev=1)
    for b, jb in zip(plan.buckets, jplan.buckets, strict=True):
        assert (b.members, b.length, b.width, b.path) == (jb.members, jb.length, jb.width,
                                                          jb.path)
    dtypes = {t.dtype for t in tree_leaves(cache) if t.dim()}
    assert torch.float32 in dtypes and len(plan.buckets) == len(dtypes)
    eng = Compressor(codec_name="packed", device="cpu")
    back = kv_transfer.unpack_cache(kv_transfer.pack_cache(cache, eng, plan=plan), eng)
    assert bits_equal(back, cache)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, PROMPT).astype(np.int32) for _ in range(N_PROMPTS)]
    colocated = _serve(cfg, model, prompts)
    pc = PlanCache()
    assert _serve(cfg, model, prompts, pd=True, kv_policy=CompressionPolicy(min_bytes=0),
                  kv_plan_cache=pc) == colocated
    assert (pc.stats.misses, pc.stats.hits) == (1, N_PROMPTS - 1)
