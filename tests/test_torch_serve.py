"""The port's serving slice (smollm SMOKE, colocated and PD-disaggregated
over the compressed host KV wire) held against the JAX reference.

Tolerances, with their reasons:
* ``init_cache`` leaves, the KV plan, greedy tokens, and every cache leaf
  after a shipment: exact;
* ``prefill`` / ``decode_step`` logits: within 1/64 of the largest logit
  magnitude (measured: 0.0039 of 0.47 after prefill, 0.0059 after a decode
  step).  The attention is the reference's arithmetic and the first
  layer's K/V caches are bit-identical, but XLA:CPU evaluates a bf16
  ``logistic`` as bf16-rounded exp, add and divide (ROADMAP Queue C), so the
  SwiGLU output, and with it every later layer, differs in the last bf16
  bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import sched as jsched
from repro.core.policy import CompressionPolicy as JPolicy
from repro.models import transformer as jtransformer
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs, kernels
from repro_torch.core import integrity
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer
from repro_torch.p2p.engine import Compressor
from repro_torch.sched.cache import PlanCache
from repro_torch.serve import kv_transfer
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine, sample
from repro_torch.tree_util import tree_leaves
from torch_port_util import assert_bits_equal, np_of

ARCH = "smollm_135m"
# the PD parity test of the reference (tests/test_serve.py): 5 prompts of
# 16 tokens, 2 slots, max_len 64, prefill_chunk 16, 6 new tokens each
N_PROMPTS, PROMPT, SLOTS, MAX_LEN, CHUNK, MAX_NEW = 5, 16, 2, 64, 16, 6


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.get_smoke(ARCH)
    jparams = jtransformer.init(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_smoke(ARCH)
    model = transformer.load_reference_params(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return cfg, model, jcfg, jparams


def _prompts(vocab: int, seed: int = 4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, PROMPT).astype(np.int32) for _ in range(N_PROMPTS)]


def _serve(engine_cls, request_cls, cfg, params, scfg, prompts, **kw):
    eng = engine_cls(cfg, params, scfg, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_new=MAX_NEW))
    return eng, sorted((r.rid, tuple(r.out)) for r in eng.run())


def test_init_cache_leaves_match_reference(models):
    cfg, _, jcfg, _ = models
    got = tree_leaves(transformer.init_cache(cfg, 3, 40, "cpu"))
    want = jax.tree_util.tree_leaves(jtransformer.init_cache(jcfg, 3, 40))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name
        assert_bits_equal(g, w, "init_cache")


def test_prefill_and_decode_logits_match_reference(models):
    cfg, model, jcfg, jparams = models
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jl, jc = jtransformer.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                                  jtransformer.init_cache(jcfg, 2, 40))
    logits, cache = transformer.prefill(model, torch.from_numpy(toks),
                                        transformer.init_cache(cfg, 2, 40, "cpu"))
    # the first layer's K/V are the reference's bits
    assert_bits_equal(cache["blocks"][0]["kv"]["k"][0], jc["blocks"][0]["kv"]["k"][0], "k0")
    assert_bits_equal(cache["blocks"][0]["kv"]["v"][0], jc["blocks"][0]["kv"]["v"][0], "v0")
    assert int(cache["pos"]) == int(jc["pos"]) == 24
    for step in range(3):
        want = np.asarray(jl.astype(jnp.float32))
        got = logits.float().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=np.abs(want).max() / 64, err_msg=f"step {step}")
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jtransformer.decode_step(jparams, jnp.asarray(nxt), jc, jcfg)
        logits, cache = transformer.decode_step(model, torch.from_numpy(nxt), cache)
        assert int(cache["pos"]) == int(jc["pos"])


def test_greedy_tokens_match_reference_and_pd_matches_colocated(models):
    """The reference engine's tokens, colocated and PD-disaggregated, and the
    PD plan cache compiles once: 1 miss, then a hit per later admission."""
    cfg, model, jcfg, jparams = models
    prompts = _prompts(cfg.vocab)
    scfg = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK)
    _, want = _serve(JServeEngine, JRequest, jcfg, jparams,
                     JServeConfig(batch_slots=SLOTS, max_len=MAX_LEN,
                                  prefill_chunk=CHUNK), prompts)
    _, colocated = _serve(ServeEngine, Request, cfg, model, scfg, prompts)
    pc = PlanCache()
    eng, pd = _serve(ServeEngine, Request, cfg, model,
                     ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN,
                                 prefill_chunk=CHUNK, pd_disaggregated=True),
                     prompts, kv_policy=CompressionPolicy(min_bytes=0),
                     kv_plan_cache=pc)
    assert colocated == want
    assert pd == colocated
    assert all(len(out) == MAX_NEW for _, out in pd)
    assert (pc.stats.misses, pc.stats.hits) == (1, N_PROMPTS - 1)
    (plan,) = pc._plans.values()
    assert plan.kind == "kv" and plan.width_for_dtype("bfloat16") == 5


def test_kv_plan_of_a_prefilled_cache_matches_reference(models):
    cfg, model, jcfg, jparams = models
    toks = np.arange(CHUNK, dtype=np.int32)[None]
    _, cache = transformer.prefill(model, torch.from_numpy(toks),
                                   transformer.init_cache(cfg, 1, MAX_LEN, "cpu"))
    _, jc = jtransformer.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                                 jtransformer.init_cache(jcfg, 1, MAX_LEN))
    from repro_torch.sched.compile import cached_kv_plan

    plan = cached_kv_plan(cache, "data", policy=CompressionPolicy(min_bytes=0), n_dev=1,
                          plan_cache=PlanCache())
    jp = jsched.cached_kv_plan(jc, "data", policy=JPolicy(min_bytes=0), n_dev=1,
                               plan_cache=jsched.PlanCache())
    assert [(b.members, b.width, b.wire_bytes, b.raw_bytes) for b in plan.buckets] == [
        (b.members, b.width, b.wire_bytes, b.raw_bytes) for b in jp.buckets]
    assert plan.raw_leaf_ix == jp.raw_leaf_ix == (2,)


@pytest.mark.parametrize("codec_name", ["packed", "rans"])
def test_shipped_cache_is_bit_identical_and_decodes_the_same_tokens(models, codec_name):
    """A prefilled cache through ``pack_cache``/``unpack_cache``: every leaf
    bit-identical, and greedy decoding from it gives the same tokens."""
    cfg, model, _, _ = models
    toks = torch.from_numpy(_prompts(cfg.vocab, seed=9)[0][None].astype(np.int64))
    logits, cache = transformer.prefill(model, toks,
                                        transformer.init_cache(cfg, 1, MAX_LEN, "cpu"))
    eng = Compressor(codec_name=codec_name, device="cpu")
    wire = kv_transfer.pack_cache(cache, eng)
    assert kv_transfer.verify_wire(wire)
    back = kv_transfer.unpack_cache(wire, eng)
    for a, b in zip(tree_leaves(cache), tree_leaves(back)):
        assert a.dtype == b.dtype
        assert_bits_equal(b, np_of(a), codec_name)

    def greedy(c):
        out, cur = [], torch.argmax(logits[:, -1], -1)[:, None]
        for _ in range(8):
            lg, c = transformer.decode_step(model, cur, c)
            cur = torch.argmax(lg[:, -1], -1)[:, None]
            out.append(int(cur))
        return out

    assert greedy(back) == greedy(cache)


def test_corrupted_kv_wire_is_retried_then_recovers(models):
    """``kv_fault_injector`` flips a bit of the first two shipments: the
    checksum rejects them, the engine re-packs, the third gets through and
    the tokens are those of colocated serving.  A wire corrupted every time
    exhausts the retry budget and raises."""
    cfg, model, _, _ = models
    prompts = _prompts(cfg.vocab)[:2]
    base = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK)
    _, want = _serve(ServeEngine, Request, cfg, model, base, prompts)
    pd = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
                     pd_disaggregated=True)
    seen = []

    def corrupt_first_two(wire):
        seen.append(1)
        if len(seen) <= 2:
            msg = wire["messages"][0]
            msg.lo_payload = integrity.flip_bit(msg.lo_payload, 12345)
        return wire

    eng = ServeEngine(cfg, model, pd, kv_plan_cache=PlanCache())
    eng.kv_fault_injector = corrupt_first_two
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=MAX_NEW))
    got = sorted((r.rid, tuple(r.out)) for r in eng.run())
    assert got == want and len(seen) == len(prompts) + 2

    def corrupt_always(wire):
        wire["messages"][1].exp_payload["bases"] = integrity.flip_bit(
            wire["messages"][1].exp_payload["bases"], 3)
        return wire

    eng = ServeEngine(cfg, model, pd, kv_plan_cache=PlanCache())
    eng.kv_fault_injector = corrupt_always
    eng.submit(Request(rid=0, prompt=prompts[0], max_new=2))
    with pytest.raises(integrity.WireIntegrityError, match="3 times"):
        eng.run()


def test_serve_cli_on_the_cpu_launches_no_kernel(capsys):
    kernels.clear_launch_counts()
    launch_serve.main(["--arch", ARCH, "--smoke", "--requests", "3", "--max-new", "4",
                       "--slots", "2", "--max-len", "64", "--prompt-len", "16",
                       "--pd", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "pd=True" in out
    assert not any(kernels.launch_counts().values())


def test_serving_refuses_a_missing_gpu_and_sampling_at_temperature(models, monkeypatch):
    cfg, model, _, _ = models
    # sampling at temperature > 0 needs the engine's generator: a bare call
    # without one is refused
    logits = torch.zeros((1, cfg.vocab))
    with pytest.raises(ValueError, match="temperature > 0 needs a torch.Generator"):
        sample(logits, 0.7)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--requests", "1"])
