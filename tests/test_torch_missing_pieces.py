"""The pieces of ported modules that came last, held against the JAX
reference on numpy-seeded inputs:

* the module-level wire-report ledger (``policy.wire_reports`` /
  ``clear_wire_reports``): order, clear, captures still diverting, reports
  of another thread and of ``report_into``, the cap; the same sequence on
  both packages gives the same ledger;
* ``codec.pack_fp8_exp_pairs`` / ``unpack_fp8_exp_pairs`` bit for bit at odd
  and even n, and ``codec.plane_fractions`` for every layout: exact;
* ``calibrate.calibrate_tree``: the same profile;
* the ``file`` backend of ``data.DataPipeline``: the same tokens at steps
  0-3 for 1 and 2 processes, the same errors, and the launcher reading it;
* sampling at temperature > 0: the greedy limit bit for bit, seeded
  determinism, a chi-square test against ``softmax(logits / T)`` (JAX's
  random stream cannot be matched), PD = colocated at temperature > 0;
* ``WeightSyncEngine(strategy=)``: the plan key and strategy as the
  reference's, the host wire's bytes the same under every strategy.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as jsched
from repro.core import calibrate as jcalibrate
from repro.core import codec as jcodec
from repro.core import policy as jpolicy
from repro.core.policy import CompressionPolicy as JPolicy
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro.sync import WeightSyncEngine as JWeightSyncEngine
from repro_torch import configs
from repro_torch.core import calibrate, codec, policy
from repro_torch.core import compressed_collectives as cc
from repro_torch.core.integrity import tree_chunks
from repro_torch.core.policy import CompressionPolicy
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.sched.cache import PlanCache
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine, sample
from repro_torch.sync import WeightSyncEngine
from torch_port_util import FORMATS, grad_like_bits, np_of, random_bits, to_jax, to_torch

ARCH = "smollm_135m"


# ---------------------------------------------------------------------------
# the module-level wire-report ledger
# ---------------------------------------------------------------------------

@pytest.fixture
def ledgers():
    policy.clear_wire_reports()
    jpolicy.clear_wire_reports()
    yield
    policy.clear_wire_reports()
    jpolicy.clear_wire_reports()


def _reports(mod, n):
    return [mod.WireReport(name=f"w{i}", axis="data", raw_bytes=100 + i, wire_bytes=50 + i)
            for i in range(n)]


def _as_rows(reports):
    return [(r.name, r.axis, r.raw_bytes, r.wire_bytes) for r in reports]


def test_the_ledger_keeps_uncaptured_reports_in_order_as_the_reference(ledgers):
    for mod in (policy, jpolicy):
        a, b, c, d = _reports(mod, 4)
        mod.record_wire_report(a)
        with mod.capture_wire_reports() as outer:
            mod.record_wire_report(b)
            with mod.capture_wire_reports() as inner:
                mod.record_wire_report(c)
        mod.record_wire_report(d)
        assert (outer, inner) == ([b], [c])
    assert _as_rows(policy.wire_reports()) == _as_rows(jpolicy.wire_reports()) == [
        ("w0", "data", 100, 50), ("w3", "data", 103, 53)]
    assert isinstance(policy.wire_reports(), tuple)
    policy.clear_wire_reports()
    jpolicy.clear_wire_reports()
    assert policy.wire_reports() == () and jpolicy.wire_reports() == ()


def test_a_capture_diverts_only_its_own_thread(ledgers):
    """A capture opened in one thread leaves another thread's reports to the
    shared ledger, as in the reference; ``report_into`` sends a thread's
    reports to the caller's capture, or to the ledger when it has none."""
    for mod in (policy, jpolicy):
        (rep,) = _reports(mod, 1)
        with mod.capture_wire_reports() as mine:
            t = threading.Thread(target=mod.record_wire_report, args=(rep,))
            t.start()
            t.join(10)
        assert mine == [] and _as_rows(mod.wire_reports()) == _as_rows([rep])
    policy.clear_wire_reports()
    (rep,) = _reports(policy, 1)
    for captured in (True, False):
        with policy.capture_wire_reports() if captured else _nothing() as mine:
            stack = policy.current_sinks()

            def backward():
                with policy.report_into(stack):
                    policy.record_wire_report(rep)

            t = threading.Thread(target=backward)
            t.start()
            t.join(10)
        if captured:
            assert mine == [rep] and policy.wire_reports() == ()
        else:
            assert policy.wire_reports() == (rep,)


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_the_ledger_keeps_the_newest_reports_up_to_its_cap(ledgers):
    cap = policy.WIRE_LEDGER_CAP
    reps = _reports(policy, cap + 3)
    for r in reps:
        policy.record_wire_report(r)
    got = policy.wire_reports()
    assert len(got) == cap and got[0] is reps[3] and got[-1] is reps[-1]


def test_a_collective_outside_any_capture_reports_into_the_ledger(ledgers):
    x = to_torch(grad_like_bits("bfloat16", 512 * 8, seed=3), "bfloat16")
    with launch_train.single_process_group("cpu") as g:
        with policy.capture_wire_reports() as captured:
            cc.all_gather_compressed(x, g, width=5)
        assert policy.wire_reports() == ()
        cc.all_gather_compressed(x, g, width=5)
    assert policy.wire_reports() == tuple(captured) and len(captured) == 1


# ---------------------------------------------------------------------------
# fp8 exponent pairs, plane fractions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("n", [1, 2, 7, 512, 1025])
def test_fp8_exponent_pairs_match_reference_bit_for_bit(fmt, n):
    bits = random_bits(fmt, n, seed=n)
    exp, _ = codec.split_planes(to_torch(bits, fmt))
    jexp, _ = jcodec.split_planes(to_jax(bits, fmt))
    eb = codec.LAYOUTS[fmt].exp_bits
    got = codec.pack_fp8_exp_pairs(exp, eb)
    want = np.asarray(jcodec.pack_fp8_exp_pairs(jexp, eb))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    assert np.array_equal(np_of(got), want)
    assert got.shape[0] == (-(-n // 2) if eb <= 4 else 2 * -(-n // 2))
    back = codec.unpack_fp8_exp_pairs(got, eb, n)
    assert back.dtype == torch.uint8 and torch.equal(back, exp)
    # cross-decode both ways
    assert np.array_equal(np_of(codec.unpack_fp8_exp_pairs(torch.from_numpy(want.copy()), eb, n)),
                          np.asarray(jexp))
    assert np.array_equal(np.asarray(jcodec.unpack_fp8_exp_pairs(jnp.asarray(np_of(got)),
                                                                 eb, n)), np_of(exp))


@pytest.mark.parametrize("eb", [3, 4, 5, 8])
def test_fp8_exponent_pairs_of_every_field_value(eb):
    """Every exponent value of the field width, odd count, both lane widths."""
    vals = np.arange(1 << eb, dtype=np.uint8)
    exp = np.concatenate([vals, vals[::-1], vals[:1]])
    got = codec.pack_fp8_exp_pairs(torch.from_numpy(exp), eb)
    want = np.asarray(jcodec.pack_fp8_exp_pairs(jnp.asarray(exp), eb))
    assert np.array_equal(np_of(got), want)
    assert np.array_equal(np_of(codec.unpack_fp8_exp_pairs(got, eb, exp.shape[0])), exp)


@pytest.mark.parametrize("fmt", FORMATS)
def test_plane_fractions_match_reference(fmt):
    want = jcodec.plane_fractions(jnp.dtype(fmt))
    assert codec.plane_fractions(getattr(torch, fmt)) == want
    assert codec.plane_fractions(fmt) == want
    assert sum(want) == 1.0
    with pytest.raises(ValueError):
        codec.plane_fractions(torch.int32)


# ---------------------------------------------------------------------------
# calibrate_tree
# ---------------------------------------------------------------------------

def _calib_tree(seed=0):
    rng = np.random.default_rng(seed)
    wide = rng.normal(0, 1, 4096).astype(np.float32)
    wide[::7] *= 1e6  # wide exponent ranges: a larger width
    return {"g": ("bfloat16", grad_like_bits("bfloat16", 512 * 12, seed, specials=False)),
            "h": ("float32", wide.view(np.uint32)),
            "k": ("float16", grad_like_bits("float16", 700, seed + 1, specials=False)),
            "step": ("int32", np.arange(5, dtype=np.int32))}


def _trees(p):
    t = {k: to_torch(a, f) if f != "int32" else torch.from_numpy(a.copy())
         for k, (f, a) in p.items()}
    j = {k: to_jax(a, f) if f != "int32" else jnp.asarray(a) for k, (f, a) in p.items()}
    return t, j


@pytest.mark.parametrize("kw", [{}, {"tensor_class": "weight", "margin_bits": 1},
                                {"block": 256, "target_exc_rate": 0.05}])
def test_calibrate_tree_matches_reference(kw):
    t, j = _trees(_calib_tree())
    got, want = calibrate.calibrate_tree(t, **kw), jcalibrate.calibrate_tree(j, **kw)
    assert (got.widths, got.block, got.exc_frac, got.ag_extra_bits) == (
        want.widths, want.block, want.exc_frac, want.ag_extra_bits)
    for leaf in ("g", "k"):  # each leaf alone, and a tree without a codec float
        got = calibrate.calibrate_tree({"x": t[leaf]}, **kw)
        assert got.widths == jcalibrate.calibrate_tree({"x": j[leaf]}, **kw).widths
    assert calibrate.calibrate_tree({"s": t["step"]}).widths == jcalibrate.calibrate_tree(
        {"s": j["step"]}).widths == {"gradient": 8}


# ---------------------------------------------------------------------------
# the file backend of the data pipeline
# ---------------------------------------------------------------------------

def _token_file(tmp_path, n, vocab, seed=0, name="tokens.bin"):
    dtype = np.uint32 if vocab > 65535 else np.uint16
    toks = np.random.default_rng(seed).integers(0, vocab, n).astype(dtype)
    path = tmp_path / name
    toks.tofile(path)
    return str(path), toks


@pytest.mark.parametrize("vocab", [49152, 70000])
@pytest.mark.parametrize("count", [1, 2])
def test_file_pipeline_gives_the_reference_tokens(tmp_path, vocab, count):
    path, toks = _token_file(tmp_path, 5000, vocab)
    kw = dict(vocab=vocab, global_batch=4, seq_len=32, seed=7, kind="file", path=path)
    for idx in range(count):
        pipe = DataPipeline(DataConfig(**kw), process_index=idx, process_count=count)
        jpipe = JDataPipeline(JDataConfig(**kw), process_index=idx, process_count=count)
        assert pipe._mmap.dtype == jpipe._mmap.dtype
        for step in range(4):
            got, want = pipe.batch_at(step), jpipe.batch_at(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype == np.int32
                assert np.array_equal(got[k], want[k]), (idx, step, k)
            assert np.array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])
            # every row is a window of the file
            row = got["tokens"][0]
            starts = np.flatnonzero(toks[:-32] == row[0])
            assert any(np.array_equal(toks[s:s + 32], row) for s in starts)
            t = pipe.tensors_at(step, "cpu")
            assert t["tokens"].dtype == torch.int64
            assert np.array_equal(t["labels"].numpy(), got["labels"])
    # iteration, state_dict, skip_to and load_state_dict as the reference's
    pipe, jpipe = DataPipeline(DataConfig(**kw)), JDataPipeline(JDataConfig(**kw))
    pipe.skip_to(2)
    jpipe.skip_to(2)
    it, jit = iter(pipe), iter(jpipe)
    for _ in range(2):
        assert np.array_equal(next(it)["tokens"], next(jit)["tokens"])
    assert pipe.state_dict() == jpipe.state_dict() == {"step": 4}
    pipe.load_state_dict({"step": 1})
    assert np.array_equal(next(iter(pipe))["tokens"], jpipe.batch_at(1)["tokens"])


def test_file_pipeline_errors_are_the_references(tmp_path):
    kw = dict(vocab=49152, global_batch=2, seq_len=16, kind="file")
    for path in (None, str(tmp_path / "missing.bin")):
        with pytest.raises(FileNotFoundError):
            DataPipeline(DataConfig(**kw, path=path))
        with pytest.raises(FileNotFoundError):
            JDataPipeline(JDataConfig(**kw, path=path))
    short, _ = _token_file(tmp_path, 16, 49152, name="short.bin")
    for cls, cfg in ((DataPipeline, DataConfig), (JDataPipeline, JDataConfig)):
        with pytest.raises(ValueError, match="shorter than one sequence"):
            cls(cfg(**kw, path=short))
    with pytest.raises(ValueError, match="unknown data backend"):
        DataPipeline(DataConfig(vocab=8, global_batch=1, seq_len=4, kind="hdf5"))


def test_a_file_of_exactly_one_sequence_raises_in_both_packages(tmp_path):
    """Queue C: a file of ``seq_len + 1`` tokens passes the length check, then
    every draw of a start is ``integers(0, 0)``, which numpy refuses."""
    path, _ = _token_file(tmp_path, 17, 49152)
    kw = dict(vocab=49152, global_batch=2, seq_len=16, kind="file", path=path)
    pipe, jpipe = DataPipeline(DataConfig(**kw)), JDataPipeline(JDataConfig(**kw))
    for p in (pipe, jpipe):
        with pytest.raises(ValueError, match="high <= 0"):
            p.batch_at(0)


def test_the_launcher_trains_twins_from_a_token_file(tmp_path):
    cfg = configs.get_smoke(ARCH)
    path, _ = _token_file(tmp_path, 4000, cfg.vocab)
    runs = {}
    with launch_train.single_process_group("cpu") as g:
        for compress in (True, False):
            runs[compress] = launch_train.train(
                ARCH, smoke=True, steps=2, batch=2, seq=16, compress=compress,
                device="cpu", group=g, data_path=path)
    comp, raw = runs[True], runs[False]
    assert comp.runner.pipeline.cfg.kind == "file"
    want = JDataPipeline(JDataConfig(vocab=cfg.vocab, global_batch=2, seq_len=16, seed=0,
                                     kind="file", path=path)).batch_at(1)
    assert np.array_equal(comp.runner.pipeline.batch_at(1)["tokens"], want["tokens"])
    assert comp.losses == raw.losses and len(comp.losses) == 2
    for a, b in zip(comp.state.model.leaves(), raw.state.model.leaves()):
        assert torch.equal(a.detach(), b.detach())


# ---------------------------------------------------------------------------
# sampling at temperature > 0
# ---------------------------------------------------------------------------

def test_greedy_limit_is_argmax_bit_for_bit():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 1, (6, 40)).astype(np.float32)
    logits[2, [3, 9]] = logits[2].max() + 1  # a tie: the first index wins
    for dt in (torch.float32, torch.bfloat16):
        lg = torch.from_numpy(logits).to(dt)
        got = sample(lg, 0.0)
        want = np.asarray(jnp.argmax(jnp.asarray(lg.float().numpy()), axis=-1))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        assert torch.equal(sample(lg, 0.0, torch.Generator().manual_seed(3)), got)


def test_sampling_is_seeded_deterministic_and_int32():
    logits = torch.from_numpy(np.random.default_rng(1).normal(0, 2, (5, 3, 64))
                              .astype(np.float32))
    draw = lambda seed: sample(logits, 0.8, torch.Generator().manual_seed(seed))  # noqa: E731
    a, b, c = draw(0), draw(0), draw(1)
    assert a.shape == (5, 3) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 64
    g = torch.Generator().manual_seed(0)  # one generator: each call draws anew
    assert not torch.equal(sample(logits, 0.8, g), sample(logits, 0.8, g))


# chi-square critical value at 7 degrees of freedom, p = 0.001
CHI2_7DF_P001 = 24.322


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.5])
def test_sampling_follows_softmax_of_logits_over_temperature(temperature):
    """20 000 draws over a vocabulary of 8 against ``softmax(logits / T)``:
    the chi-square statistic stays under its 0.001 critical value (seeded, so
    the outcome is fixed), and the draws of the reference's own categorical
    pass the same test, so both sample the same distribution."""
    logits = np.array([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25], np.float32)
    n = 20_000
    p = np.exp(logits / temperature)
    p /= p.sum()
    lg = torch.from_numpy(np.tile(logits, (n, 1)))
    got = sample(lg, temperature, torch.Generator().manual_seed(11)).numpy()
    jgot = np.asarray(jax.random.categorical(jax.random.PRNGKey(11),
                                             jnp.asarray(lg.numpy()) / temperature,
                                             axis=-1))
    for draws in (got, jgot):
        counts = np.bincount(draws, minlength=8)
        chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
        assert chi2 < CHI2_7DF_P001, (temperature, chi2, counts, n * p)


def test_sampling_at_temperature_serves_pd_as_colocated_and_by_seed():
    cfg = configs.get_smoke(ARCH)
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, 16).astype(np.int32) for _ in range(3)]

    def serve(pd, reseed=None, temperature=0.9):
        scfg = ServeConfig(batch_slots=2, max_len=64, prefill_chunk=16,
                           temperature=temperature, pd_disaggregated=pd)
        eng = ServeEngine(cfg, model, scfg, kv_plan_cache=PlanCache())
        assert eng.generator.device == torch.device("cpu")
        assert eng.generator.initial_seed() == 0  # the reference's PRNGKey(0)
        if reseed is not None:
            eng.generator.manual_seed(reseed)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=8))
        return sorted((r.rid, tuple(r.out)) for r in eng.run())

    col = serve(False)
    assert serve(True) == col and serve(False) == col
    assert serve(False, reseed=1) != col
    assert serve(False, temperature=0.0) != col
    assert all(len(o) == 8 and all(0 <= t < cfg.vocab for t in o) for _, o in col)


# ---------------------------------------------------------------------------
# WeightSyncEngine(strategy=)
# ---------------------------------------------------------------------------

def _sync_tree(seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, 0.02, (64, 40)).astype(np.float32)).to(torch.bfloat16)
    n = torch.from_numpy(rng.normal(0, 1.0, 300).astype(np.float32))
    return {"w": w, "norm": n}


@pytest.mark.parametrize("strategy", ["split_send", "encode_send", "chunked"])
def test_engine_strategy_enters_the_wsync_plan_as_the_reference(strategy):
    t = _sync_tree()
    j = jax.tree_util.tree_map(lambda a: to_jax(np_of(a), str(a.dtype).removeprefix("torch.")),
                               t)
    eng = WeightSyncEngine(policy=CompressionPolicy(min_bytes=0), strategy=strategy,
                           plan_cache=PlanCache())
    jeng = JWeightSyncEngine(policy=JPolicy(min_bytes=0), strategy=strategy,
                             plan_cache=jsched.PlanCache())
    plan, jplan = eng.plan_for(t), jeng.plan_for(j)
    assert eng.strategy == jeng.strategy == plan.strategy == jplan.strategy == strategy
    assert (plan.key[0], plan.key[2], plan.key[-1]) == (jplan.key[0], jplan.key[2],
                                                        jplan.key[-1]) == ("wsync", strategy,
                                                                           None)
    assert eng.plan_for(t) is plan and eng.plan_cache.stats.misses == 1


def test_the_host_wire_is_the_same_under_every_strategy():
    """Full and delta updates carry the same bytes and checksum whatever the
    engine's strategy (the strategy schedules the in-mesh wire only)."""
    t0, t1 = _sync_tree(0), _sync_tree(0)
    t1["w"] = (t1["w"].view(torch.int16) ^ 1).view(torch.bfloat16)
    seen = {}
    for strategy in ("split_send", "encode_send", "chunked"):
        eng = WeightSyncEngine(policy=CompressionPolicy(min_bytes=0), strategy=strategy,
                               plan_cache=PlanCache())
        v = eng.publish(t0)
        full = eng.update_for("r")
        eng.ack("r", v)
        eng.publish(t1)
        delta = eng.update_for("r")
        assert (full.mode, delta.mode) == ("full", "delta")
        seen[strategy] = [(u.checksum, u.wire_bytes,
                           [(b[:3], list(tree_chunks(b[3]))) for b in u.buckets])
                          for u in (full, delta)]
    assert seen["split_send"] == seen["encode_send"] == seen["chunked"]


def test_an_unknown_engine_strategy_raises():
    with pytest.raises(ValueError, match="strategy"):
        WeightSyncEngine(strategy="ring")
