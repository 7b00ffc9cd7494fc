"""The port's bit-plane pack/unpack, rANS kernels' plain versions, rANS
codec (``core/ans.py``) and width calibration held against the JAX package,
bit for bit, on numpy-seeded inputs.

* plain ``pack``/``unpack``/``rans_encode``/``rans_decode`` against the
  reference's ``kernels/ref.py`` and its Pallas kernels in interpret mode
  (``ops.*(use_pallas=True, interpret=True)``: n a multiple of 8192 for
  bitpack, 128 lanes and a few rows for rANS);
* ``build_freq_table`` (ties, one symbol, counts above 0.5 M),
  ``_slot_to_symbol``, ``encode`` words and lens, ``decode`` (ragged n),
  and each package decoding the other's stream;
* ``block_range_stats`` and ``choose_width``.

The CUDA kernels themselves run only on the card (``test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ans as jans
from repro.core import calibrate as jcalibrate
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.core import ans, calibrate, packing
from repro_torch.kernels import bitpack, rans, ref
from torch_port_util import (FORMATS, assert_bits_equal, grad_like_bits,
                             to_jax, to_torch)

LANES = 128


def _symbols(kind: str, n: int, seed: int) -> np.ndarray:
    """uint8 symbol streams: exponent-like (skewed), uniform, one symbol."""
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        return np.clip(rng.normal(120, 2.5, n), 0, 255).astype(np.uint8)
    if kind == "uniform":
        return rng.integers(0, 256, n).astype(np.uint8)
    return np.full(n, 7, np.uint8)


# ---------------------------------------------------------------------------
# bitpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 3, 5, 8, 13, 24, 31, 32])
def test_plain_pack_unpack_match_reference_and_pallas(width):
    rng = np.random.default_rng(width)
    vals = rng.integers(0, 1 << width, 8192 * 2, dtype=np.uint64).astype(np.uint32)
    got = packing.bitplane_pack(torch.from_numpy(vals.view(np.int32)), width)
    assert got.dtype == torch.int32 and got.shape == (512, width)
    assert_bits_equal(got, jref.pack(jnp.asarray(vals), width), "ref pack")
    assert_bits_equal(got, jops.pack(jnp.asarray(vals), width, use_pallas=True,
                                     interpret=True), "pallas pack")
    back = packing.bitplane_unpack(got, width)
    assert back.dtype == torch.int32
    assert_bits_equal(back, vals, "unpack")
    assert_bits_equal(back, jops.unpack(jops.pack(jnp.asarray(vals), width),
                                        width, use_pallas=True, interpret=True),
                      "pallas unpack")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64])
def test_plain_pack_reads_the_low_word_of_every_input_dtype(dtype):
    """uint8, int32 (sign bit set) and int64 values pack as their low 32 bits,
    as the reference's cast to uint32; ragged group counts and all-zero and
    all-ones groups included."""
    rng = np.random.default_rng(3)
    hi = {torch.uint8: 1 << 8, torch.int32: 1 << 32, torch.int64: 1 << 40}[dtype]
    vals = rng.integers(0, hi, 32 * 37, dtype=np.uint64)
    vals[:32], vals[32:64] = 0, hi - 1
    t = torch.from_numpy(vals.astype({torch.uint8: np.uint8, torch.int32: np.uint32,
                                      torch.int64: np.uint64}[
        dtype]).view({torch.uint8: np.uint8, torch.int32: np.int32,
                      torch.int64: np.int64}[dtype]))
    low = (vals & 0xFFFFFFFF).astype(np.uint32)
    for width in (1, 8, 32):
        assert_bits_equal(bitpack.pack(t, width), jref.pack(jnp.asarray(low), width),
                          f"{dtype} w={width}")


def test_bitplane_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="n % 32"):
        bitpack.pack(torch.zeros(33, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="width"):
        bitpack.pack(torch.zeros(32, dtype=torch.int32), 33)
    with pytest.raises(ValueError, match="words"):
        bitpack.unpack(torch.zeros((2, 3), dtype=torch.int32), 4)
    assert bitpack.pack(torch.zeros(0, dtype=torch.int32), 4).shape == (0, 4)
    assert bitpack.unpack(torch.zeros((0, 4), dtype=torch.int32), 4).shape == (0,)


# ---------------------------------------------------------------------------
# rANS: the dense-emission kernels' plain versions
# ---------------------------------------------------------------------------

def _tables(syms: np.ndarray):
    jt = jans.build_freq_table(jnp.asarray(syms))
    t = ans.build_freq_table(torch.from_numpy(syms.astype(np.int64)))
    return jt, t


@pytest.mark.parametrize("kind", ["skewed", "uniform", "single"])
def test_plain_rans_matches_reference_and_pallas(kind):
    per = 5
    syms = _symbols(kind, per * LANES, seed=11).reshape(per, LANES)
    jt, t = _tables(syms)
    ts = torch.from_numpy(syms.astype(np.int32))
    words, mask, state = rans.encode(ts, t.freq, t.cum)
    assert words.dtype == mask.dtype == state.dtype == torch.int32
    for name, j in (("ref", jref.rans_encode(jnp.asarray(syms, jnp.uint32), jt.freq,
                                             jt.cum[:256])),
                    ("pallas", jops.rans_encode(jnp.asarray(syms, jnp.uint32), jt,
                                                use_pallas=True, interpret=True))):
        for k, g, w in zip(("words", "mask", "state"), (words, mask, state), j):
            assert_bits_equal(g, w, f"{kind} {name} {k}")
    jw, _, jst = jops.rans_encode(jnp.asarray(syms, jnp.uint32), jt, use_pallas=True,
                                  interpret=True)
    got = rans.decode(words, state, t.freq, t.cum, ans._slot_to_symbol(t))
    assert got.dtype == torch.uint8
    assert_bits_equal(got, syms, f"{kind} roundtrip")
    assert_bits_equal(got, jops.rans_decode(jw, jst, jt, use_pallas=True,
                                            interpret=True), f"{kind} pallas decode")
    assert_bits_equal(got, jref.rans_decode(jw, jst, jt.freq, jt.cum[:256],
                                            jans._slot_to_symbol(jt).astype(jnp.uint32)),
                      f"{kind} ref decode")


def test_plain_rans_with_padding_is_the_compacted_codec():
    """``n_valid < per * lanes``: the padding neither emits nor moves the
    state, so the dense buffer compacts to the reference's stream and the
    stream decode gives the symbols back."""
    n = 3 * LANES + 45
    syms = _symbols("skewed", n, seed=12)
    jt, t = _tables(syms)
    grid = torch.zeros(4 * LANES, dtype=torch.uint8)
    grid[:n] = torch.from_numpy(syms)
    words, mask, state = ref.rans_encode(grid.reshape(4, LANES), t.freq, t.cum, n)
    assert int(mask.reshape(-1)[n:].sum()) == 0 and int(words.reshape(-1)[n:].abs().sum()) == 0
    js = jans.encode(jnp.asarray(syms), jt)
    lens = np.asarray(js.lens)
    assert_bits_equal(torch.from_numpy((mask.sum(0) + 2).numpy()), lens, "lens")
    flush = np.asarray(js.words)[np.arange(LANES), lens - 2].astype(np.uint32) | (
        np.asarray(js.words)[np.arange(LANES), lens - 1].astype(np.uint32) << 16)
    assert_bits_equal(state, flush, "final state = flush words")
    back = rans.decode_stream(torch.from_numpy(np.array(js.words)),
                              torch.from_numpy(np.array(lens)), t.freq, t.cum,
                              ans._slot_to_symbol(t), 4, n)
    assert_bits_equal(back.reshape(-1)[:n], syms, "stream decode")


def test_plain_rans_encode_at_the_top_frequency_m_minus_255():
    """A table whose top frequency is M - 255 (every other symbol one slot):
    the largest ``x_max`` the 32-bit state meets; the stream uses the top
    symbol and a few rare ones."""
    freq = np.ones(256, np.uint32)
    freq[7] = ans.M - 255
    t = ans.table_from_freq(torch.from_numpy(freq.astype(np.int64)))
    syms = _symbols("single", 7 * LANES, seed=0)
    syms[::97] = np.arange(len(syms[::97]), dtype=np.uint8) * 3
    syms = syms.reshape(7, LANES)
    words, mask, state = rans.encode(torch.from_numpy(syms), t.freq, t.cum)
    jw = jref.rans_encode(jnp.asarray(syms, jnp.uint32), jnp.asarray(freq),
                          jnp.asarray(t.cum[:256].numpy().astype(np.uint32)))
    for k, g, w in zip(("words", "mask", "state"), (words, mask, state), jw):
        assert_bits_equal(g, w, k)
    assert_bits_equal(rans.decode(words, state, t.freq, t.cum, ans._slot_to_symbol(t)),
                      syms, "roundtrip")


# ---------------------------------------------------------------------------
# core/ans.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,kind", [(5000, "skewed"), (700_000, "skewed"),
                                    (1 << 14, "uniform"), (300, "single")])
def test_build_freq_table_and_slot_table_match_reference(n, kind):
    """Including counts above 0.5 M (the reference's f32 path) and ties
    (uniform: many equal frequencies, the drift on the first)."""
    syms = _symbols(kind, n, seed=n)
    jt, t = _tables(syms)
    assert_bits_equal(t.freq, jt.freq, "freq")
    assert_bits_equal(t.cum, jt.cum, "cum")
    assert int(t.freq.sum()) == ans.M and int(t.freq.min()) >= 1
    assert_bits_equal(ans._slot_to_symbol(t), jans._slot_to_symbol(jt), "s2s")


def test_build_freq_table_breaks_ties_to_the_first_maximum():
    syms = np.repeat(np.array([3, 9, 200], np.uint8), 1000)
    jt, t = _tables(syms)
    assert_bits_equal(t.freq, jt.freq, "tied freq")
    assert int(torch.argmax(t.freq)) == 3


@pytest.mark.parametrize("n,kind", [(128 * 9, "skewed"), (1000, "skewed"),
                                    (77, "uniform"), (4099, "single")])
def test_encode_and_decode_match_reference(n, kind):
    """Words and lens bit for bit on ragged n; each package decodes the
    other's stream."""
    syms = _symbols(kind, n, seed=n + 1)
    jt, t = _tables(syms)
    js = jans.encode(jnp.asarray(syms), jt)
    s = ans.encode(torch.from_numpy(syms), t)
    assert s.words.dtype == torch.uint16 and s.lens.dtype == torch.int32
    assert_bits_equal(s.words.view(torch.int16).numpy().view(np.uint16), js.words, "words")
    assert_bits_equal(s.lens, js.lens, "lens")
    assert s.compressed_nbytes() == int(js.compressed_nbytes())
    assert_bits_equal(ans.decode(s), syms, "decode")
    cross = ans.AnsStream(words=torch.from_numpy(np.array(js.words)),
                          lens=torch.from_numpy(np.array(js.lens)), table=t, n=n,
                          lanes=LANES)
    assert_bits_equal(ans.decode(cross), syms, "port decodes the reference's stream")
    back = jans.AnsStream(words=jnp.asarray(s.words.view(torch.int16).numpy().view(np.uint16)),
                          lens=jnp.asarray(s.lens.numpy()), table=jt, n=n, lanes=LANES)
    assert_bits_equal(jans.decode(back), syms, "reference decodes the port's stream")


def test_roundtrip_and_ratio_estimate():
    syms = _symbols("skewed", 20_000, seed=5)
    assert ans.roundtrip_exact(torch.from_numpy(syms))
    got = float(ans.ans_ratio_estimate(torch.from_numpy(syms)))
    want = float(jans.ans_ratio_estimate(jnp.asarray(syms)))
    assert abs(got - want) <= 1e-5 * want  # f32 sums in another order


def test_cpu_rans_launches_no_kernel():
    kernels.clear_launch_counts()
    syms = torch.from_numpy(_symbols("skewed", 1024, seed=6))
    ans.decode(ans.encode(syms, ans.build_freq_table(syms)))
    packing.bitplane_unpack(packing.bitplane_pack(syms.to(torch.int32), 8), 8)
    assert not any(kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# width calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_choose_width_matches_reference(fmt):
    bits = grad_like_bits(fmt, 512 * 40 + 100, seed=21)
    x, jx = to_torch(bits, fmt), to_jax(bits, fmt)
    assert_bits_equal(calibrate.block_range_stats(x), jcalibrate.block_range_stats(jx),
                      "block stats")
    for kw in ({}, {"target_exc_rate": 0.05}, {"margin_bits": 1}):
        got, want = calibrate.choose_width(x, **kw), jcalibrate.choose_width(jx, **kw)
        assert (got.width, got.exc_frac, got.est_exc_rate, got.est_ratio) == (
            want.width, want.exc_frac, want.est_exc_rate, want.est_ratio), kw
        assert got.entropy_bits == pytest.approx(want.entropy_bits, rel=1e-5)
