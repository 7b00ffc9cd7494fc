"""The tables the rANS kernels are given (``kernels/rans.py``
``encode_table`` and ``slot_table``), checked on the CPU against the plain
versions' arithmetic and the JAX package's tables.

* the slot table holds ``freq[sym]`` and ``slot - cum[sym]`` of the
  reference's slot -> symbol table;
* the encode table's exact reciprocal gives ``x // f`` for every ``f`` in
  [1, 4096] on the edge dividends and 10 000 seeded random uint32, emulated
  in int64;
* one encode step and one decode step computed from the tables, as the
  kernels compute them, equal the plain versions' steps;
* the chain the kernels' floor is timed on (``rans.chain``, here its plain
  version) is one lane of the plain encode and of the plain dense decode;
* the tile rows the checks on the card are sized by match ``csrc/rans.cu``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ans as jans
from repro_torch.core import ans
from repro_torch.kernels import rans, ref

U32 = 0xFFFFFFFF
M = ans.M


def _freq(kind: str) -> np.ndarray:
    """Quantised frequencies (256,) summing to M."""
    rng = np.random.default_rng(40)
    if kind in ("skewed", "uniform", "single"):
        n = 50_000
        syms = {"skewed": np.clip(rng.normal(120, 2.5, n), 0, 255),
                "uniform": rng.integers(0, 256, n),
                "single": np.full(n, 7)}[kind].astype(np.uint8)
        return np.asarray(jans.build_freq_table(jnp.asarray(syms)).freq, np.int64)
    f = np.zeros(256, np.int64)
    if kind == "top_m_minus_255":
        f[:] = 1
        f[7] = M - 255
    elif kind == "ones_twos_largest":  # 1, 2 and the largest that fits beside them
        f[3], f[200], f[9] = 1, 2, M - 3
    elif kind == "one_symbol_all_of_m":
        f[255] = M
    return f


KINDS = ["skewed", "uniform", "single", "top_m_minus_255", "ones_twos_largest",
         "one_symbol_all_of_m"]


def _table(kind: str):
    f = _freq(kind)
    assert f.sum() == M
    return ans.table_from_freq(torch.from_numpy(f))


def _umulhi(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a * b) >> 32 of uint32 values held in int64, without overflow."""
    hi, lo = b >> 16, b & 0xFFFF
    return (a * hi + ((a * lo) >> 16)) >> 16


def _quotient(info: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The kernel's quotient from encode_table rows ``info`` (k, 8) for
    dividends ``x`` (n,): (k, n)."""
    m_lo, m_hi = info[:, 1:2], info[:, 2:3]
    return (x[None] * m_hi + _umulhi(m_lo, x[None])) >> 12


@pytest.mark.parametrize("kind", KINDS)
def test_slot_table_holds_the_reference_tables(kind):
    t = _table(kind)
    jt = jans.FreqTable(freq=jnp.asarray(_freq(kind), jnp.int32),
                        cum=jnp.asarray(t.cum.numpy()))
    s2s = ans._slot_to_symbol(t)
    np.testing.assert_array_equal(s2s.numpy(), np.asarray(jans._slot_to_symbol(jt)))
    e = rans.slot_table(t.freq, t.cum, s2s).numpy().astype(np.int64) & U32
    assert e.shape == (M, 2)
    sym = s2s.numpy().astype(np.int64)
    f, c = t.freq.numpy().astype(np.int64), t.cum.numpy().astype(np.int64)
    np.testing.assert_array_equal(e[:, 0], f[sym])
    np.testing.assert_array_equal(e[:, 1], np.arange(M) - c[sym])
    assert (e[:, 1] < e[:, 0]).all()  # bias in [0, f)


@pytest.mark.parametrize("block", range(M // 256))
def test_encode_table_reciprocal_is_exact_division(block):
    """f in [256 block + 1, 256 block + 256]: every f in [1, 4096] over the
    blocks."""
    f = np.arange(256 * block + 1, 256 * block + 257, dtype=np.int64)
    info = rans.encode_table(torch.from_numpy(f), torch.zeros(256, dtype=torch.int64))
    info = info.numpy().astype(np.int64) & U32
    rng = np.random.default_rng(41)
    edges = np.stack([np.zeros_like(f), np.ones_like(f), f - 1, f, f + 1,
                      ((1 << 20) * f - 1) & U32, (1 << 32) - f,
                      np.full_like(f, U32)], 1)
    for x in (edges, rng.integers(0, 1 << 32, 10_000, dtype=np.int64)):
        if x.ndim == 1:
            got, want = _quotient(info, x), x[None] // f[:, None]
        else:  # each f's own edge dividends
            got = np.stack([_quotient(info[i:i + 1], x[i])[0] for i in range(256)])
            want = x // f[:, None]
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(info[:, 0], (f << 20) & U32)
    np.testing.assert_array_equal(info[:, 3], (M - f) & U32)
    np.testing.assert_array_equal(info[:, 5:], 0)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_steps_from_the_tables_equal_the_plain_steps(kind):
    """One encode step (renormalise, then q (M - f) + (x + cum)) and one
    decode step (f hi + bias) from the tables, as the kernels compute them,
    for every symbol and slot over seeded random states."""
    t = _table(kind)
    f, c = t.freq.numpy().astype(np.int64), t.cum.numpy().astype(np.int64)
    rng = np.random.default_rng(42)
    state = rng.integers(0, 1 << 32, 4096, dtype=np.int64)
    info = rans.encode_table(t.freq, t.cum).numpy().astype(np.int64) & U32
    used = np.flatnonzero(f)
    for s in used:
        e = info[s]
        need = state >= e[0]
        x = np.where(need, state >> 16, state)
        q = _quotient(e[None], x)[0]
        got = (q * e[3] + x + e[4]) & U32
        xs = np.where(state >= ((1 << 20) * f[s]) & U32, state >> 16, state)
        want = ((xs // f[s] << 12) + xs % f[s] + c[s]) & U32
        np.testing.assert_array_equal(got, want, err_msg=f"symbol {s}")
    slots = rans.slot_table(t.freq, t.cum, ans._slot_to_symbol(t)).numpy()
    e = slots.astype(np.int64)[state & (M - 1)] & U32
    hi = state >> 12
    got = (e[:, 0] * hi + e[:, 1]) & U32
    sym = ans._slot_to_symbol(t).numpy().astype(np.int64)[state & (M - 1)]
    want = (f[sym] * hi + (state & (M - 1)) - c[sym]) & U32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_chain_encode_is_one_lane_of_the_plain_encode(kind):
    t = _table(kind)
    rng = np.random.default_rng(41)
    cycle = torch.from_numpy(rng.choice(np.flatnonzero(_freq(kind)), 8).astype(np.uint8))
    steps = 67
    lane = cycle[torch.arange(steps) % 8].flip(0).reshape(steps, 1)  # step i: row steps-1-i
    got, cycles = rans.chain("encode", t.freq, t.cum, ans._slot_to_symbol(t), cycle,
                             torch.zeros(8, dtype=torch.int32), 0, steps)
    assert cycles is None  # counted on the card only
    assert torch.equal(got, ref.rans_encode(lane, t.freq, t.cum)[2])


@pytest.mark.parametrize("kind", KINDS)
def test_chain_decode_is_one_lane_of_the_plain_decode(kind):
    t = _table(kind)
    s2s = ans._slot_to_symbol(t)
    rng = np.random.default_rng(42)
    words = torch.from_numpy(rng.integers(0, 1 << 16, 8).astype(np.uint16))
    steps = 29
    lane = (words.view(torch.int16).to(torch.int64) & 0xFFFF)[torch.arange(steps) % 8]
    for state in (ref.RANS_L, U32, int(rng.integers(ref.RANS_L, 1 << 32))):
        want = ref.rans_decode(lane.reshape(steps, 1).to(torch.int32),
                               torch.tensor([state]).to(torch.int32), t.freq, t.cum, s2s)
        got = [int(rans.chain("decode", t.freq, t.cum, s2s, torch.zeros(8, dtype=torch.uint8),
                              words, state, k)[0]) & (M - 1) for k in range(steps)]
        assert s2s[got].tolist() == want[:, 0].tolist()


def test_tile_rows_match_the_kernel_source():
    src = (Path(rans.__file__).parent / "csrc" / "rans.cu").read_text()
    assert int(re.search(r"constexpr int ROWS = (\d+);", src).group(1)) == rans.ROWS
    assert "constexpr int DENSE_ROWS = ROWS / 4;" in src
    assert rans.ROWS % 4 == 0 and ref.M == M
