"""Interleaved-lane rANS encode and decode (the host path's entropy coder).

Wrappers of the CUDA kernels in ``csrc/rans.cu``, the port of the TPU
kernels ``repro/kernels/rans.py::_encode_kernel`` and ``::_decode_kernel``.
A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version (``ref.rans_encode``, ``ref.rans_decode``, ``ref.rans_decode_stream``).
One thread owns one lane: the paper's warp-level ANS, one stream per lane.

Tables are the quantised frequencies ``freq`` and their exclusive prefix
sums ``cum`` (256 entries used) and the slot -> symbol table ``s2s`` (4096
entries, consistent with ``cum``: ``ans._slot_to_symbol``) of
``core/ans.py``.  Every function takes ``n_valid`` (default: all of ``per *
lanes``): symbols at flat index ``>= n_valid`` are padding.

The kernels are bound by each lane's chain of dependent steps, so before a
launch the wrapper turns the tables into what a step needs with a few torch
ops on the device: :func:`encode_table` (per symbol: the renormalisation
bound, an exact 44-bit reciprocal of ``f``, ``M - f`` and ``cum``) and
:func:`slot_table` (per slot: ``f`` and ``slot - cum`` of its symbol side by
side).  The CPU tests check their arithmetic.

:func:`chain` runs one lane's chain of either kernel alone and counts its
cycles, for the kernels' floor: the least time ``per`` dependent steps take
on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import packing
from repro_torch.kernels import ref

plain_encode = ref.rans_encode
plain_decode = ref.rans_decode
plain_decode_stream = ref.rans_decode_stream

# Tile rows of csrc/rans.cu (ROWS; the dense decode's tiles are ROWS / 4):
# the checks on the card run ``per`` on both sides of their edges.
ROWS = 248

_ENC_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_int,
                                          ctypes.c_longlong, ctypes.c_void_p)
_DEC_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)
_CHAIN_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p)


def encode_table(freq: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """int32 (256, 8): for each symbol with frequency f (1 <= f <= M) and
    prefix sum c, the uint32 words ``x_max = (f << 20) mod 2**32`` (the
    state at which the encode renormalises), ``m_lo``, ``m_hi``, ``M - f``,
    ``c``, then three zeros.  ``m = m_hi * 2**32 + m_lo = ceil(2**44 / f)``
    and ``(x * m_hi + umulhi(x, m_lo)) >> 12`` is ``x // f`` for every uint32
    ``x``: ``x * m / 2**44`` exceeds ``x / f`` by less than ``2**32 / 2**44 <=
    1 / f``, which never reaches the next integer."""
    f, c = (packing._as_u32(t.reshape(-1)[:256]) for t in (freq, cum))
    m = -(-(1 << 44) // f.clamp(1, ref.M))  # a symbol of frequency 0 is never encoded
    x_max = (f << 20) & packing._U32  # ((RANS_L >> PROB_BITS) << 16) * f, wrapped
    zero = torch.zeros_like(f)
    return torch.stack([x_max, m & packing._U32, m >> 32, (ref.M - f) & packing._U32, c,
                        zero, zero, zero], 1).to(torch.int32)


def slot_table(freq: torch.Tensor, cum: torch.Tensor, s2s: torch.Tensor) -> torch.Tensor:
    """int32 (M, 2): for slot t with symbol ``s = s2s[t]``, ``(freq[s], t -
    cum[s])``, so that a decode step's multiply-add ``f * (state >> 12) +
    bias`` takes both operands from one lookup (the kernel reads the symbol
    from ``s2s`` beside it)."""
    f, c = (packing._as_u32(t.reshape(-1)[:256]) for t in (freq, cum))
    sym = s2s.reshape(-1)[:ref.M].to(torch.int64)
    bias = torch.arange(ref.M, device=sym.device) - c[sym]
    return torch.stack([f[sym], bias & packing._U32], 1).to(torch.int32)


def _n_valid(per: int, lanes: int, n_valid) -> int:
    n_valid = per * lanes if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= per * lanes:
        raise ValueError(f"n_valid={n_valid} outside [0, {per * lanes}]")
    return n_valid


def _word_table(t: torch.Tensor, n: int, dev, name: str,
                dtype=torch.int32) -> torch.Tensor:
    """The first ``n`` entries of a table as a contiguous ``dtype`` tensor
    on ``dev``."""
    t = t.reshape(-1)
    if t.shape[0] < n or t.device != dev:
        raise ValueError(f"{name} needs >= {n} entries on {dev}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t[:n].to(dtype).contiguous()


def _check_cuda(t: torch.Tensor, op: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{op} takes CPU or CUDA tensors, got {t.device}")


def encode(syms: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor,
           n_valid=None):
    """syms integer (per, lanes), values < 256.  Returns (words int32 (per,
    lanes), mask int32 (per, lanes), state int32 (lanes,)), bit-identical to
    :func:`plain_encode`."""
    if syms.dim() != 2:
        raise ValueError(f"rans encode needs symbols (per, lanes), got "
                         f"{tuple(syms.shape)}")
    per, lanes = syms.shape
    n_valid = _n_valid(per, lanes, n_valid)
    if syms.device.type == "cpu":
        return plain_encode(syms, freq, cum, n_valid)
    _check_cuda(syms, "rans encode")
    dev = syms.device
    info = encode_table(_word_table(freq, 256, dev, "freq"),
                        _word_table(cum, 256, dev, "cum"))
    syms = kernels.aligned(syms.to(torch.uint8).contiguous())
    words = torch.empty((per, lanes), dtype=torch.int32, device=dev)
    mask = torch.empty((per, lanes), dtype=torch.int32, device=dev)
    state = torch.empty((lanes,), dtype=torch.int32, device=dev)
    if lanes == 0:
        return words, mask, state
    err = kernels.launcher("rans_encode", _ENC_ARGTYPES)(
        syms.data_ptr(), info.data_ptr(), words.data_ptr(), mask.data_ptr(),
        state.data_ptr(), per, lanes, n_valid,
        kernels.stream_of(syms))
    if err:
        raise RuntimeError(f"rans_encode launch failed: cudaError {err}")
    kernels.count_launch("rans_encode")
    return words, mask, state


def _launch_decode(words, lens, state, freq, cum, s2s, per, lanes, cap,
                   n_valid, compact):
    dev = words.device
    s2s = _word_table(s2s, ref.M, dev, "s2s", torch.uint8)
    slots = slot_table(_word_table(freq, 256, dev, "freq"),
                       _word_table(cum, 256, dev, "cum"), s2s)
    out = torch.empty((per, lanes), dtype=torch.uint8, device=dev)
    if lanes == 0:
        return out
    err = kernels.launcher("rans_decode", _DEC_ARGTYPES)(
        words.data_ptr(), lens.data_ptr(), state.data_ptr(), slots.data_ptr(),
        s2s.data_ptr(), out.data_ptr(), per, lanes, cap,
        n_valid, int(compact), kernels.stream_of(words))
    if err:
        raise RuntimeError(f"rans_decode launch failed: cudaError {err}")
    kernels.count_launch("rans_decode")
    return out


def decode(words: torch.Tensor, state: torch.Tensor, freq: torch.Tensor,
           cum: torch.Tensor, s2s: torch.Tensor, n_valid=None) -> torch.Tensor:
    """Dense decode: words (per, lanes) and start states (lanes,) as 32-bit
    words -> uint8 symbols (per, lanes), bit-identical to
    :func:`plain_decode`."""
    if words.dim() != 2 or tuple(state.shape) != (words.shape[1],):
        raise ValueError(f"rans decode needs words (per, lanes) and state "
                         f"(lanes,), got {tuple(words.shape)}, {tuple(state.shape)}")
    per, lanes = words.shape
    n_valid = _n_valid(per, lanes, n_valid)
    if words.device.type == "cpu":
        return plain_decode(words, state, freq, cum, s2s, n_valid)
    _check_cuda(words, "rans decode")
    words = words.to(torch.int32).contiguous()
    state = state.to(device=words.device, dtype=torch.int32).contiguous()
    return _launch_decode(words, state, state, freq, cum, s2s, per, lanes, 0,
                          n_valid, compact=False)


def decode_stream(words: torch.Tensor, lens: torch.Tensor, freq: torch.Tensor,
                  cum: torch.Tensor, s2s: torch.Tensor, per: int,
                  n_valid=None) -> torch.Tensor:
    """Decode of compacted streams: words uint16 (lanes, cap), lens int
    (lanes,) -> uint8 symbols (per, lanes), bit-identical to
    :func:`plain_decode_stream`."""
    if words.dim() != 2 or tuple(lens.shape) != (words.shape[0],):
        raise ValueError(f"rans decode_stream needs words (lanes, cap) and "
                         f"lens (lanes,), got {tuple(words.shape)}, "
                         f"{tuple(lens.shape)}")
    if words.dtype not in (torch.uint16, torch.int16):
        raise ValueError(f"stream words are 16-bit, got {words.dtype}")
    lanes, cap = words.shape
    n_valid = _n_valid(per, lanes, n_valid)
    if words.device.type == "cpu":
        return plain_decode_stream(words, lens, freq, cum, s2s, per, n_valid)
    _check_cuda(words, "rans decode_stream")
    words = kernels.aligned(words.contiguous())
    lens = lens.to(device=words.device, dtype=torch.int32).contiguous()
    return _launch_decode(words, lens, lens, freq, cum, s2s, per, lanes, cap,
                          n_valid, compact=True)

def _low16(words: torch.Tensor) -> torch.Tensor:
    """The first eight 16-bit words of ``words`` as int64 values."""
    w = words.reshape(-1)[:8]
    return (w.view(torch.int16) if w.dtype == torch.uint16 else w).to(torch.int64) & 0xFFFF


def plain_chain(kind: str, freq: torch.Tensor, cum: torch.Tensor, s2s: torch.Tensor,
                syms: torch.Tensor, words: torch.Tensor, state: int,
                steps: int) -> torch.Tensor:
    """Plain version of :func:`chain`: the final state, int32 (1,), of
    ``steps`` steps of one lane, step i taking ``syms[i % 8]`` (encode, from
    ``RANS_L``, as :func:`plain_encode` runs a lane) or pulling ``words[i %
    8]`` (decode, from ``state``, as :func:`plain_decode` runs a lane)."""
    f = [int(v) & 0xFFFFFFFF for v in freq.reshape(-1)[:256].tolist()]
    c = [int(v) & 0xFFFFFFFF for v in cum.reshape(-1)[:256].tolist()]
    if kind == "encode":
        cycle, x = [int(v) for v in syms.reshape(-1)[:8].tolist()], ref.RANS_L
        for i in range(steps):
            s = cycle[i % 8]
            if x >= ((f[s] << 20) & 0xFFFFFFFF):
                x >>= 16
            x = ((x // f[s] << ref.PROB_BITS) + x % f[s] + c[s]) & 0xFFFFFFFF
    elif kind == "decode":
        cycle = _low16(words).tolist()
        table, x = [int(v) for v in s2s.reshape(-1)[:ref.M].tolist()], state & 0xFFFFFFFF
        for i in range(steps):
            slot = x & (ref.M - 1)
            s = table[slot]
            x = (f[s] * (x >> ref.PROB_BITS) + slot - c[s]) & 0xFFFFFFFF
            if x < ref.RANS_L:
                x = ((x << 16) | cycle[i % 8]) & 0xFFFFFFFF
    else:
        raise ValueError(f"chain kind is 'encode' or 'decode', got {kind!r}")
    return packing._to_word(torch.tensor([x], dtype=torch.int64))


def chain(kind: str, freq: torch.Tensor, cum: torch.Tensor, s2s: torch.Tensor,
          syms: torch.Tensor, words: torch.Tensor, state: int, steps: int):
    """``steps`` steps of one lane's state chain of the ``kind`` kernel
    ("encode" or "decode") and nothing else: the kernel's own step, in one
    thread, with the eight entries of ``syms`` (uint8, encode) or the eight
    16-bit ``words`` (decode) held in registers.  Returns (the final state,
    int32 (1,), equal to :func:`plain_chain`'s; the SM cycles the steps took
    on the card, None on the CPU).  Those cycles give the kernels' floor; it
    is no kernel of a path and is not counted."""
    if syms.device.type == "cpu":
        return plain_chain(kind, freq, cum, s2s, syms, words, state, steps), None
    _check_cuda(syms, "rans chain")
    if kind not in ("encode", "decode") or steps % 8:
        raise ValueError(f"rans chain needs kind 'encode' or 'decode' and steps a "
                         f"multiple of 8, got {kind!r}, {steps}")
    dev = syms.device
    f, c = _word_table(freq, 256, dev, "freq"), _word_table(cum, 256, dev, "cum")
    info = encode_table(f, c)
    slots = slot_table(f, c, _word_table(s2s, ref.M, dev, "s2s", torch.uint8))
    syms = _word_table(syms, 8, dev, "syms", torch.uint8)
    words = _word_table(_low16(words), 8, dev, "words")
    sink = torch.empty((3,), dtype=torch.int64, device=dev)
    err = kernels.launcher("rans_chain", _CHAIN_ARGTYPES, source="rans")(
        info.data_ptr(), slots.data_ptr(), syms.data_ptr(), words.data_ptr(),
        state & 0xFFFFFFFF, steps, int(kind == "decode"), sink.data_ptr(),
        kernels.stream_of(syms))
    if err:
        raise RuntimeError(f"rans_chain launch failed: cudaError {err}")
    out = sink.tolist()
    return packing._to_word(torch.tensor(out[:1]).to(dev)), out[2]
