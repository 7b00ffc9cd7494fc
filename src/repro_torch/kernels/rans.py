"""Interleaved-lane rANS encode and decode (the host path's entropy coder).

Wrappers of the CUDA kernels in ``csrc/rans.cu``, the port of the TPU
kernels ``repro/kernels/rans.py::_encode_kernel`` and ``::_decode_kernel``.
A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version (``ref.rans_encode``, ``ref.rans_decode``, ``ref.rans_decode_stream``).
One thread owns one lane: the paper's warp-level ANS, one stream per lane.

Tables are the quantised frequencies ``freq`` and their exclusive prefix
sums ``cum`` (256 entries used) and the slot -> symbol table ``s2s`` (4096
entries) of ``core/ans.py``.  Every function takes ``n_valid`` (default: all
of ``per * lanes``): symbols at flat index ``>= n_valid`` are padding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import ref

plain_encode = ref.rans_encode
plain_decode = ref.rans_decode
plain_decode_stream = ref.rans_decode_stream

_ENC_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_int,
                                          ctypes.c_longlong, ctypes.c_void_p)
_DEC_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)


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
    freq = _word_table(freq, 256, dev, "freq")
    cum = _word_table(cum, 256, dev, "cum")
    syms = syms.to(torch.uint8).contiguous()
    words = torch.empty((per, lanes), dtype=torch.int32, device=dev)
    mask = torch.empty((per, lanes), dtype=torch.int32, device=dev)
    state = torch.empty((lanes,), dtype=torch.int32, device=dev)
    if lanes == 0:
        return words, mask, state
    err = kernels.launcher("rans_encode", _ENC_ARGTYPES)(
        syms.data_ptr(), freq.data_ptr(), cum.data_ptr(), words.data_ptr(),
        mask.data_ptr(), state.data_ptr(), per, lanes, n_valid,
        kernels.stream_of(syms))
    if err:
        raise RuntimeError(f"rans_encode launch failed: cudaError {err}")
    kernels.count_launch("rans_encode")
    return words, mask, state


def _launch_decode(words, lens, state, freq, cum, s2s, per, lanes, cap,
                   n_valid, compact):
    dev = words.device
    freq = _word_table(freq, 256, dev, "freq")
    cum = _word_table(cum, 256, dev, "cum")
    s2s = _word_table(s2s, ref.M, dev, "s2s", torch.uint8)
    out = torch.empty((per, lanes), dtype=torch.uint8, device=dev)
    if lanes == 0:
        return out
    err = kernels.launcher("rans_decode", _DEC_ARGTYPES)(
        words.data_ptr(), lens.data_ptr(), state.data_ptr(), freq.data_ptr(),
        cum.data_ptr(), s2s.data_ptr(), out.data_ptr(), per, lanes, cap,
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
    words = words.contiguous()
    lens = lens.to(device=words.device, dtype=torch.int32).contiguous()
    return _launch_decode(words, lens, lens, freq, cum, s2s, per, lanes, cap,
                          n_valid, compact=True)
