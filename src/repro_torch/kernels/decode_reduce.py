"""Fused receive-side decode + reduce (paper §3.4, ``CopyReducePacks``).

Wrapper of the CUDA kernel ``csrc/decode_reduce.cu``, the port of the TPU
kernel ``repro/kernels/decode_reduce.py::_decode_reduce_kernel``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor runs the plain version
``ref.decode_reduce``.  The accumulator is updated in place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import codec
from repro_torch.core.packing import GROUP
from repro_torch.kernels import ref

plain = ref.decode_reduce

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def decode_reduce(payload: torch.Tensor, lo_planes: torch.Tensor,
                  group_bases: torch.Tensor, acc: torch.Tensor,
                  dtype_name: str, width: int) -> torch.Tensor:
    """``acc += decode(wire)`` in one pass; returns ``acc``.

    payload int32 (n_g, width), lo_planes int32 (n_g, lo_bits), group_bases
    int32 (n_g,) (the per-block base repeated per GROUP), acc float32
    (32 * n_g,), all on one device and contiguous."""
    lay = codec.LAYOUTS[dtype_name]
    n_g = payload.shape[0]
    want = {"payload": (payload, torch.int32, (n_g, width)),
            "lo_planes": (lo_planes, torch.int32, (n_g, lay.lo_bits)),
            "group_bases": (group_bases, torch.int32, (n_g,)),
            "acc": (acc, torch.float32, (GROUP * n_g,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != acc.device:
            raise ValueError(f"decode_reduce: {name} must be {dtype} {shape} on "
                             f"{acc.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in [1, 32], got {width}")
    if n_g >= 2**31:
        raise ValueError(f"decode_reduce takes fewer than 2**31 groups, got {n_g}")
    if acc.device.type == "cpu":
        return acc.copy_(plain(payload, lo_planes, group_bases, acc,
                               dtype_name, width))
    if acc.device.type != "cuda" or not all(t.is_contiguous() for t, _, _ in want.values()):
        raise ValueError("decode_reduce takes contiguous CPU or CUDA tensors")
    if n_g == 0:
        return acc
    launch = kernels.launcher("decode_reduce", _ARGTYPES)
    err = launch(payload.data_ptr(), lo_planes.data_ptr(), group_bases.data_ptr(),
                 acc.data_ptr(), n_g, width, kernels.FORMATS.index(lay.name),
                 kernels.stream_of(acc))
    if err:
        raise RuntimeError(f"decode_reduce launch failed: cudaError {err}")
    kernels.count_launch("decode_reduce")
    return acc
