"""Fused receive-side decode + reduce (paper §3.4, ``CopyReducePacks``).

Wrapper of the CUDA kernel ``csrc/decode_reduce.cu``, the port of the TPU
kernel ``repro/kernels/decode_reduce.py::_decode_reduce_kernel``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor runs the plain version
``ref.decode_reduce``.  The accumulator is updated in place.  The kernel's
persistent thread blocks walk over tiles of groups (:func:`geometry`); all
four tensors must start on a 16-byte boundary (the kernel stages the planes
by 16-byte copies and reads and writes the accumulator 16 bytes at a time),
which the wrapper checks and never fixes by a copy.  Each launch is also
tallied under its shape, ``(format, groups, width)``
(``kernels.launch_shapes``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.core import codec
from repro_torch.core.packing import GROUP
from repro_torch.kernels import ref

plain = ref.decode_reduce

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)

# csrc/decode_reduce.cu: threads a thread block (4 values each, so 32 groups
# a pass) and groups a tile at most (the thread holds a tile's accumulator
# in registers)
THREADS = kernels.DECODE_REDUCE_THREADS
MAX_TILE = kernels.DECODE_REDUCE_MAX_TILE


@functools.lru_cache(maxsize=1024)  # a pure function of ints, called a launch
def geometry(n_groups: int, width: int, lo_bits: int, sms: int) -> kernels.TileGeometry:
    """:func:`kernels.tile_geometry` for the decode_reduce kernel: tiles of
    at most MAX_TILE groups; shared bytes: two stages of a tile's payload
    words, lo words and group bases (each range starts on a 16-byte
    boundary, as the tile is a multiple of 32 groups)."""
    return kernels.tile_geometry(n_groups, MAX_TILE, THREADS,
                                 lambda t: 2 * t * 4 * (width + lo_bits + 1), sms)


def decode_reduce(payload: torch.Tensor, lo_planes: torch.Tensor,
                  group_bases: torch.Tensor, acc: torch.Tensor,
                  dtype_name: str, width: int) -> torch.Tensor:
    """``acc += decode(wire)`` in one pass; returns ``acc``.

    payload int32 (n_g, width), lo_planes int32 (n_g, lo_bits), group_bases
    int32 (n_g,) (the per-block base repeated per GROUP), acc float32
    (32 * n_g,), all on one device and contiguous (on CUDA also 16-byte
    aligned)."""
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
    if acc.device.type == "cpu":
        return acc.copy_(plain(payload, lo_planes, group_bases, acc,
                               dtype_name, width))
    if acc.device.type != "cuda" or not all(t.is_contiguous() for t, _, _ in want.values()):
        raise ValueError("decode_reduce takes contiguous CPU or CUDA tensors")
    if n_g == 0:
        return acc
    for name, (t, _, _) in want.items():
        kernels.require_aligned(t.data_ptr(), f"decode_reduce's {name}")
    geo = geometry(n_g, width, lay.lo_bits, kernels.sm_count(acc.device))
    launch = kernels.launcher("decode_reduce", _ARGTYPES)
    err = launch(payload.data_ptr(), lo_planes.data_ptr(), group_bases.data_ptr(),
                 acc.data_ptr(), n_g, width, kernels.FORMATS.index(lay.name),
                 geo.tile, geo.grid, geo.smem, kernels.stream_of(acc))
    if err:
        raise RuntimeError(f"decode_reduce launch failed: cudaError {err} ({geo})")
    kernels.count_launch("decode_reduce", (dtype_name, n_g, width))
    return acc
