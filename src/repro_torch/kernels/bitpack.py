"""Bit-plane pack and unpack (the wire codec's inner loop).

Wrappers of the CUDA kernels in ``csrc/bitpack.cu``, the port of the TPU
kernels ``repro/kernels/bitpack.py::_pack_kernel`` and ``::_unpack_kernel``.
A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version ``ref.pack`` / ``ref.unpack``.  Any whole number of 32-value groups
is taken (zero groups launch nothing); pack reads uint8, int32 and int64
values as they are, so no caller widens its values first.  Both kernels'
persistent thread blocks walk over tiles of groups (:func:`pack_geometry`,
:func:`unpack_geometry`); the values and the packed words must start on a
16-byte boundary (the kernels stage them by 16-byte copies), which the
wrappers check and never fix by a copy.  Each launch is also tallied
under its shape (``kernels.launch_shapes``): pack's ``(dtype, groups,
width)``, unpack's ``(groups, width)``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.core.packing import GROUP
from repro_torch.kernels import ref

plain_pack = ref.pack
plain_unpack = ref.unpack

# input dtypes of the pack kernel, by the kind index of csrc/bitpack.cu
_PACK_KINDS = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}
_PACK_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong) + (
    ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_UNPACK_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong) + (
    ctypes.c_int,) * 4 + (ctypes.c_void_p,)

# csrc/bitpack.cu: threads a thread block (4 values each, so 32 groups a
# pass), bytes a stage aims at (pack: values, unpack: packed words), groups
# a tile at most
PACK_THREADS = kernels.PACK_THREADS
PACK_STAGE_BYTES = 8192
PACK_MAX_TILE = 256
UNPACK_THREADS = kernels.UNPACK_THREADS
UNPACK_STAGE_BYTES = 16384
UNPACK_MAX_TILE = 256


@functools.lru_cache(maxsize=1024)  # a pure function of ints, called a launch
def pack_geometry(n_groups: int, width: int, itemsize: int,
                  sms: int) -> kernels.TileGeometry:
    """:func:`kernels.tile_geometry` for the pack kernel: tiles whose values
    (``itemsize`` bytes each) fill at most PACK_STAGE_BYTES; shared bytes:
    two stages of a tile's values, then its words.  A tile's values are
    whole 16-byte pieces at any count, and its words start on a 16-byte
    boundary."""
    t_max = min(PACK_MAX_TILE, PACK_STAGE_BYTES // (GROUP * itemsize) // GROUP * GROUP)
    return kernels.tile_geometry(n_groups, t_max, PACK_THREADS,
                                 lambda t: 2 * t * GROUP * itemsize + t * width * 4, sms)


@functools.lru_cache(maxsize=1024)
def unpack_geometry(n_groups: int, width: int, sms: int) -> kernels.TileGeometry:
    """:func:`kernels.tile_geometry` for the unpack kernel: tiles whose
    words fill at most UNPACK_STAGE_BYTES; shared bytes: two stages of a
    tile's packed words (so every tile's words start on a 16-byte
    boundary)."""
    t_max = min(UNPACK_MAX_TILE, UNPACK_STAGE_BYTES // (4 * width) // GROUP * GROUP)
    return kernels.tile_geometry(n_groups, t_max, UNPACK_THREADS,
                                 lambda t: 2 * t * width * 4, sms)


def _check_width(width: int) -> None:
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in [1, 32], got {width}")


def _on_cpu(t: torch.Tensor, op: str) -> bool:
    """True for a CPU tensor, False for a CUDA one (read without building
    a ``torch.device``: at a KV leaf the wrapper's host time is most of a
    launch); raises for any other device."""
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"{op} takes a CPU or CUDA tensor, got {t.device}")
    return True


def pack(vals: torch.Tensor, width: int) -> torch.Tensor:
    """vals integer (n,), n % 32 == 0 -> int32 (n // 32, width), bit-identical
    to :func:`plain_pack`."""
    if vals.dim() != 1 or vals.shape[0] % GROUP:
        raise ValueError(f"pack needs a flat tensor with n % {GROUP} == 0, "
                         f"got shape {tuple(vals.shape)}")
    _check_width(width)
    if _on_cpu(vals, "pack"):
        return plain_pack(vals, width)
    vals = vals.contiguous()
    kind = _PACK_KINDS.get(vals.dtype)
    if kind is None:
        raise ValueError(f"pack takes {list(_PACK_KINDS)} on CUDA, got {vals.dtype}")
    n_g = vals.shape[0] // GROUP
    out = vals.new_empty((n_g, width), dtype=torch.int32)
    if n_g == 0:
        return out
    ptr = vals.data_ptr()
    kernels.require_aligned(ptr, "pack's values")
    geo = pack_geometry(n_g, width, vals.element_size(), kernels.sm_count(vals.get_device()))
    err = kernels.launcher("pack", _PACK_ARGTYPES)(
        ptr, out.data_ptr(), n_g, width, kind, geo.tile, geo.grid, geo.smem,
        kernels.stream_of(vals))
    if err:
        raise RuntimeError(f"pack launch failed: cudaError {err} ({geo})")
    kernels.count_launch("pack", (vals.dtype, n_g, width))
    return out


def unpack(packed: torch.Tensor, width: int) -> torch.Tensor:
    """packed int32 (n_g, width) -> int32 (32 * n_g,), bit-identical to
    :func:`plain_unpack` (the values' uint32 bits)."""
    if packed.dim() != 2 or packed.shape[1] < width:
        raise ValueError(f"unpack needs words (n_g, >= {width}), got shape "
                         f"{tuple(packed.shape)}")
    _check_width(width)
    if _on_cpu(packed, "unpack"):
        return plain_unpack(packed, width)
    packed = packed.contiguous()
    if packed.dtype != torch.int32:
        raise ValueError(f"unpack takes int32 words on CUDA, got {packed.dtype}")
    if packed.shape[1] != width:
        packed = packed[:, :width].contiguous()
    n_g = packed.shape[0]
    out = packed.new_empty((GROUP * n_g,))
    if n_g == 0:
        return out
    kernels.require_aligned(packed.data_ptr(), "unpack's packed words")
    geo = unpack_geometry(n_g, width, kernels.sm_count(packed.get_device()))
    err = kernels.launcher("unpack", _UNPACK_ARGTYPES)(
        packed.data_ptr(), out.data_ptr(), n_g, width, geo.tile, geo.grid, geo.smem,
        kernels.stream_of(packed))
    if err:
        raise RuntimeError(f"unpack launch failed: cudaError {err} ({geo})")
    kernels.count_launch("unpack", (n_g, width))
    return out
