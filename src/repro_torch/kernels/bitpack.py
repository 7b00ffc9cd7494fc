"""Bit-plane pack and unpack (the wire codec's inner loop).

Wrappers of the CUDA kernels in ``csrc/bitpack.cu``, the port of the TPU
kernels ``repro/kernels/bitpack.py::_pack_kernel`` and ``::_unpack_kernel``.
A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version ``ref.pack`` / ``ref.unpack``.  Any whole number of 32-value groups
is taken (zero groups launch nothing); pack reads uint8, int32 and int64
values as they are, so no caller widens its values first.  The unpack
kernel's persistent thread blocks walk over tiles of groups
(:func:`unpack_geometry`); its packed words must start on a 16-byte boundary
(the kernel stages them by 16-byte copies), which the wrapper checks and
never fixes by a copy.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import kernels
from repro_torch.core.packing import GROUP
from repro_torch.kernels import ref

plain_pack = ref.pack
plain_unpack = ref.unpack

# input dtypes of the pack kernel, by the kind index of csrc/bitpack.cu
_PACK_KINDS = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}
_PACK_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_UNPACK_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong) + (
    ctypes.c_int,) * 4 + (ctypes.c_void_p,)

# csrc/bitpack.cu's unpack: threads a thread block (4 values each, so 32
# groups a pass), packed bytes a stage aims at, groups a tile at most
UNPACK_THREADS = kernels.UNPACK_THREADS
UNPACK_STAGE_BYTES = 16384
UNPACK_MAX_TILE = 256


@dataclasses.dataclass(frozen=True)
class UnpackGeometry:
    """Launch geometry of the unpack kernel: ``grid`` persistent thread
    blocks of UNPACK_THREADS walk over ``n_tiles`` tiles of ``tile``
    groups (thread block b takes tiles b, b + grid, ...); ``smem`` dynamic
    shared bytes a thread block (two stages of a tile's packed words)."""
    tile: int
    n_tiles: int
    grid: int
    smem: int


@functools.lru_cache(maxsize=1024)  # a pure function of ints, called a launch
def unpack_geometry(n_groups: int, width: int, sms: int) -> UnpackGeometry:
    """Tiles of a multiple of 32 groups (one pass of the thread block; so
    every tile's words start on a 16-byte boundary) whose words fill at
    most UNPACK_STAGE_BYTES, and small enough that each of the thread
    blocks the card holds at once gets two tiles or more where there are
    groups enough (so its next tile's copy overlaps this one's stores); as
    many thread blocks as ``sms`` SMs hold at once, at most one a tile."""
    tile = min(UNPACK_MAX_TILE, UNPACK_STAGE_BYTES // (4 * width) // GROUP * GROUP)
    full = sms * kernels.resident_blocks(UNPACK_THREADS, 2 * tile * width * 4)
    tile = max(GROUP, min(tile, n_groups // (2 * full) // GROUP * GROUP))
    smem = 2 * tile * width * 4
    n_tiles = -(-n_groups // tile)
    grid = min(n_tiles, sms * kernels.resident_blocks(UNPACK_THREADS, smem))
    return UnpackGeometry(tile, n_tiles, grid, smem)


def _check_width(width: int) -> None:
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in [1, 32], got {width}")


def _on_cuda(t: torch.Tensor, op: str) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"{op} takes a CPU or CUDA tensor, got {t.device}")
    return t.contiguous()


def pack(vals: torch.Tensor, width: int) -> torch.Tensor:
    """vals integer (n,), n % 32 == 0 -> int32 (n // 32, width), bit-identical
    to :func:`plain_pack`."""
    if vals.dim() != 1 or vals.shape[0] % GROUP:
        raise ValueError(f"pack needs a flat tensor with n % {GROUP} == 0, "
                         f"got shape {tuple(vals.shape)}")
    _check_width(width)
    if vals.device.type == "cpu":
        return plain_pack(vals, width)
    vals = _on_cuda(vals, "pack")
    if vals.dtype not in _PACK_KINDS:
        raise ValueError(f"pack takes {list(_PACK_KINDS)} on CUDA, got {vals.dtype}")
    n_g = vals.shape[0] // GROUP
    out = torch.empty((n_g, width), dtype=torch.int32, device=vals.device)
    if n_g == 0:
        return out
    err = kernels.launcher("pack", _PACK_ARGTYPES)(
        vals.data_ptr(), out.data_ptr(), n_g, width, _PACK_KINDS[vals.dtype],
        kernels.stream_of(vals))
    if err:
        raise RuntimeError(f"pack launch failed: cudaError {err}")
    kernels.count_launch("pack")
    return out


def unpack(packed: torch.Tensor, width: int) -> torch.Tensor:
    """packed int32 (n_g, width) -> int32 (32 * n_g,), bit-identical to
    :func:`plain_unpack` (the values' uint32 bits)."""
    if packed.dim() != 2 or packed.shape[1] < width:
        raise ValueError(f"unpack needs words (n_g, >= {width}), got shape "
                         f"{tuple(packed.shape)}")
    _check_width(width)
    if packed.device.type == "cpu":
        return plain_unpack(packed, width)
    packed = _on_cuda(packed, "unpack")
    if packed.dtype != torch.int32:
        raise ValueError(f"unpack takes int32 words on CUDA, got {packed.dtype}")
    if packed.shape[1] != width:
        packed = packed[:, :width].contiguous()
    n_g = packed.shape[0]
    out = torch.empty((GROUP * n_g,), dtype=torch.int32, device=packed.device)
    if n_g == 0:
        return out
    kernels.require_aligned(packed.data_ptr(), "unpack's packed words")
    geo = unpack_geometry(n_g, width, kernels.sm_count(packed.device))
    err = kernels.launcher("unpack", _UNPACK_ARGTYPES)(
        packed.data_ptr(), out.data_ptr(), n_g, width, geo.tile, geo.grid, geo.smem,
        kernels.stream_of(packed))
    if err:
        raise RuntimeError(f"unpack launch failed: cudaError {err} ({geo})")
    kernels.count_launch("unpack")
    return out
