"""Fused transmit-side encode: split + zero-escape stats + bit-plane pack.

Wrapper of the CUDA kernel ``csrc/encode_fused.cu``, the port of the TPU
kernel ``repro/kernels/encode_fused.py::_encode_kernel``.  A CUDA tensor
launches the kernel (or raises); a CPU tensor runs the plain version
``ref.encode_fused``.  The kernel's persistent thread blocks walk over
tiles of compression blocks; :func:`geometry` sizes them.  Any number of
whole blocks is taken; the input must start on a 16-byte boundary (the
kernel stages each tile by one bulk copy, which needs it), which the
wrapper checks and never fixes by a copy.  Each launch is also tallied under
its shape, ``(dtype, n, block, width)`` (``kernels.launch_shapes``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import kernels
from repro_torch.core import codec
from repro_torch.core.packing import GROUP
from repro_torch.kernels import ref

plain = ref.encode_fused

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)

# input bytes a tile aims at (one of two stages), and the tile's bounds in
# compression blocks; one warp a compression block, at most
# kernels.ENCODE_FUSED_THREADS threads
STAGE_BYTES = 8192
MIN_TILE, MAX_TILE = 4, 128
BARRIER_BYTES = 16  # two mbarriers, at the start of the shared memory


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Launch geometry of ``csrc/encode_fused.cu``: ``grid`` persistent
    thread blocks of ``threads`` threads walk over ``n_tiles`` tiles of
    ``tile`` compression blocks (thread block b takes tiles b, b + grid,
    ...); ``smem`` dynamic shared bytes a thread block (the mbarriers, two
    input stages, then the tile's payload, lo, bases and rng words)."""
    tile: int
    threads: int
    n_tiles: int
    grid: int
    smem: int


@functools.lru_cache(maxsize=1024)  # a pure function of ints, called a launch
def geometry(n_blocks: int, block: int, width: int, itemsize: int, lo_bits: int,
             sms: int) -> Geometry:
    """Tiles of a multiple of 4 blocks (so every tile's payload, lo and stats
    start on a 16-byte boundary) whose input fills about STAGE_BYTES; as
    many thread blocks as ``sms`` SMs hold at once, at most one a tile."""
    tile = min(MAX_TILE, max(MIN_TILE, STAGE_BYTES // (block * itemsize) // 4 * 4))
    threads = 32 * min(kernels.ENCODE_FUSED_THREADS // 32, tile)
    smem = (BARRIER_BYTES + 2 * tile * block * itemsize
            + 4 * tile * (block // GROUP * (width + lo_bits) + 2))
    n_tiles = -(-n_blocks // tile)
    grid = min(n_tiles, sms * kernels.resident_blocks(threads, smem))
    return Geometry(tile, threads, n_tiles, grid, smem)


def encode_fused(x: torch.Tensor, width: int, block: int = 512):
    """x float (n,), n % block == 0, block % 32 == 0 and <= 1024,
    1 <= width <= 32.  Returns (payload int32 (n//32, width), lo_planes
    int32 (n//32, lo_bits), bases int32 (n_blocks,), rng int32 (n_blocks,))
    bit-identical to :func:`plain`."""
    lay = codec.layout_of(x.dtype)
    n = x.shape[0] if x.dim() == 1 else -1
    if not 0 < n < 2**31 or n % block or block % GROUP or not GROUP <= block <= 1024:
        raise ValueError(f"encode_fused needs a flat tensor with 0 < n < 2**31, "
                         f"n % block == 0 and block a multiple of 32 <= 1024; "
                         f"got shape {tuple(x.shape)}, block={block}")
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in [1, 32], got {width}")
    if x.device.type == "cpu":
        return plain(x, width, block)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"encode_fused takes a contiguous CPU or CUDA tensor, "
                         f"got {x.device} contiguous={x.is_contiguous()}")
    kernels.require_aligned(x.data_ptr(), "encode_fused's input")
    n_g, nb = n // GROUP, n // block
    geo = geometry(nb, block, width, x.element_size(), lay.lo_bits,
                   kernels.sm_count(x.device))
    pay = torch.empty((n_g, width), dtype=torch.int32, device=x.device)
    lo = torch.empty((n_g, lay.lo_bits), dtype=torch.int32, device=x.device)
    bases = torch.empty((nb,), dtype=torch.int32, device=x.device)
    rng = torch.empty((nb,), dtype=torch.int32, device=x.device)
    launch = kernels.launcher("encode_fused", _ARGTYPES)
    err = launch(x.data_ptr(), pay.data_ptr(), lo.data_ptr(), bases.data_ptr(),
                 rng.data_ptr(), n, block, width, kernels.FORMATS.index(lay.name),
                 geo.tile, geo.grid, geo.threads, geo.smem, kernels.stream_of(x))
    if err:
        raise RuntimeError(f"encode_fused launch failed: cudaError {err} ({geo})")
    kernels.count_launch("encode_fused", (x.dtype, n, block, width))
    return pay, lo, bases, rng
