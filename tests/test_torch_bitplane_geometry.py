"""Launch geometry of the persistent bit-plane kernels, checked on the CPU
(``kernels/encode_fused.py::geometry``, ``kernels/bitpack.py::unpack_geometry``):

* the tiles cover every compression block (or group) exactly once, walked
  as the kernels walk them (thread block b takes tiles b, b + grid, ...),
  and no thread block is idle;
* shared memory stays within a thread block's 227 KB and the resident
  thread blocks within an SM's 228 KB;
* every copy between device and shared memory that is made of 16-byte
  pieces starts and, but for the last tile's tail, ends on a 16-byte
  boundary;
* a pointer off a 16-byte boundary is refused;
* the thread counts the geometry shares with ``csrc/`` have one owner:
  nvcc gets them from Python as -D defines.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import codec
from repro_torch.kernels import bitpack, encode_fused

SMS = 132  # an H100 SXM
CSRC = Path(kernels.__file__).resolve().parent / "csrc"


def _walk(n_items: int, tile: int, n_tiles: int, grid: int) -> np.ndarray:
    """How often each item is visited by the kernels' tile loop; asserts
    that every thread block takes one tile or more."""
    seen = np.zeros(n_items, np.int64)
    for b in range(grid):
        tiles = range(b, n_tiles, grid)
        assert len(tiles) >= 1
        for t in tiles:
            seen[t * tile:min((t + 1) * tile, n_items)] += 1
    return seen


def _resident_fit(threads: int, smem: int) -> None:
    assert smem <= kernels.SMEM_PER_BLOCK
    per_sm = kernels.resident_blocks(threads, smem)
    assert per_sm >= 1
    unit = kernels.SMEM_UNIT
    assert per_sm * (-(-(smem + kernels.SMEM_RESERVED) // unit) * unit) <= kernels.SMEM_PER_SM
    assert per_sm * threads <= kernels.THREADS_PER_SM


@pytest.mark.parametrize("block", [32, 512, 1024])
@pytest.mark.parametrize("fmt", list(codec.LAYOUTS))
def test_encode_fused_geometry(fmt, block):
    lay = codec.LAYOUTS[fmt]
    isz = lay.total_bits // 8
    gpb = block // 32
    for width in range(1, 33):
        one = encode_fused.geometry(1, block, width, isz, lay.lo_bits, SMS)
        tile, threads = one.tile, one.threads
        assert tile % 4 == 0 and threads % 32 == 0 and 32 <= threads <= 256
        _resident_fit(threads, one.smem)
        full = SMS * kernels.resident_blocks(threads, one.smem)
        # shared sections: mbarriers, two input stages, payload, lo, bases, rng
        sections = [encode_fused.BARRIER_BYTES] + [tile * block * isz] * 2 + [
            tile * gpb * width * 4, tile * gpb * lay.lo_bits * 4, tile * 4, tile * 4]
        assert sum(sections) == one.smem and all(s % 16 == 0 for s in sections)
        for nb in (1, 2, 3, tile - 1, tile, tile + 1, 7 * tile + 3, full * tile,
                   full * tile + 1, 2 * full * tile + 5):
            geo = encode_fused.geometry(nb, block, width, isz, lay.lo_bits, SMS)
            assert (geo.tile, geo.threads, geo.smem) == (tile, threads, one.smem)
            assert geo.n_tiles == -(-nb // tile) and geo.grid == min(geo.n_tiles, full)
            assert (_walk(nb, tile, geo.n_tiles, geo.grid) == 1).all()
            for t in range(geo.n_tiles):
                b0, cnt = t * tile, min(tile, nb - t * tile)
                # input: one bulk copy, offset and size in 16 bytes
                assert (b0 * block * isz) % 16 == 0 and (cnt * block * isz) % 16 == 0
                # outputs (words): payload, lo, bases, rng start on 16 bytes;
                # all but the last tile's ranges are whole 16-byte stores
                for per_block in (gpb * width, gpb * lay.lo_bits, 1):
                    assert (b0 * per_block * 4) % 16 == 0
                    if t < geo.n_tiles - 1:
                        assert (cnt * per_block * 4) % 16 == 0


@pytest.mark.parametrize("width", range(1, 33))
def test_unpack_geometry(width):
    big = bitpack.unpack_geometry(1 << 40, width, SMS)
    t_max = big.tile
    assert t_max % 32 == 0 and 32 <= t_max <= bitpack.UNPACK_MAX_TILE
    assert t_max * width * 4 <= bitpack.UNPACK_STAGE_BYTES
    _resident_fit(bitpack.UNPACK_THREADS, big.smem)
    full = SMS * kernels.resident_blocks(bitpack.UNPACK_THREADS, big.smem)
    last = 0
    for n_g in (1, 2, 31, 32, 33, 1000, 2 * full * 32 - 1, 2 * full * 64, 2 * full * t_max - 1,
                2 * full * t_max, 2 * full * t_max + 1, (2 * full + 1) * t_max + 1,
                3 * full * t_max + 17):
        geo = bitpack.unpack_geometry(n_g, width, SMS)
        tile = geo.tile
        # tiles of 32 groups up to T_max, two or more a resident thread block
        # where the groups allow, never shrinking as the count grows
        assert tile % 32 == 0 and 32 <= tile <= t_max and tile >= last
        assert tile == t_max or tile == 32 or -(-n_g // tile) >= 2 * full
        last = tile
        assert geo.smem == 2 * tile * width * 4
        _resident_fit(bitpack.UNPACK_THREADS, geo.smem)
        assert geo.n_tiles == -(-n_g // tile)
        assert geo.grid == min(geo.n_tiles, SMS * kernels.resident_blocks(
            bitpack.UNPACK_THREADS, geo.smem))
        assert (_walk(n_g, tile, geo.n_tiles, geo.grid) == 1).all()
        for t in range(geo.n_tiles):
            g0, cnt = t * tile, min(tile, n_g - t * tile)
            assert (g0 * width * 4) % 16 == 0  # the tile's packed words
            if t < geo.n_tiles - 1:
                assert (cnt * width * 4) % 16 == 0
            assert (g0 * 32 * 4) % 16 == 0  # its values: 16-byte stores


def test_main_path_geometry():
    """The all-gather bucket (bf16, n = 134 515 200, block 512, width 5) and
    its payload and lo plane on an H100: 8 resident thread blocks an SM."""
    n = 134_515_200
    geo = encode_fused.geometry(n // 512, 512, 5, 2, 8, SMS)
    assert (geo.tile, geo.threads, geo.grid) == (8, 256, 8 * SMS)
    assert geo.smem == 16 + 2 * 8 * 1024 + 8 * 16 * 13 * 4 + 64
    for width in (5, 8):
        g = bitpack.unpack_geometry(n // 32, width, SMS)
        assert (g.tile, g.grid) == (256, 8 * SMS)


def test_misaligned_pointers_are_refused():
    t = torch.zeros(64, dtype=torch.int32)
    kernels.require_aligned(t.data_ptr() - t.data_ptr() % 16, "x")
    for off in range(1, 16):
        with pytest.raises(ValueError, match="16-byte"):
            kernels.require_aligned(16 * 1000 + off, "x")
    assert t.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="16-byte"):
        kernels.require_aligned(t[1:].data_ptr(), "unpack's packed words")
    kernels.require_aligned(t[4:].data_ptr(), "unpack's packed words")


def test_constants_match_the_sources():
    """Threads a thread block and an SM are Python's: nvcc gets them as -D
    defines, and the sources hold no copy and refuse to build without."""
    flags = set(kernels.NVCC_FLAGS)
    assert f"-DENCODE_FUSED_THREADS={kernels.ENCODE_FUSED_THREADS}" in flags
    assert f"-DUNPACK_THREADS={kernels.UNPACK_THREADS}" in flags
    assert f"-DSM_THREADS={kernels.THREADS_PER_SM}" in flags
    assert bitpack.UNPACK_THREADS == kernels.UNPACK_THREADS
    for src, macros in (("encode_fused.cu", ("ENCODE_FUSED_THREADS", "SM_THREADS")),
                        ("bitpack.cu", ("UNPACK_THREADS", "SM_THREADS"))):
        text = (CSRC / src).read_text()
        for m in macros:
            assert f"!defined({m})" in text
            assert not re.search(rf"(#define|constexpr int)\s+{m}\b", text)
