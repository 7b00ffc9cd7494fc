"""Launch geometry of the persistent bit-plane kernels, checked on the CPU
(``kernels/encode_fused.py::geometry``, ``kernels/bitpack.py::pack_geometry``
and ``::unpack_geometry``, ``kernels/decode_reduce.py::geometry``):

* the tiles cover every compression block (or group) exactly once, walked
  as the kernels walk them (thread block b takes tiles b, b + grid, ...),
  and no thread block is idle;
* shared memory stays within a thread block's 227 KB and the resident
  thread blocks within an SM's 228 KB;
* every copy between device and shared memory that is made of 16-byte
  pieces starts and, but for the last tile's tail, ends on a 16-byte
  boundary;
* a pointer off a 16-byte boundary is refused, and the entry points'
  helper hands over an aligned copy of a view off one;
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
from repro_torch.kernels import bitpack, decode_reduce, encode_fused

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


def _tile_counts(t_max: int, full: int) -> tuple:
    """Group counts at the edges of the small-tile rule (tiles of 32 until
    each of ``full`` resident thread blocks gets two) and of the largest
    tile ``t_max``, and past the grid."""
    return sorted({1, 2, 31, 32, 33, 1000, 2 * full * 32 - 1, 2 * full * 64,
                   2 * full * t_max - 1, 2 * full * t_max, 2 * full * t_max + 1,
                   (2 * full + 1) * t_max + 1, 3 * full * t_max + 17})


def _check_tiles(n_g: int, geo, threads: int, ranges: dict, t_max: int, full: int,
                 last: int) -> int:
    """The checks every persistent bit-plane kernel's geometry shares: tiles
    of 32 groups up to ``t_max``, two or more for each of the ``full``
    thread blocks resident at ``t_max`` where the groups allow, never
    shrinking as the count grows; each group covered once; the grid no
    larger than the resident blocks; each of ``ranges`` (bytes a group of
    each staged range) starting every tile on a 16-byte boundary and, but
    for the last tile, ending on one."""
    tile = geo.tile
    assert tile % 32 == 0 and 32 <= tile <= t_max and tile >= last
    assert tile == t_max or tile == 32 or -(-n_g // tile) >= 2 * full
    _resident_fit(threads, geo.smem)
    assert geo.n_tiles == -(-n_g // tile)
    assert geo.grid == min(geo.n_tiles, SMS * kernels.resident_blocks(threads, geo.smem))
    assert (_walk(n_g, tile, geo.n_tiles, geo.grid) == 1).all()
    for t in range(geo.n_tiles):
        g0, cnt = t * tile, min(tile, n_g - t * tile)
        for name, per_group in ranges.items():
            assert (g0 * per_group) % 16 == 0, name
            if t < geo.n_tiles - 1:
                assert (cnt * per_group) % 16 == 0, name
    return tile


@pytest.mark.parametrize("itemsize", [1, 4, 8])
@pytest.mark.parametrize("width", [1, 2, 5, 6, 8, 9, 17, 31, 32])
def test_pack_geometry(width, itemsize):
    """Tiles whose values fill at most PACK_STAGE_BYTES; shared bytes: two
    stages of values, then the tile's words; every tile's values are whole
    16-byte pieces, and its words and the values it stores start on a
    16-byte boundary."""
    big = bitpack.pack_geometry(1 << 40, width, itemsize, SMS)
    t_max = big.tile
    assert t_max <= bitpack.PACK_MAX_TILE
    assert t_max * 32 * itemsize <= max(bitpack.PACK_STAGE_BYTES, 32 * 32 * itemsize)
    full = SMS * kernels.resident_blocks(bitpack.PACK_THREADS, big.smem)
    last = 0
    for n_g in _tile_counts(t_max, full):
        geo = bitpack.pack_geometry(n_g, width, itemsize, SMS)
        assert geo.smem == 2 * geo.tile * 32 * itemsize + geo.tile * width * 4
        assert (2 * geo.tile * 32 * itemsize) % 16 == 0  # the words' section
        last = _check_tiles(n_g, geo, bitpack.PACK_THREADS,
                            {"values": 32 * itemsize, "words": width * 4}, t_max, full, last)
        # the values of any tile, the last one too, are whole 16-byte pieces
        assert (min(geo.tile, n_g - (geo.n_tiles - 1) * geo.tile) * 32 * itemsize) % 16 == 0


@pytest.mark.parametrize("fmt", list(codec.LAYOUTS))
@pytest.mark.parametrize("width", [1, 2, 5, 8, 9, 31, 32])
def test_decode_reduce_geometry(fmt, width):
    """Tiles of at most DECODE_REDUCE_MAX_TILE groups (the accumulator a
    thread holds in registers); shared bytes: two stages of the tile's
    payload, lo words and group bases, each section on a 16-byte boundary;
    each range and the float4 accumulator start every tile on one."""
    lo_bits = codec.LAYOUTS[fmt].lo_bits
    big = decode_reduce.geometry(1 << 40, width, lo_bits, SMS)
    t_max = big.tile
    assert t_max == decode_reduce.MAX_TILE == kernels.DECODE_REDUCE_MAX_TILE
    full = SMS * kernels.resident_blocks(decode_reduce.THREADS, big.smem)
    last = 0
    for n_g in _tile_counts(t_max, full):
        geo = decode_reduce.geometry(n_g, width, lo_bits, SMS)
        sections = [geo.tile * width * 4, geo.tile * lo_bits * 4, geo.tile * 4] * 2
        assert sum(sections) == geo.smem and all(s % 16 == 0 for s in sections)
        last = _check_tiles(n_g, geo, decode_reduce.THREADS,
                            {"payload": width * 4, "lo": lo_bits * 4, "bases": 4,
                             "acc": 32 * 4}, t_max, full, last)


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
    g = decode_reduce.geometry(n // 32, 5, 8, SMS)
    assert (g.tile, g.grid, g.smem) == (64, 8 * SMS, 2 * 64 * 14 * 4)
    # weight sync's delta packs: uint8 residuals at width 5, int32 lo at 6
    g = bitpack.pack_geometry(n // 32, 5, 1, SMS)
    assert (g.tile, g.grid) == (256, 8 * SMS)
    g = bitpack.pack_geometry(n // 32, 6, 4, SMS)
    assert (g.tile, g.grid) == (64, 8 * SMS)


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


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16, torch.int32, torch.float32])
def test_aligned_copies_only_a_view_off_a_boundary(dtype):
    """The entry points' helper copies only a CUDA view off a 16-byte
    boundary (only a CUDA kernel stages by 16-byte copies;
    ``tests/test_torch_gpu.py::test_aligned_copies_a_cuda_view_off_a_boundary``
    holds the copy on the card): on the CPU every tensor, aligned or a view
    one element or 8 bytes off a boundary, 1-d or 2-d, comes back as
    itself."""
    base = torch.arange(96, dtype=torch.int64).to(dtype)
    assert base.data_ptr() % 16 == 0
    assert kernels.aligned(base) is base
    whole = base[16 // base.element_size():]
    assert kernels.aligned(whole) is whole
    for off in sorted({1, 8 // base.element_size()}):
        view = base[off:off + 64]
        assert view.data_ptr() % 16
        assert kernels.aligned(view) is view
    rows = base[2:66].view(8, 8)
    assert kernels.aligned(rows) is rows


def test_constants_match_the_sources():
    """Threads a thread block and an SM are Python's: nvcc gets them as -D
    defines, and the sources hold no copy and refuse to build without."""
    flags = set(kernels.NVCC_FLAGS)
    assert f"-DENCODE_FUSED_THREADS={kernels.ENCODE_FUSED_THREADS}" in flags
    assert f"-DUNPACK_THREADS={kernels.UNPACK_THREADS}" in flags
    assert f"-DPACK_THREADS={kernels.PACK_THREADS}" in flags
    assert f"-DDECODE_REDUCE_THREADS={kernels.DECODE_REDUCE_THREADS}" in flags
    assert f"-DDECODE_REDUCE_MAX_TILE={kernels.DECODE_REDUCE_MAX_TILE}" in flags
    assert f"-DSM_THREADS={kernels.THREADS_PER_SM}" in flags
    assert bitpack.UNPACK_THREADS == kernels.UNPACK_THREADS
    assert bitpack.PACK_THREADS == kernels.PACK_THREADS
    assert decode_reduce.THREADS == kernels.DECODE_REDUCE_THREADS
    for src, macros in (("encode_fused.cu", ("ENCODE_FUSED_THREADS", "SM_THREADS")),
                        ("bitpack.cu", ("PACK_THREADS", "UNPACK_THREADS", "SM_THREADS")),
                        ("decode_reduce.cu", ("DECODE_REDUCE_THREADS",
                                              "DECODE_REDUCE_MAX_TILE", "SM_THREADS"))):
        text = (CSRC / src).read_text()
        for m in macros:
            assert f"!defined({m})" in text
            assert not re.search(rf"(#define|constexpr int)\s+{m}\b", text)
