"""The port's CUDA kernels on the card, held bit for bit against their plain
PyTorch versions (NaN matched as NaN for the f32 accumulate), and the
weight-sync delta wire on the card.  Imports
torch and the port only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test here needs a CUDA GPU and skips elsewhere.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import ans, codec
from repro_torch.core import compressed_collectives as cc
from repro_torch.core import packing
from repro_torch.kernels import bitpack, decode_reduce, encode_fused, plane_split, rans, ref
from repro_torch.p2p.engine import Compressor
from torch_port_util import FORMATS, grad_like_bits, to_torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the kernels' tile-edge cases)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (on the card: python3 chip_smoke.py)")
    return torch.device("cuda")


def _same_f32(a, b) -> bool:
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("fmt", FORMATS)
def test_cuda_kernels_match_plain_versions(cuda, fmt):
    x = to_torch(grad_like_bits(fmt, 512 * 33, seed=14), fmt).to(cuda)
    before = kernels.launch_counts()
    for width in (2, 5, 8):
        got = encode_fused.encode_fused(x, width, 512)
        want = ref.encode_fused(x, width, 512)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (fmt, width)
        gb = got[2].repeat_interleave(16)
        acc = torch.randn(x.shape[0], device=cuda,
                          generator=torch.Generator(cuda).manual_seed(width))
        a = decode_reduce.decode_reduce(got[0], got[1], gb, acc.clone(), fmt, width)
        b = ref.decode_reduce(got[0], got[1], gb, acc, fmt, width)
        assert _same_f32(a, b), (fmt, width)
    after = kernels.launch_counts()
    assert after["encode_fused"] - before["encode_fused"] == 3
    assert after["decode_reduce"] - before["decode_reduce"] == 3


@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "float8_e5m2"])
def test_chunk_codec_on_the_card_equals_the_cpu(cuda, fmt):
    """The collectives' encode and fused decode+reduce (with the exception
    patch-up) give the same wire and sums on the card as on the CPU."""
    x = to_torch(grad_like_bits(fmt, 3 * 512 * 8, seed=16), fmt).reshape(3, -1)
    kw = {"width": 5, "block": 512}
    wire = cc._encode_chunks(x, exc_frac=0.02, **kw)
    gwire = cc._encode_chunks(x.to(cuda), exc_frac=0.02, **kw)
    for k in wire:
        assert torch.equal(gwire[k].cpu(), wire[k]), k
    got, _ = cc._decode_reduce_chunks(gwire, dtype=x.dtype, n=x.shape[1], **kw)
    want, _ = cc._decode_reduce_chunks(wire, dtype=x.dtype, n=x.shape[1], **kw)
    assert _same_f32(got.cpu(), want)


def test_bitpack_kernels_match_plain_versions(cuda):
    """Widths 1-32, ragged group counts, all-zero and all-ones groups,
    int32 values with the sign bit set, uint8 and int64 inputs."""
    rng = np.random.default_rng(17)
    before = kernels.launch_counts()
    launches = 0
    for n_g in (1, 37, 4099):
        vals = rng.integers(0, 1 << 32, 32 * n_g, dtype=np.uint64)
        vals[:32], vals[-32:] = 0, 0xFFFFFFFF
        for dtype, npt in ((torch.int32, np.int32), (torch.int64, np.int64),
                           (torch.uint8, np.uint8)):
            src = vals.astype(np.uint32).view(np.int32) if dtype == torch.int32 else (
                vals.astype(np.int64) if dtype == torch.int64 else vals.astype(np.uint8))
            t = torch.from_numpy(src.astype(npt)).to(cuda)
            for width in range(1, 33):
                got = bitpack.pack(t, width)
                assert torch.equal(got, ref.pack(t, width)), (n_g, dtype, width)
                back = bitpack.unpack(got, width)
                assert torch.equal(back, ref.unpack(got, width)), (n_g, dtype, width)
                launches += 2
    assert bitpack.pack(torch.zeros(0, dtype=torch.int32, device=cuda), 3).shape == (0, 3)
    after = kernels.launch_counts()
    assert after["pack"] - before["pack"] == launches // 2
    assert after["unpack"] - before["unpack"] == launches // 2


@pytest.mark.parametrize("block", chip_smoke.EDGE_BLOCKS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_encode_fused_at_tile_edges(cuda, fmt, block):
    """Both template routes (widths 1-8 and the generic 9-32) at block
    counts 1, T - 1, T, T + 1 and (grid + 1) T + 1 of the persistent
    kernel's geometry (``chip_smoke.edge_counts``, on ``edge_input``'s
    all-zero, one-exponent and exception blocks); the unpack of both planes
    beside it."""
    lay = codec.LAYOUTS[fmt]
    sms = kernels.sm_count(cuda)
    geos = {w: encode_fused.geometry(1, block, w, lay.total_bits // 8, lay.lo_bits, sms)
            for w in chip_smoke.EDGE_WIDTHS}
    counts = {w: chip_smoke.edge_counts(g.tile, sms * kernels.resident_blocks(g.threads, g.smem))
              for w, g in geos.items()}
    nb_max = max(max(c) for c in counts.values())
    x_all = chip_smoke.edge_input(lay, nb_max, block, 31, torch, np).to(cuda)
    before = kernels.launch_counts()
    cases = 0
    for width in chip_smoke.EDGE_WIDTHS:
        for nb in counts[width]:
            x = x_all[:nb * block]
            got = encode_fused.encode_fused(x, width, block)
            for g, w in zip(got, ref.encode_fused(x, width, block)):
                assert torch.equal(g, w), (width, nb, geos[width])
            for words, w in ((got[0], width), (got[1], lay.lo_bits)):
                assert torch.equal(bitpack.unpack(words, w), ref.unpack(words, w)), (w, nb)
            cases += 1
    after = kernels.launch_counts()
    assert after["encode_fused"] - before["encode_fused"] == cases
    assert after["unpack"] - before["unpack"] == 2 * cases


@pytest.mark.parametrize("width", range(1, 33))
def test_unpack_at_tile_edges(cuda, width):
    """Group counts at the edges of the unpack kernel's tiles and past its
    persistent grid (``chip_smoke.unpack_edge_counts``), random words with
    all-zero and all-ones groups."""
    counts = chip_smoke.unpack_edge_counts(width, kernels.sm_count(cuda))
    rng = np.random.default_rng(40 + width)
    words_all = torch.from_numpy(rng.integers(0, 1 << 32, max(counts) * width,
                                              dtype=np.uint64).astype(np.uint32)
                                 .view(np.int32)).to(cuda)
    before = kernels.launch_counts()["unpack"]
    for n_g in counts:
        words = words_all[:n_g * width].view(n_g, width)
        if n_g > 2:
            words[1], words[2] = 0, -1
        assert torch.equal(bitpack.unpack(words, width), ref.unpack(words, width)), n_g
    assert kernels.launch_counts()["unpack"] - before == len(counts)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16, torch.int32, torch.float32])
def test_aligned_copies_a_cuda_view_off_a_boundary(cuda, dtype):
    """``kernels.aligned`` on the card: a view one element or 8 bytes off a
    16-byte boundary comes back as an aligned contiguous copy with the same
    values (a 2-d view keeps its shape); an aligned tensor as itself."""
    base = torch.arange(96, dtype=torch.int64, device=cuda).to(dtype)
    assert base.data_ptr() % 16 == 0 and kernels.aligned(base) is base
    whole = base[16 // base.element_size():]
    assert kernels.aligned(whole) is whole
    for off in sorted({1, 8 // base.element_size()}):
        view = base[off:off + 64]
        got = kernels.aligned(view)
        assert view.data_ptr() % 16 and got.data_ptr() % 16 == 0 and got.is_contiguous()
        assert got.data_ptr() != view.data_ptr() and torch.equal(got, view)
    rows = base[2:66].view(8, 8)
    got = kernels.aligned(rows)
    assert got.shape == (8, 8) and torch.equal(got, rows) and got.data_ptr() % 16 == 0


def test_misaligned_inputs_raise(cuda):
    """encode_fused, unpack, pack and decode_reduce stage their input by
    16-byte copies: a view off a 16-byte boundary raises and launches
    nothing, never a copy (decode_reduce: any of its four tensors)."""
    x = torch.zeros(2048 + 8, dtype=torch.bfloat16, device=cuda)
    words = torch.zeros(64 * 5 + 4, dtype=torch.int32, device=cuda)
    vals = torch.zeros(2048 + 16, dtype=torch.uint8, device=cuda)
    lo = torch.zeros(64 * 8 + 4, dtype=torch.int32, device=cuda)
    gb = torch.ones(64 + 4, dtype=torch.int32, device=cuda)
    acc = torch.zeros(2048 + 4, dtype=torch.float32, device=cuda)
    dr_args = (words[4:324].view(64, 5), lo[4:516].view(64, 8), gb[4:68], acc[4:2052])
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        encode_fused.encode_fused(x[1:2049], 5, 512)
    with pytest.raises(ValueError, match="16-byte"):
        bitpack.unpack(words[1:321].view(64, 5), 5)
    with pytest.raises(ValueError, match="16-byte"):
        bitpack.pack(vals[1:2049], 5)
    with pytest.raises(ValueError, match="16-byte"):
        bitpack.pack(words[2:322], 5)  # 8 bytes off
    for i, off in ((0, words[1:321].view(64, 5)), (1, lo[2:514].view(64, 8)),
                   (2, gb[1:65]), (3, acc[2:2050])):
        args = list(dr_args)
        args[i] = off
        with pytest.raises(ValueError, match="16-byte"):
            decode_reduce.decode_reduce(*args, "bfloat16", 5)
    assert kernels.launch_counts() == before
    assert encode_fused.encode_fused(x[8:2056], 5, 512)[0].shape == (64, 5)  # 16 B in
    assert bitpack.unpack(words[4:324].view(64, 5), 5).shape == (2048,)
    assert bitpack.pack(vals[16:2064], 5).shape == (64, 5)
    assert decode_reduce.decode_reduce(*dr_args, "bfloat16", 5) is dr_args[3]


def test_entry_points_take_offset_views(cuda):
    """ops.encode_fused, packing.encode_message, packing.bitplane_unpack,
    packing.bitplane_pack and ops.decode_reduce on views one element and 8
    bytes off a 16-byte boundary (every tensor argument): bit-identical to
    the plain versions, one launch a call (``chip_smoke.check_offset_views``)."""
    assert chip_smoke.check_offset_views(cuda, torch, np) == 12


def test_stream_of_is_the_current_stream(cuda):
    """The wrappers launch on PyTorch's current stream, a side stream too."""
    t = torch.zeros(1, device=cuda)
    assert kernels.stream_of(t) == torch.cuda.current_stream(cuda).cuda_stream
    side = torch.cuda.Stream(device=cuda)
    with torch.cuda.stream(side):
        assert kernels.stream_of(t) == side.cuda_stream != torch.cuda.default_stream(
            cuda).cuda_stream


def test_pack_tallies_its_launches_by_shape(cuda):
    """Each pack launch is tallied under (dtype, groups, width), which
    chip_smoke.py reads for the launches of each pack shape."""
    kernels.clear_launch_counts()
    vals = torch.ones(2048, dtype=torch.uint8, device=cuda)
    packing.bitplane_pack(vals, 5)
    packing.bitplane_pack(vals, 5)
    packing.bitplane_pack(vals.to(torch.int32)[:1024], 8)
    assert kernels.launch_shapes("pack") == {(torch.uint8, 64, 5): 2, (torch.int32, 32, 8): 1}
    assert kernels.launch_counts()["pack"] == 3


@pytest.mark.parametrize("width", chip_smoke.EDGE_WIDTHS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_reduce_at_tile_edges(cuda, fmt, width):
    """Group counts at the edges of the persistent decode_reduce kernel's
    tiles and past its grid (``chip_smoke.decode_reduce_edge_counts``), on
    ``edge_input`` encoded in blocks of 32 (exception groups' garbage codes),
    into an accumulator with subnormals, +-0, +-inf and NaN."""
    lay = codec.LAYOUTS[fmt]
    counts = chip_smoke.decode_reduce_edge_counts(width, lay.lo_bits, kernels.sm_count(cuda))
    x = chip_smoke.edge_input(lay, max(counts), 32, 41, torch, np).to(cuda)
    pay_all, lo_all, gb_all, _ = ref.encode_fused(x, width, 32)
    acc_all = chip_smoke.special_acc(x.shape[0], 42, torch, np).to(cuda)
    before = kernels.launch_counts()["decode_reduce"]
    for n_g in counts:
        args = (pay_all[:n_g], lo_all[:n_g], gb_all[:n_g])
        acc = acc_all[:32 * n_g]
        got = decode_reduce.decode_reduce(*args, acc.clone(), fmt, width)
        assert _same_f32(got, ref.decode_reduce(*args, acc, fmt, width)), n_g
    assert kernels.launch_counts()["decode_reduce"] - before == len(counts)


@pytest.mark.parametrize("width", range(1, 33))
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64])
def test_pack_at_tile_edges(cuda, dtype, width):
    """Group counts at the edges of the persistent pack kernel's tiles and
    past its grid (``chip_smoke.pack_edge_counts``): uint8, int32 with the
    sign bit set and int64 above 2**32, all-zero and all-ones groups."""
    counts = chip_smoke.pack_edge_counts(width, dtype.itemsize, kernels.sm_count(cuda))
    vals_all = chip_smoke.pack_edge_values(32 * max(counts), 43, torch, np)[dtype].to(cuda)
    before = kernels.launch_counts()["pack"]
    for n_g in counts:
        vals = vals_all[:32 * n_g]
        assert torch.equal(bitpack.pack(vals, width), ref.pack(vals, width)), n_g
    assert kernels.launch_counts()["pack"] - before == len(counts)


@pytest.mark.parametrize("per,lanes", [(1, 128), (rans.ROWS - 1, 128), (rans.ROWS, 128),
                                       (rans.ROWS + 1, 128), (3 * rans.ROWS + 17, 128),
                                       (rans.ROWS + 1, 256)])
def test_rans_kernels_match_plain_versions(cuda, per, lanes):
    """Skewed, uniform and one-symbol streams, a table whose top frequency
    is M - 255, n_valid < per * lanes, and the compacted-stream decode of an
    ``ans.encode`` stream, on both sides of the kernels' tile edges (``ROWS``
    rows, which the dense decode splits into tiles of ``ROWS / 4``) and
    over two thread blocks (256 lanes)."""
    rng = np.random.default_rng(18 + per)
    n = per * lanes
    streams = {"skewed": np.clip(rng.normal(120, 2.5, n), 0, 255),
               "uniform": rng.integers(0, 256, n),
               "single": np.full(n, 7)}
    top = np.ones(256, np.int64)
    top[7] = ans.M - 255
    before = kernels.launch_counts()
    launches = 0
    for name, s in streams.items():
        syms = torch.from_numpy(s.astype(np.uint8)).reshape(per, lanes).to(cuda)
        tables = [ans.build_freq_table(syms)]
        if name == "single":
            tables.append(ans.table_from_freq(torch.from_numpy(top).to(cuda)))
        for t in tables:
            s2s = ans._slot_to_symbol(t)
            for n_valid in (n, n - 77):
                got = rans.encode(syms, t.freq, t.cum, n_valid)
                want = ref.rans_encode(syms, t.freq, t.cum, n_valid)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (name, n_valid)
                dec = rans.decode(got[0], got[2], t.freq, t.cum, s2s, n_valid)
                assert torch.equal(dec, ref.rans_decode(got[0], got[2], t.freq, t.cum,
                                                        s2s, n_valid)), (name, n_valid)
                assert torch.equal(dec.reshape(-1)[:n_valid],
                                   syms.reshape(-1)[:n_valid]), (name, n_valid)
                launches += 1
        flat = syms.reshape(-1)[: n - 77]
        stream = ans.encode(flat, tables[0], lanes=lanes)
        cpu = ans.encode(flat.cpu(), tables[0], lanes=lanes)  # the table moves to the CPU
        assert torch.equal(stream.words.cpu().view(torch.int16), cpu.words.view(torch.int16))
        assert torch.equal(stream.lens.cpu(), cpu.lens)
        s2s = ans._slot_to_symbol(tables[0])
        got = rans.decode_stream(stream.words, stream.lens, tables[0].freq,
                                 tables[0].cum, s2s, per, flat.shape[0])
        want = ref.rans_decode_stream(stream.words, stream.lens, tables[0].freq,
                                      tables[0].cum, s2s, per, flat.shape[0])
        assert torch.equal(got, want), name
        assert torch.equal(ans.decode(stream), flat), name
        launches += 1
    after = kernels.launch_counts()
    # each case: one encode and one decode; each stream: ans.encode, then
    # decode_stream and ans.decode (two decodes)
    assert after["rans_encode"] - before["rans_encode"] == launches
    assert after["rans_decode"] - before["rans_decode"] == launches + len(streams)


@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_rans_chain_matches_plain_version(cuda, kind):
    """The chain the rANS kernels' floor is counted on runs the plain
    version's steps, takes cycles in proportion to them, and is counted as
    no kernel launch."""
    rng = np.random.default_rng(24)
    flat = torch.from_numpy(rng.integers(0, 256, 4096).astype(np.uint8)).to(cuda)
    t = ans.build_freq_table(flat)
    s2s = ans._slot_to_symbol(t)
    words = torch.from_numpy(rng.integers(0, 1 << 16, 8).astype(np.int32)).to(cuda)
    before = kernels.launch_counts()
    cycles = {}
    for steps in (0, 8, 800, 8000):
        for state in (ref.RANS_L, 0xFFFFFFFF):
            got, cycles[steps] = rans.chain(kind, t.freq, t.cum, s2s, flat[:8], words,
                                            state, steps)
            want = rans.plain_chain(kind, t.freq, t.cum, s2s, flat[:8], words, state, steps)
            assert torch.equal(got.cpu(), want), (steps, state)
    assert kernels.launch_counts() == before
    # a step takes at least one cycle, and ten times the steps about ten
    # times the cycles
    assert 800 <= cycles[800] and 8 <= cycles[8000] / cycles[800] <= 12
    with pytest.raises(ValueError):
        rans.chain(kind, t.freq, t.cum, s2s, flat[:8], words, 0, 12)


def test_rans_decode_stream_copies_a_misaligned_view(cuda):
    """A stream whose data starts off a 16-byte boundary (an offset view)
    decodes as its aligned copy does."""
    rng = np.random.default_rng(23)
    flat = torch.from_numpy(np.clip(rng.normal(120, 2.5, 128 * 300 - 5), 0, 255)
                            .astype(np.uint8)).to(cuda)
    t = ans.build_freq_table(flat)
    s = ans.encode(flat, t)
    big = torch.zeros((s.words.shape[0] * s.words.shape[1] + 1,), dtype=torch.int16,
                      device=cuda)
    view = big[1:].view(s.words.shape)
    view.copy_(s.words.view(torch.int16))
    assert view.data_ptr() % 16 != 0
    s2s = ans._slot_to_symbol(t)
    got = rans.decode_stream(view, s.lens, t.freq, t.cum, s2s, 300, flat.shape[0])
    assert torch.equal(got.reshape(-1)[: flat.shape[0]], flat)
    syms = torch.zeros(128 * 300 + 1, dtype=torch.uint8, device=cuda)
    syms[1:1 + flat.shape[0]] = flat
    grid = syms[1:].view(300, 128)
    assert grid.data_ptr() % 16 != 0
    got = rans.encode(grid, t.freq, t.cum, flat.shape[0])
    for g, w in zip(got, ref.rans_encode(grid, t.freq, t.cum, flat.shape[0])):
        assert torch.equal(g, w)


@pytest.mark.parametrize("codec_name", ["packed", "rans"])
def test_compressor_on_the_card_equals_the_cpu(cuda, codec_name):
    x = to_torch(grad_like_bits("bfloat16", 512 * 21 + 5, seed=19), "bfloat16")
    gpu, cpu = (Compressor(codec_name=codec_name, device=d) for d in (cuda, "cpu"))
    gm, cm = gpu.encode(x.to(cuda)), cpu.encode(x)
    np.testing.assert_array_equal(gm.lo_payload, cm.lo_payload)
    for k, v in cm.exp_payload.items():
        np.testing.assert_array_equal(gm.exp_payload[k], v, err_msg=k)
    assert gm.wire_bytes() == cm.wire_bytes()
    assert torch.equal(gpu.decode(cm).cpu().view(torch.int16), x.view(torch.int16))


@pytest.mark.parametrize("fmt", FORMATS)
def test_plane_split_kernel_matches_plain_version(cuda, fmt):
    """Whole numbers of blocks (not multiples of the TPU's 8-block tile),
    blocks of 512 and 64 values, with every hard case of grad_like_bits."""
    before = kernels.launch_counts()["plane_split"]
    for n_blocks, block in ((33, 512), (1, 512), (77, 64)):
        x = to_torch(grad_like_bits(fmt, n_blocks * block, seed=n_blocks), fmt).to(cuda)
        got = plane_split.split_with_stats(x, block)
        for g, w in zip(got, ref.split_with_stats(x, block)):
            assert g.dtype == torch.int32 and torch.equal(g, w), (fmt, n_blocks, block)
    assert kernels.launch_counts()["plane_split"] - before == 3
    with pytest.raises(ValueError):
        plane_split.split_with_stats(x[:-1], block)


def test_delta_wire_on_the_card_equals_the_cpu(cuda):
    """encode_delta's fields on the card equal the CPU's, and decode_delta
    restores the bits, NaN payloads included."""
    from repro_torch.sync.engine import host_message

    bits = grad_like_bits("bfloat16", 512 * 40 + 96, seed=20)
    rng = np.random.default_rng(21)
    mask = rng.integers(0, 8, bits.shape).astype(bits.dtype)
    mask[rng.random(bits.shape) > 0.3] = 0
    new, base = to_torch(bits ^ mask, "bfloat16"), to_torch(bits, "bfloat16")
    m = packing.encode_delta(new.to(cuda), base.to(cuda), width=2, lo_width=4)
    c = packing.encode_delta(new, base, width=2, lo_width=4)
    g, h = host_message(m), host_message(c)
    for a, b in ((g.lo, h.lo), (g.exp, h.exp)):
        for f in ("payload", "exc_idx", "exc_raw", "overflow"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(g.exp.bases, h.exp.bases)
    back = packing.decode_delta(m, base.to(cuda))
    assert torch.equal(back.cpu().view(torch.int16), new.view(torch.int16))


def test_full_width_delta_round_trip_on_the_card(cuda):
    """One smollm-135m bf16 bucket (134 515 200 values): a warm delta packs
    with no overflow, its wire has the plan's closed-form size, the pack and
    unpack kernels run twice each, and the decode restores every bit."""
    from repro_torch.sched.compile import delta_wire_bytes

    n = 134_515_200
    gen = torch.Generator(cuda).manual_seed(22)
    base = (torch.randn(n, device=cuda, generator=gen) * 0.02).to(torch.bfloat16)
    flip = torch.randint(0, 8, (n,), device=cuda, generator=gen, dtype=torch.int16)
    flip = torch.where(torch.rand(n, device=cuda, generator=gen) < 0.3, flip, 0)
    new = (base.view(torch.int16) ^ flip).view(torch.bfloat16)
    before = kernels.launch_counts()
    m = packing.encode_delta(new, base, width=2, lo_width=4)
    assert m.overflow == 0
    assert m.wire_bytes() == delta_wire_bytes(n, width=2, lo_width=4, block=512,
                                              exc_frac=0.02)
    back = packing.decode_delta(m, base)
    after = kernels.launch_counts()
    assert torch.equal(back.view(torch.int16), new.view(torch.int16))
    assert (after["pack"] - before["pack"], after["unpack"] - before["unpack"]) == (2, 2)


# ---------------------------------------------------------------------------
# the all-reduce family and psum_with_plan on a one-rank NCCL group, against
# the same calls on a one-rank gloo group on the CPU
# ---------------------------------------------------------------------------

PSUM_KNOBS = {"fused": {}, "unfused_encode": {"fused_encode": False},
              "unfused_decode": {"fused_decode_reduce": False}}


def _psum_tree(seed: int = 40) -> dict:
    """A bf16 and an f32 bucket, and an int32 leaf outside the codec."""
    x = to_torch(grad_like_bits("bfloat16", 512 * 24 + 77, seed=seed), "bfloat16")
    f = to_torch(grad_like_bits("float32", 3000, seed=seed + 1), "float32")
    return {"w": x[:6000].reshape(60, 100), "emb": x[6000:], "norm": f,
            "step": torch.arange(4, dtype=torch.int32)}


def _launches(before: dict) -> dict:
    after = kernels.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _same_bits(a: torch.Tensor, b: torch.Tensor, *, nan_as_nan: bool = False) -> bool:
    """Same dtype and bits; with ``nan_as_nan`` a NaN matches any NaN: a sum
    leaves the f32 accumulator by float arithmetic and a cast, which keep a
    NaN's payload on the CPU and make it a canonical NaN on the card."""
    a, b = a.detach().cpu().reshape(-1), b.detach().cpu().reshape(-1)
    if a.dtype != b.dtype:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    same = a.view(ints) == b.view(ints)
    if nan_as_nan and a.is_floating_point():
        same |= a.float().isnan() & b.float().isnan()
    return bool(same.all())


@pytest.mark.parametrize("knobs", sorted(PSUM_KNOBS))
def test_psum_with_plan_on_the_card_equals_the_cpu(cuda, knobs):
    import dataclasses

    from repro_torch import sched
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch.train import single_process_group
    from repro_torch.sched.cache import PlanCache

    pol = dataclasses.replace(CompressionPolicy(min_bytes=0), **PSUM_KNOBS[knobs])
    tree = _psum_tree()
    with single_process_group("cpu") as g:
        want, _ = sched.psum_with_plan(tree, g, policy=pol, cache=PlanCache())
    with single_process_group(cuda) as g:
        gtree = {k: v.to(cuda) for k, v in tree.items()}
        before = kernels.launch_counts()
        got, flag = sched.psum_with_plan(gtree, g, policy=pol, cache=PlanCache())
        launched = _launches(before)
    assert int(flag) == 0
    for k in tree:
        assert got[k].is_cuda and _same_bits(got[k], want[k], nan_as_nan=True), k
    knob = {"fused_encode": True, "fused_decode_reduce": True, **PSUM_KNOBS[knobs]}
    per_bucket = chip_smoke.two_shot_launches(knob["fused_encode"],
                                              knob["fused_decode_reduce"], n_dev=1)
    assert launched == {k: 2 * v for k, v in per_bucket.items() if v}  # two buckets


@pytest.mark.parametrize("fused", [True, False])
def test_fsdp_gather_on_the_card_equals_the_cpu(cuda, fused):
    """One FSDP gather and its backward at one rank: the card's bits are the
    CPU's, through the CUDA kernels (an all-gather and a reduce-scatter, as
    one two-shot bucket launches them)."""
    from repro_torch.launch.train import single_process_group
    from repro_torch.optim.fsdp import GatherWire

    wire = GatherWire(("data",), 5, 5, 512, 0.02, True, (64, 40), "bfloat16", fused, fused)
    x = to_torch(grad_like_bits("bfloat16", 2560, seed=51), "bfloat16").reshape(64, 40)
    ct = to_torch(grad_like_bits("bfloat16", 2560, seed=52), "bfloat16").reshape(64, 40)
    out = {}
    for dev in ("cpu", cuda):
        with single_process_group(dev) as g:
            local = x.to(dev).requires_grad_()
            before = kernels.launch_counts()
            full, flag = wire(local, g)
            (grad,) = torch.autograd.grad(full, local, ct.to(dev))
            out[str(dev)] = (full, grad, int(flag), _launches(before))
    (full, grad, flag, launched), (want, want_grad, _, none) = out["cuda"], out["cpu"]
    assert flag == 0 and not none and full.is_cuda and grad.is_cuda
    assert _same_bits(full, want) and _same_bits(grad, want_grad, nan_as_nan=True)
    expect = chip_smoke.two_shot_launches(fused, fused, n_dev=1)
    assert launched == {k: v for k, v in expect.items() if v}
    if fused:
        assert {k: v for k, v in chip_smoke.fsdp_launches(1, 1, 1).items() if v} == launched


def test_hierarchical_all_to_all_and_ppermute_on_the_card_equal_the_cpu(cuda):
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch.train import single_process_group

    pol = CompressionPolicy(min_bytes=0)
    x = to_torch(grad_like_bits("bfloat16", 512 * 24 + 77, seed=41), "bfloat16")

    def calls(g, t):
        return {"hier": lambda: cc.psum_compressed_hierarchical(t, g, g, policy=pol, group=g),
                "a2a": lambda: cc.all_to_all_compressed(t[None], g, policy=pol),
                "ppermute": lambda: cc.ppermute_compressed(t, [(0, 0)], g, policy=pol)}

    with single_process_group("cpu") as g:
        want = {k: fn()[0] for k, fn in calls(g, x).items()}
    # the hierarchical form: two RS and two AG phases; a2a and ppermute:
    # one encode and the AG-style decode of both planes
    expect = {"hier": {"encode_fused": 4, "decode_reduce": 2, "unpack": 6},
              "a2a": {"encode_fused": 1, "unpack": 2},
              "ppermute": {"encode_fused": 1, "unpack": 2}}
    with single_process_group(cuda) as g:
        for k, fn in calls(g, x.to(cuda)).items():
            before = kernels.launch_counts()
            got, flag = fn()
            assert _launches(before) == expect[k], k
            assert int(flag) == 0 and got.is_cuda, k
            assert _same_bits(got, want[k], nan_as_nan=k == "hier"), k


P2P_STRATEGIES = ("split_send", "encode_send", "chunked")


def _p2p_expect(strategy: str, n: int, **kw) -> dict:
    from repro_torch.core.split_send import chunk_grid

    n_chunks = chunk_grid(n, 4, 512)[1] if strategy == "chunked" else 1
    return {k: v for k, v in chip_smoke.p2p_launches(strategy, n_chunks=n_chunks,
                                                     **kw).items() if v}


@pytest.mark.parametrize("strategy", P2P_STRATEGIES)
def test_p2p_strategies_on_the_card_equal_the_cpu(cuda, strategy):
    """split_send, encode_send and the chunked pipeline on a one-rank NCCL
    group: the CPU plain route's bits (the input's), with the launches
    ``chip_smoke.p2p_launches`` derives."""
    from repro_torch.core import split_send as ss
    from repro_torch.launch.train import single_process_group

    fn = {"split_send": ss.split_send, "encode_send": ss.encode_send,
          "chunked": ss.chunked_pipeline_send}[strategy]
    n = 512 * 24 + 77
    x = to_torch(grad_like_bits("bfloat16", n, seed=42), "bfloat16")
    with single_process_group("cpu") as g:
        want, _ = fn(x, g, [(0, 0)], width=5)
    with single_process_group(cuda) as g:
        before = kernels.launch_counts()
        got, flag = fn(x.to(cuda), g, [(0, 0)], width=5)
        assert _launches(before) == _p2p_expect(strategy, n)
    assert int(flag) == 0 and got.is_cuda
    assert _same_bits(got, want) and _same_bits(got, x)


@pytest.mark.parametrize("fused", [True, False])
def test_p2p_reducing_receiver_on_the_card_equals_the_cpu(cuda, fused):
    """split_send(reduce_into=): the fused decode+reduce (decode_reduce and
    the exception patch's unpack) and the unfused decode-then-add give the
    CPU's f32 bits and ``acc + x`` (NaN as NaN)."""
    from repro_torch.core import split_send as ss
    from repro_torch.launch.train import single_process_group

    n = 512 * 24 + 77
    x = to_torch(grad_like_bits("bfloat16", n, seed=43, subnormals=False), "bfloat16")
    acc = torch.from_numpy(np.random.default_rng(43).normal(0, 1, n).astype(np.float32))
    with single_process_group("cpu") as g:
        want, _ = ss.split_send(x, g, [(0, 0)], width=5, reduce_into=acc, use_fused=fused)
    with single_process_group(cuda) as g:
        before = kernels.launch_counts()
        got, flag = ss.split_send(x.to(cuda), g, [(0, 0)], width=5, reduce_into=acc.to(cuda),
                                  use_fused=fused)
        assert _launches(before) == _p2p_expect("split_send", n,
                                                reduce="fused" if fused else "")
    assert int(flag) == 0 and got.is_cuda and got.dtype == torch.float32
    assert _same_bits(got, want, nan_as_nan=True)
    assert _same_bits(got, acc + x.float(), nan_as_nan=True)


def test_p2p_delta_kv_and_weight_sync_on_the_card_equal_the_cpu(cuda):
    """delta_send (pack and unpack twice), transfer_cache_with_plan under
    each strategy and sync_weights_with_plan full and as a delta, on the
    card: the CPU's bits."""
    from repro_torch import sched
    from repro_torch.core import split_send as ss
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch.train import single_process_group
    from repro_torch.sched.cache import PlanCache
    from repro_torch.tree_util import bits_equal, tree_flatten

    pol = CompressionPolicy(min_bytes=0)
    base = to_torch(grad_like_bits("bfloat16", 512 * 24 + 77, seed=44), "bfloat16")
    x = (base.view(torch.int16) ^ 3).view(torch.bfloat16)  # a warm delta
    tree = {"k": x[:6000].reshape(60, 100), "v": x[6000:], "pos": torch.tensor(7)}
    wbase = {"k": base[:6000].reshape(60, 100), "v": base[6000:]}

    def runs(g, dev):
        def on(t):
            return {k: v.to(dev) for k, v in t.items()}

        out = {"delta": ss.delta_send(x.to(dev), base.to(dev), g, [(0, 0)], width=2,
                                      lo_width=4)}
        for s in P2P_STRATEGIES:
            out[f"kv_{s}"] = sched.transfer_cache_with_plan(
                on(tree), g, [(0, 0)], policy=pol, strategy=s, plan_cache=PlanCache())
        w = {k: v for k, v in on(tree).items() if k != "pos"}
        out["sync_full"] = sched.sync_weights_with_plan(w, g, [(0, 0)], policy=pol,
                                                        cache=PlanCache())
        out["sync_delta"] = sched.sync_weights_with_plan(w, g, [(0, 0)], policy=pol,
                                                         base=on(wbase), cache=PlanCache())
        return out

    with single_process_group("cpu") as g:
        want = runs(g, "cpu")
    with single_process_group(cuda) as g:
        before = kernels.launch_counts()
        got = runs(g, cuda)
        launched = _launches(before)
    n = x.numel()
    expect = {}
    for part in [_p2p_expect("delta", n)] + [_p2p_expect(s, n) for s in P2P_STRATEGIES] + [
            _p2p_expect("split_send", n), _p2p_expect("delta", n)]:
        for k, v in part.items():
            expect[k] = expect.get(k, 0) + v
    assert launched == expect
    for k in want:
        (a, fa), (b, fb) = got[k], want[k]
        assert int(fa) == int(fb) == 0, k
        assert (bits_equal({n: t.cpu() for n, t in a.items()}, b) if isinstance(a, dict)
                else _same_bits(a, b)), k
    assert all(t.is_cuda for t in tree_flatten(got["kv_chunked"][0])[0])


def _fleet_params(seed, cuda):
    """Weights of a small fleet on the card: a bf16 and an f32 leaf and an
    int32 step (raw), from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(0, 0.02, 4096).astype(np.float32)).to(
                torch.bfloat16).to(cuda),
            "b": torch.from_numpy(rng.normal(0, 1, 700).astype(np.float32)).to(cuda),
            "step": torch.tensor(seed, dtype=torch.int32, device=cuda)}


def _perturbed(params, seed):
    """Up to three low bits flipped in ~30% of each float: a warm delta."""
    g = torch.Generator(params["w"].device).manual_seed(seed)
    out = dict(params)
    for k, dt in (("w", torch.int16), ("b", torch.int32)):
        bits = params[k].view(dt)
        mask = torch.randint(0, 8, bits.shape, generator=g, device=bits.device, dtype=dt)
        mask[torch.rand(bits.shape, generator=g, device=bits.device) > 0.3] = 0
        out[k] = (bits ^ mask).view(params[k].dtype)
    return out


@pytest.mark.parametrize("kind,fanout", [("star", 2), ("tree", 2), ("pipeline", 1)])
def test_fleet_on_the_card(cuda, kind, fanout):
    """A fleet of 5 on the card (its default device): a full wave, then two
    delta waves, every replica bit-exact with its weights on the card, one
    encode a publish, the schedule's egress and forwards, and the launches:
    a full encode encode_fused 1 a bucket, a delta pack 2 a bucket, every
    applied bucket unpack 2."""
    from repro_torch import sched
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.sched.cache import PlanCache
    from repro_torch.sync import FleetConfig, SyncFleet, WeightSyncEngine
    from repro_torch.tree_util import tree_leaves

    n = 5
    fleet = SyncFleet(WeightSyncEngine(policy=CompressionPolicy(min_bytes=0),
                                       plan_cache=PlanCache()),
                      [f"r{i}" for i in range(n)],
                      cfg=FleetConfig(broadcast=kind, fanout=fanout,
                                      ckpt_every_publishes=10 ** 9))
    schedule = sched.compile_broadcast_schedule(n, kind=kind, fanout=fanout)
    p = _fleet_params(1, cuda)
    before = kernels.launch_counts()
    for i in range(3):
        p = p if i == 0 else _perturbed(p, i)
        fleet.publish(p)
        assert fleet.settle() == 1 and fleet.verify_bitexact()
    buckets = 2  # bf16 and f32, both compressed at min_bytes=0
    assert _launches(before) == {"encode_fused": buckets, "pack": 2 * 2 * buckets,
                                 "unpack": 3 * n * 2 * buckets}
    assert fleet.stats["forwards"] == 3 * (n - schedule.root_degree)
    assert fleet.stats["max_hop_depth"] == schedule.depth
    assert all(t.is_cuda for r in fleet.replicas.values() for t in tree_leaves(r.params))


def test_fleet_chaos_with_a_trainer_restart_on_the_card(cuda, tmp_path):
    """A chaos seed over a tree of 5 on the card: drops, corruptions, delays,
    a kill, a join and a trainer restart from a checkpoint restored on the
    card; it converges bit-exact with no silent corruption."""
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.runtime.faults import FaultConfig, FaultPlan
    from repro_torch.sync import FleetConfig, SyncFleet, WeightSyncEngine
    from repro_torch.tree_util import tree_leaves

    names = tuple(f"r{i}" for i in range(5))
    plan = FaultPlan.generate(FaultConfig(
        seed=7, rounds=10, drop_rate=0.1, corrupt_rate=0.1, delay_rate=0.1, max_delay=2,
        kills=1, joins=1, trainer_restarts=1, replicas=names))
    fleet = SyncFleet(WeightSyncEngine(policy=CompressionPolicy(min_bytes=0)), names,
                      fault_plan=plan, cfg=FleetConfig(broadcast="tree", fanout=2,
                                                       max_retries=30, backoff_cap=2,
                                                       ckpt_dir=str(tmp_path)))
    p = _fleet_params(2, cuda)
    for r in range(10):
        if r % 3 == 0:
            p = p if r == 0 else _perturbed(p, r)
            fleet.publish(p)
        fleet.round()
    fleet.settle(max_rounds=80)
    led = fleet.integrity_ledger()
    assert fleet.verify_bitexact() and led["silent"] == 0
    assert led["injected"] == led["seen"] + led["lost"]
    assert fleet.stats["trainer_restarts"] == 1 and fleet.stats["quarantines"] == 0
    assert all(t.is_cuda for t in tree_leaves(fleet.engine.store.latest()[0]))


def test_checkpoint_restore_defaults_to_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.tree_util import bits_equal, tree_leaves

    state = {"params": _fleet_params(3, cuda), "version": np.asarray(3, np.int64)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    got, step = mgr.restore(state)
    assert step == 1 and all(t.is_cuda for t in tree_leaves(got))
    assert bits_equal(got["params"], state["params"]) and int(got["version"]) == 3


# ---------------------------------------------------------------------------
# observability on the card: no launch and no bit changes with it
# ---------------------------------------------------------------------------

def test_kernel_launches_are_the_same_with_obs_on_and_off(cuda):
    """A psum plan, a weight-sync full and delta update and a p2p encode and
    decode of each codec on the card: the same launches of every kernel and
    the same bits with obs on and off."""
    from repro_torch import obs, sched
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch.train import single_process_group
    from repro_torch.sched.cache import PlanCache
    from repro_torch.sync import WeightSyncEngine, apply_update
    from torch_port_util import np_of

    x = to_torch((np.arange(1 << 16) % 8192 + 0x3800).astype(np.uint16), "bfloat16").to(cuda)

    def run():
        kernels.clear_launch_counts()
        with single_process_group(cuda) as g:
            res, flag = sched.psum_with_plan({"x": x}, g, policy=CompressionPolicy(min_bytes=0),
                                             cache=PlanCache())
        eng = WeightSyncEngine(policy=CompressionPolicy(min_bytes=0))
        eng.publish({"w": x})
        u1 = eng.update_for("r")
        held = apply_update(u1, device=cuda)
        eng.ack("r", u1.version)
        eng.publish({"w": x * 1.0078125})
        held2 = apply_update(eng.update_for("r"), base_params=held, device=cuda)
        outs = [res["x"], held2["w"]]
        for codec_name in ("packed", "rans"):
            comp = Compressor(codec_name=codec_name, device=cuda)
            outs.append(comp.decode(comp.encode(x)))
        torch.cuda.synchronize()
        return kernels.launch_counts(), int(flag), [np_of(t).tobytes() for t in outs]

    obs.set_enabled(True)
    obs.reset()
    try:
        on = run()
        assert obs.spans() and obs.snapshot()["counters"]
        obs.reset()
        obs.set_enabled(False)
        off = run()
        assert obs.spans() == () and obs.snapshot()["counters"] == {}
    finally:
        obs.set_enabled(None)
        obs.reset()
    assert off == on and sum(on[0].values()) > 0 and on[1] == 0


def test_regret_sample_of_a_cuda_bucket_is_strided_on_the_card(cuda):
    """The sample store strides a CUDA bucket on the card and copies at most
    SAMPLE_MAX_ELEMS values to the host: every stride-th value, bit for bit,
    its base paired with it."""
    from repro_torch import obs
    from repro_torch.obs import regret
    from repro_torch.tree_util import bits_equal

    n = regret.SAMPLE_MAX_ELEMS * 5 + 123
    x = to_torch(np.arange(n).astype(np.uint16), "bfloat16").to(cuda)
    base = x.flip(0)
    obs.set_enabled(True)
    obs.reset()
    try:
        regret.record_sample("wsync_host", "bfloat16", x, base=base)
        (s,) = regret.samples()[("wsync_host", "bfloat16")]
    finally:
        obs.set_enabled(None)
        obs.reset()
    stride = -(-n // regret.SAMPLE_MAX_ELEMS)
    assert s.x.device.type == s.base.device.type == "cpu" and s.elems == n
    assert s.x.numel() == s.base.numel() <= regret.SAMPLE_MAX_ELEMS
    assert bits_equal(s.x, x[::stride].contiguous().cpu())
    assert bits_equal(s.base, base[::stride].contiguous().cpu())


# ---------------------------------------------------------------------------
# the dense zoo and plan persistence on the card
# ---------------------------------------------------------------------------

def _zoo_archs():
    """The archs the serve engine serves: all but the encoder-decoder one,
    whose engine feeds no frames (as the reference's)."""
    from repro_torch import configs

    return [a for a in configs.ARCHS if not configs.get(a).enc_dec]


@pytest.mark.parametrize("arch", _zoo_archs())
def test_zoo_smoke_models_serve_pd_as_colocated_on_the_card(cuda, arch):
    """Each served arch's SMOKE model, drawn on the card by a CUDA
    generator: PD serving over the compressed host KV wire gives the
    colocated tokens, and each admission packs and unpacks every cache leaf
    twice on the card (a prefix layer's leaves and recurrent states
    included)."""
    from repro_torch import configs
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.models import transformer
    from repro_torch.sched.cache import PlanCache
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    cfg = configs.get_smoke(arch)
    model = transformer.init(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    assert all(p.is_cuda for p in model.leaves())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, 24).astype(np.int32) for _ in range(3)]

    def serve(pd):
        eng = ServeEngine(cfg, model, ServeConfig(batch_slots=2, max_len=64, prefill_chunk=24,
                                                  pd_disaggregated=pd),
                          kv_policy=CompressionPolicy(min_bytes=0) if pd else None,
                          kv_plan_cache=PlanCache() if pd else None)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=5))
        return sorted((r.rid, tuple(r.out)) for r in eng.run())

    colocated = serve(False)
    kernels.clear_launch_counts()
    pd = serve(True)
    counts = kernels.launch_counts()
    leaves = sum(1 for _, t in transformer.tree_paths(transformer.init_cache(cfg, 1, 8, "cpu"))
                 if t.dim())
    assert pd == colocated
    assert counts["pack"] == counts["unpack"] == 2 * leaves * len(prompts)


def test_vision_batch_and_cuda_draws_on_the_card(cuda):
    from repro_torch import configs
    from repro_torch.models import registry, transformer
    from repro_torch.tree_util import bits_equal

    cfg = configs.get_smoke("qwen2_vl_72b")
    got = registry.make_batch(cfg, 2, 16, rng=np.random.default_rng(1), device=cuda)
    want = registry.make_batch(cfg, 2, 16, rng=np.random.default_rng(1), device="cpu")
    assert all(t.is_cuda for t in got.values())
    assert bits_equal({k: v.cpu() for k, v in got.items()}, want)
    draw = lambda: transformer.init(cfg, generator=torch.Generator(cuda).manual_seed(5),  # noqa: E731
                                    device=cuda)
    a, b = draw(), draw()
    assert bits_equal(a.tree(), b.tree())
    with torch.no_grad():
        h = a(got["tokens"], vision_embeds=got["vision_embeds"])
    assert h.is_cuda and bool(torch.isfinite(h.float()).all())


def test_plans_compiled_on_the_card_are_dropped_in_a_cpu_process(cuda, tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.sched import compile as sched_compile
    from repro_torch.sched.cache import PlanCache

    cache = {"pos": torch.zeros((), dtype=torch.int32, device=cuda),
             "kv": torch.randn((2, 64, 2, 16), device=cuda).to(torch.bfloat16)}
    pc = PlanCache()
    plan = sched_compile.cached_kv_plan(cache, "data", policy=CompressionPolicy(min_bytes=0),
                                        n_dev=1, plan_cache=pc)
    assert (plan.backend, plan.use_kernels) == ("cuda", True)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_plans(pc)
    assert mgr.restore_plans(PlanCache(), device="cpu") == 0
    back = PlanCache()
    assert mgr.restore_plans(back, device=cuda) == 1
    again = sched_compile.cached_kv_plan(cache, "data", policy=CompressionPolicy(min_bytes=0),
                                         n_dev=1, plan_cache=back)
    assert again == plan and (back.stats.misses, back.stats.hits) == (0, 1)


# ---------------------------------------------------------------------------
# MoE and MLA on the card
# ---------------------------------------------------------------------------

def _deepseek_layer(device):
    """deepseek-v2-lite SMOKE's MoE + MLA layer weights, drawn on the CPU
    from seed 0 and moved to ``device``."""
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.get_smoke("deepseek_v2_lite_16b")
    g = torch.Generator().manual_seed(0)
    tree = {}
    for path, (shape, scale) in transformer.tree_paths(
            transformer._layer_shapes(cfg, cfg.pattern[0])):
        t = torch.ones(shape) if scale is None else torch.randn(shape, generator=g) * scale
        node = tree
        *keys, last = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = t.to(torch.bfloat16).to(device)
    return cfg, tree


@pytest.mark.parametrize("n_tok", [64, 1024])
def test_moe_forward_and_backward_are_bit_identical_twice_on_the_card(cuda, n_tok):
    """The MoE layer's output and every gradient (input, router, experts,
    shared expert), dropless (64 tokens) and at capacity (1024), twice
    under the launcher's deterministic setting: the same bits, as the
    compressed and raw training twins need (no float scatter-add or
    index-add runs, forward or backward).  The same inputs on the CPU:
    the routing (expert picks, the slot table, each pick's slot) equal,
    the output and gradients within ``test_torch_moe_mla``'s tolerances
    against the reference (1/64 of the largest magnitude, ``we1``'s
    1/32)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.tree_util import bits_equal, tree_leaves, tree_map

    cfg, tree = _deepseek_layer("cpu")
    x0 = torch.randn((2, n_tok // 2, cfg.d_model),
                     generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    ct = torch.linspace(-1, 1, x0.numel()).view_as(x0)

    def run(dev):
        p = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(True), tree["ffn"])
        x = x0.to(dev, copy=True).requires_grad_(True)
        with launch_train.deterministic():
            y = L.moe(p, x, cfg)
            (y.float() * ct.to(dev)).sum().backward()
            with torch.no_grad():
                d = L.moe_dispatch(p, x.reshape(n_tok, -1), cfg, L.moe_capacity(cfg, n_tok))
        return ([y.detach(), x.grad] + [t.grad for t in tree_leaves(p)],
                [d.eids, d.slot, d.where])

    (a, route), (b, _), (host, host_route) = run(cuda), run(cuda), run("cpu")
    assert all(t is not None for t in a)
    assert bits_equal([t.cpu() for t in a], [t.cpu() for t in b])
    for got, want in zip(route, host_route, strict=True):
        assert torch.equal(got.cpu(), want)
    paths = ["y", "x"] + [k for k, _ in transformer.tree_paths(tree["ffn"])]
    for path, got, want in zip(paths, a, host, strict=True):
        frac = 1 / 32 if path == "we1" else 1 / 64
        assert (got.float().cpu() - want.float()).abs().max() <= want.float().abs().max() * frac, \
            path


def test_mla_decode_on_the_card_equals_the_cpu(cuda):
    """A prefill of 16 positions, then 4 decode steps, on the card and on
    the CPU: the latents written and the outputs within one bf16 ulp of
    their largest magnitude (``test_torch_moe_mla``'s tolerance against
    the reference)."""
    from repro_torch.models import layers as L

    cfg, tree = _deepseek_layer("cpu")
    spec, B, S, L_MAX = cfg.pattern[0], 2, 16, 32
    sides = {}
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in tree["mixer"].items()}
        cache = {"c_kv": torch.zeros((B, L_MAX, cfg.mla.kv_lora), dtype=torch.bfloat16,
                                     device=dev),
                 "k_rope": torch.zeros((B, L_MAX, cfg.mla.rope_dim), dtype=torch.bfloat16,
                                       device=dev)}
        g = torch.Generator().manual_seed(2)
        outs = []
        with torch.no_grad():
            x = torch.randn((B, S, cfg.d_model), generator=g).to(torch.bfloat16).to(dev)
            cs = L.rope_table(torch.arange(S, device=dev), cfg.mla.rope_dim, cfg.rope_theta)
            L.mla_attention(p, x, cfg, spec, *cs, cache)
            for step in range(4):
                pos = S + step
                x = torch.randn((B, 1, cfg.d_model), generator=g).to(torch.bfloat16).to(dev)
                cs = L.rope_table(torch.full((1,), pos, device=dev), cfg.mla.rope_dim,
                                  cfg.rope_theta)
                outs.append(L.mla_attention(p, x, cfg, spec, *cs, cache, pos).float().cpu())
        sides[str(dev)] = (outs, {k: v.cpu() for k, v in cache.items()})
    (cpu_out, cpu_cache), (gpu_out, gpu_cache) = sides["cpu"], sides[str(cuda)]
    for a, b in [*zip(gpu_out, cpu_out), *((gpu_cache[k].float(), cpu_cache[k].float())
                                           for k in cpu_cache)]:
        assert (a - b).abs().max() <= b.abs().max() * 2.0 ** -8


# ---------------------------------------------------------------------------
# the remaining mixers on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_recurrent_mixers_on_the_card_equal_the_cpu(cuda, mixer):
    """A prefill of 64 positions returning its state, then 3 decode steps
    from it, on the card and on the CPU (jamba and xlstm SMOKE widths,
    weights drawn on the CPU): every output and state leaf within 1/64 of
    its largest magnitude (``test_torch_mixers``' Mamba tolerance against
    the reference; the bf16 projections sum in other orders on the card)."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.tree_util import tree_leaves, tree_map

    cfg = configs.get_smoke("jamba_v0_1_52b" if mixer == "mamba" else "xlstm_350m")
    spec = next(s for s in cfg.pattern if s.mixer == mixer)
    host = transformer.init(dataclasses.replace(cfg, pattern=(spec,)),
                            generator=torch.Generator().manual_seed(0), device="cpu")
    x0 = torch.randn((2, 67, cfg.d_model), generator=torch.Generator().manual_seed(1))
    x0 = x0.to(torch.bfloat16)
    sides = {}
    for dev in ("cpu", cuda):
        p = {k.removeprefix("blocks/0/mixer/"): t.detach()[0].to(dev)
             for k, t in host.params.items() if "/mixer/" in k}
        x = x0.to(dev)
        fn = getattr(L, mixer)
        with torch.no_grad():
            kw = {"return_state": True} if mixer == "mamba" else {}
            out, st = fn(p, x[:, :64], cfg, **kw)
            outs, states = [out], [st]
            for t in range(64, 67):
                out, st = fn(p, x[:, t:t + 1], cfg, state=st)
                outs.append(out)
                states.append(st)
        sides[str(dev)] = tree_map(lambda t: t.float().cpu(), (outs, states))
    for a, b in zip(tree_leaves(sides[str(cuda)]), tree_leaves(sides["cpu"]),
                    strict=True):
        assert (a - b).abs().max() <= b.abs().max() / 64


def test_jamba_pd_admission_ships_its_f32_state_bit_identical(cuda):
    """jamba SMOKE on the card: one admission's prefilled cache (bf16 K/V
    and conv, f32 h) over the host wire under its kv plan, every leaf
    bit-identical, pack and unpack launched twice a leaf on the card."""
    from repro_torch import configs
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.models import transformer
    from repro_torch.serve import kv_transfer
    from repro_torch.tree_util import bits_equal

    cfg = configs.get_smoke("jamba_v0_1_52b")
    model = transformer.init(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (1, 24))).to(cuda)
    _, cache = transformer.prefill(model, toks, transformer.init_cache(cfg, 1, 64, cuda))
    leaves = [t for _, t in transformer.tree_paths(cache) if t.dim()]
    assert {t.dtype for t in leaves} == {torch.bfloat16, torch.float32}
    eng = Compressor(codec_name="packed", device=cuda)
    kernels.clear_launch_counts()
    wire, plan = kv_transfer.ship_cache(cache, eng, policy=CompressionPolicy(min_bytes=0))
    back = kv_transfer.unpack_cache(wire, eng)
    counts = kernels.launch_counts()
    assert bits_equal(back, cache)
    assert all(t.is_cuda for _, t in transformer.tree_paths(back))
    assert counts["pack"] == counts["unpack"] == 2 * len(leaves)
    assert plan.width_for_dtype("float32") is not None


def test_sampling_on_the_card_is_seeded_and_follows_softmax(cuda):
    """Sampling at temperature > 0 with a CUDA generator: the draws stay on
    the card, are int32, repeat under one seed and part under another, and
    20 000 of them over a vocabulary of 8 pass the chi-square test against
    ``softmax(logits / T)`` at p = 0.001 (7 degrees of freedom)."""
    from repro_torch.serve.engine import sample

    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25], device=cuda)
    n, temperature = 20_000, 0.8
    lg = logits.expand(n, 8).to(torch.bfloat16)
    draw = lambda seed: sample(lg, temperature,  # noqa: E731
                               torch.Generator(cuda).manual_seed(seed))
    a, b, c = draw(0), draw(0), draw(1)
    assert a.is_cuda and a.dtype == torch.int32 and a.shape == (n,)
    assert torch.equal(a, b) and not torch.equal(a, c)
    p = torch.softmax(lg[0].float() / temperature, -1).cpu().numpy().astype(np.float64)
    counts = np.bincount(a.cpu().numpy(), minlength=8)
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < 24.322, (chi2, counts, n * p)
    assert torch.equal(sample(lg, 0.0), torch.argmax(lg, -1).to(torch.int32))


def test_collective_bytes_read_a_trace_of_nccl_collectives(cuda):
    """A torch.profiler trace (CPU and CUDA activity, record_shapes) of NCCL
    collectives at one rank: ``collective_bytes`` gives each kind's operand
    bytes, the all-reduce's tensor list typed by NCCL's record_param_comms."""
    import json
    import tempfile

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import single_process_group
    from repro_torch.roofline import analysis

    with single_process_group(cuda), tempfile.TemporaryDirectory() as tmp:
        def run():
            dist.all_reduce(torch.ones(1000, dtype=torch.bfloat16, device=cuda))
            dist.all_reduce(torch.ones(3, dtype=torch.float32, device=cuda))
            dist.all_gather_into_tensor(torch.empty(1000, device=cuda),
                                        torch.ones(1000, device=cuda))
            dist.reduce_scatter_tensor(torch.empty(600, dtype=torch.int32, device=cuda),
                                       torch.ones(600, dtype=torch.int32, device=cuda))
            dist.all_to_all_single(torch.empty(256, dtype=torch.uint8, device=cuda),
                                   torch.zeros(256, dtype=torch.uint8, device=cuda))
            cc.raw_ppermute(torch.ones(300, dtype=torch.bfloat16, device=cuda), None,
                            [(0, 0)])
            torch.cuda.synchronize()

        run()  # NCCL's communicator is made on the first call
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            run()
        path = f"{tmp}/t.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            text = f.read()
    got = analysis.collective_bytes(text)
    assert got["bytes"] == {"all-reduce": 2000 + 12, "all-gather": 4000,
                            "reduce-scatter": 2400, "all-to-all": 256,
                            "collective-permute": 600}, got
    assert got["counts"] == {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1,
                             "all-to-all": 1, "collective-permute": 1}
    assert any(e.get("name") == "record_param_comms" for e in json.loads(text)["traceEvents"])


def test_mesh_steps_and_rescale_on_the_card(cuda, tmp_path):
    """ZeRO-1 and FSDP twins (smollm SMOKE, 2 steps at 2 microbatches,
    ``min_bytes=0``) through the launcher on a (1, 1, 1) mesh on the card:
    compressed and raw bit-identical; the ZeRO-1 run's checkpoint (the
    reference's global layout, ``(1, shard_len)`` rows) restored on the
    mesh through ``ElasticController.rescale`` bit for bit."""
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.fault_tolerance import ElasticController, RunnerConfig
    from repro_torch.train import step as step_lib
    from repro_torch.tree_util import bits_equal, tree_leaves

    with launch_train.single_process_group(cuda):
        mesh = mesh_lib.make_mesh((1, 1, 1), ("pod", "data", "model"))
        runs = {}
        for partition in ("zero1", "fsdp"):
            for compress in (True, False):
                runs[partition, compress] = launch_train.train(
                    "smollm_135m", steps=2, batch=4, seq=64, smoke=True, compress=compress,
                    mesh=mesh, partition=partition, microbatches=2,
                    rcfg=RunnerConfig(ckpt_dir=str(tmp_path / f"{partition}{compress}"),
                                      ckpt_every=1))
            a, b = runs[partition, True], runs[partition, False]
            assert a.losses == b.losses and bits_equal(a.state.tree(), b.state.tree())
            assert a.state.axes == ("pod", "data")
        run = runs["zero1", True]
        ctl = ElasticController(lambda n: mesh, lambda m: step_lib.make_train_state_specs(
            configs.get_smoke("smollm_135m"), run.tcfg, m))
        got_mesh, state, step = ctl.rescale(CheckpointManager(str(tmp_path / "zero1True")),
                                            lambda m: run.state, 1)
    assert got_mesh is mesh and step == 1 and state.step == run.state.step
    assert bits_equal(state.tree(), run.state.tree())
    assert all(t.device.type == "cuda" for t in state.model.leaves())
    assert all(t.device.type == "cuda" for t in tree_leaves(state.opt))


def test_launcher_cli_on_a_pod_mesh_on_the_card(cuda, tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", "smollm_135m", "--smoke", "--steps", "2", "--batch", "4",
                       "--seq", "64", "--pods", "1", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    # ZeRO-1 runs on the reference's smoke mesh: one rank in one pod is (data, model)
    assert "mesh={'data': 1, 'model': 1}" in out and "retries 0" in out
