"""The port's CUDA kernels on the card, held bit for bit against their plain
PyTorch versions (NaN matched as NaN for the f32 accumulate).  Imports
torch and the port only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test here needs a CUDA GPU and skips elsewhere.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import ans
from repro_torch.core import compressed_collectives as cc
from repro_torch.kernels import bitpack, decode_reduce, encode_fused, rans, ref
from repro_torch.p2p.engine import Compressor
from torch_port_util import FORMATS, grad_like_bits, to_torch

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


def test_rans_kernels_match_plain_versions(cuda):
    """Skewed, uniform and one-symbol streams, a table whose top frequency
    is M - 255, n_valid < per * lanes, and the compacted-stream decode of an
    ``ans.encode`` stream."""
    rng = np.random.default_rng(18)
    per, lanes = 40, 128
    streams = {"skewed": np.clip(rng.normal(120, 2.5, per * lanes), 0, 255),
               "uniform": rng.integers(0, 256, per * lanes),
               "single": np.full(per * lanes, 7)}
    top = np.ones(256, np.int64)
    top[7] = ans.M - 255
    for name, s in streams.items():
        syms = torch.from_numpy(s.astype(np.uint8)).reshape(per, lanes).to(cuda)
        tables = [ans.build_freq_table(syms)]
        if name == "single":
            tables.append(ans.table_from_freq(torch.from_numpy(top).to(cuda)))
        for t in tables:
            s2s = ans._slot_to_symbol(t)
            for n_valid in (per * lanes, per * lanes - 77):
                got = rans.encode(syms, t.freq, t.cum, n_valid)
                want = ref.rans_encode(syms, t.freq, t.cum, n_valid)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (name, n_valid)
                dec = rans.decode(got[0], got[2], t.freq, t.cum, s2s, n_valid)
                assert torch.equal(dec, ref.rans_decode(got[0], got[2], t.freq, t.cum,
                                                        s2s, n_valid)), (name, n_valid)
                assert torch.equal(dec.reshape(-1)[:n_valid],
                                   syms.reshape(-1)[:n_valid]), (name, n_valid)
        flat = syms.reshape(-1)[: per * lanes - 77]
        stream = ans.encode(flat, tables[0])
        cpu = ans.encode(flat.cpu(), tables[0])  # the table moves to the CPU
        assert torch.equal(stream.words.cpu().view(torch.int16), cpu.words.view(torch.int16))
        assert torch.equal(stream.lens.cpu(), cpu.lens)
        s2s = ans._slot_to_symbol(tables[0])
        got = rans.decode_stream(stream.words, stream.lens, tables[0].freq,
                                 tables[0].cum, s2s, per, flat.shape[0])
        want = ref.rans_decode_stream(stream.words, stream.lens, tables[0].freq,
                                      tables[0].cum, s2s, per, flat.shape[0])
        assert torch.equal(got, want), name
        assert torch.equal(ans.decode(stream), flat), name


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
