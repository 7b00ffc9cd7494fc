"""The port's CUDA kernels on the card, held bit for bit against their plain
PyTorch versions (NaN matched as NaN for the f32 accumulate).  Imports
torch and the port only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test here needs a CUDA GPU and skips elsewhere.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import compressed_collectives as cc
from repro_torch.kernels import decode_reduce, encode_fused, ref
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
