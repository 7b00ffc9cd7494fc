"""Torch port of the codec and the wire format, held against the JAX
reference (``repro.core.codec`` / ``repro.core.packing``).

Tolerance everywhere: none.  The codec is pure bit movement, so every plane
and every wire field must equal the reference's bit for bit, for all five
formats, including NaN payloads, +-Inf, subnormals, all-zero blocks,
exception blocks and the overflow case.  Inputs are seeded numpy bit
patterns handed to both frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import packing as jpacking
from repro_torch.core import codec, packing
from torch_port_util import (FORMATS, assert_bits_equal, grad_like_bits,
                             random_bits, to_jax, to_torch)


@pytest.mark.parametrize("fmt", FORMATS)
def test_split_planes_matches_reference(fmt):
    bits = random_bits(fmt, 4096, seed=1)
    exp, lo = codec.split_planes(to_torch(bits, fmt))
    jexp, jlo = jcodec.split_planes(to_jax(bits, fmt))
    assert exp.dtype == torch.uint8
    assert_bits_equal(exp, jexp, "exp")
    assert_bits_equal(lo, np.asarray(jlo).astype(np.int64), "lo")


@pytest.mark.parametrize("fmt", FORMATS)
def test_merge_planes_inverts_split_bitwise(fmt):
    bits = random_bits(fmt, 4096, seed=2)
    x = to_torch(bits, fmt)
    exp, lo = codec.split_planes(x)
    back = codec.merge_planes(exp, lo, x.dtype, (64, 64))
    assert back.shape == (64, 64) and back.dtype == x.dtype
    assert_bits_equal(back.reshape(-1), x, fmt)
    jback = jcodec.merge_planes(*jcodec.split_planes(to_jax(bits, fmt)),
                                jnp.dtype(fmt), (64, 64))
    assert_bits_equal(back, jback, "vs reference")


@pytest.mark.parametrize("fmt", FORMATS)
def test_merge_truncates_wide_exponents_like_reference(fmt):
    """Garbage exponents wider than the format (exception blocks) wrap in
    the format's width exactly as the reference's uint shift does."""
    rng = np.random.default_rng(3)
    exp = rng.integers(0, 256, 2048).astype(np.uint8)
    lay = codec.LAYOUTS[fmt]
    lo = rng.integers(0, 1 << lay.lo_bits, 2048).astype(np.int64)
    got = codec.merge_planes(torch.from_numpy(exp), torch.from_numpy(lo),
                             lay.dtype, (2048,))
    want = jcodec.merge_planes(jnp.asarray(exp),
                               jnp.asarray(lo.astype(np.uint32)),
                               jnp.dtype(fmt), (2048,))
    assert_bits_equal(got, want, fmt)


@pytest.mark.parametrize("width", [1, 5, 8, 24, 32])
def test_bitplane_pack_unpack_match_reference(width):
    rng = np.random.default_rng(width)
    vals = rng.integers(0, 1 << width, 32 * 40, dtype=np.uint64).astype(np.uint32)
    got = packing.bitplane_pack(torch.from_numpy(vals.astype(np.int64)), width)
    want = jpacking.bitplane_pack(jnp.asarray(vals), width)
    assert got.dtype == torch.int32 and got.shape == (40, width)
    assert_bits_equal(got, want, "pack")
    back = packing.bitplane_unpack(got, width)
    assert_bits_equal(back, vals.astype(np.int64), "unpack")


def _pack_both(fmt, n, width, exc_frac=0.02, seed=4):
    bits = grad_like_bits(fmt, n, seed)
    exp, _ = codec.split_planes(to_torch(bits, fmt))
    jexp, _ = jcodec.split_planes(to_jax(bits, fmt))
    p = packing.pack_exponents(exp, width=width, exc_frac=exc_frac)
    jp = jpacking.pack_exponents(jexp, width=width, exc_frac=exc_frac)
    return p, jp, exp


def _assert_plane_equal(p, jp, ctx):
    for field in ("payload", "bases", "exc_idx", "exc_raw", "overflow"):
        assert_bits_equal(getattr(p, field), getattr(jp, field), f"{ctx} {field}")
    assert p.bases.dtype == torch.uint8 and p.exc_raw.dtype == torch.uint8
    assert p.exc_idx.dtype == torch.int32 and p.overflow.dtype == torch.int32


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("width", [2, 5])
def test_pack_exponents_matches_reference(fmt, width):
    """Ragged n, an all-zero block, subnormals, specials, exception blocks
    (width 2 is too narrow for this data and overflows, like the reference)."""
    p, jp, exp = _pack_both(fmt, 512 * 23 + 77, width)
    _assert_plane_equal(p, jp, f"{fmt} w={width}")
    if width == 5:
        assert int(p.overflow) == 0
        if codec.LAYOUTS[fmt].exp_bits == 8:
            assert int((p.exc_idx < p.n_blocks).sum()) > 0
        assert_bits_equal(packing.unpack_exponents(p), exp, "round trip")


@pytest.mark.parametrize("fmt", ["bfloat16", "float8_e5m2"])
def test_pack_exponents_overflow_matches_reference(fmt):
    """More exception blocks than capacity: the flag fires identically and
    the first ``cap`` exception ids are kept in ascending order."""
    p, jp, _ = _pack_both(fmt, 512 * 600, 1, exc_frac=1e-9)
    _assert_plane_equal(p, jp, fmt)
    assert int(p.overflow) == 1
    assert p.exc_idx.shape == (4,)


def test_first_true_is_static_nonzero():
    rng = np.random.default_rng(5)
    mask = rng.random((3, 50)) < 0.1
    mask[1] = False
    got = packing.first_true(torch.from_numpy(mask), 4, 50)
    for r in range(3):
        (want,) = jnp.nonzero(jnp.asarray(mask[r]), size=4, fill_value=50)
        assert_bits_equal(got[r], np.asarray(want).astype(np.uint32), f"row {r}")


def test_layouts_cover_all_formats():
    assert tuple(codec.LAYOUTS) == tuple(jcodec.LAYOUTS)
    for name, lay in codec.LAYOUTS.items():
        jl = jcodec.LAYOUTS[name]
        assert (lay.total_bits, lay.exp_bits, lay.mant_bits, lay.lo_bits) == (
            jl.total_bits, jl.exp_bits, jl.mant_bits, jl.lo_bits)
        assert codec.layout_of(lay.dtype) is lay
    with pytest.raises(ValueError):
        codec.layout_of(torch.int32)
