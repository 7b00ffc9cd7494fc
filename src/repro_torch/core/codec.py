"""Bit-plane split/merge for floating-point tensors (paper §2.1.2, Step 1).

Torch port of ``repro.core.codec``.  Every float splits into an exponent
plane (uint8) and a lo plane (sign relocated next to the mantissa).  The
arithmetic runs on the raw bit pattern held in a signed integer dtype
(torch's unsigned 16/32-bit dtypes lack shifts and min/max on the CPU),
masked after every right shift, so no float operation ever touches a value:
NaN payloads, infinities and subnormals round-trip exactly.

For fp8 formats the paper packs two exponent fields per byte (or per 16-bit
unit) for byte-granular split-stage writes; :func:`pack_fp8_exp_pairs`
mirrors that on the raw-wire path.  :func:`plane_fractions` gives each
plane's share of the raw size.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FloatLayout:
    """Bit layout of a supported floating-point format."""

    name: str
    dtype: torch.dtype
    total_bits: int
    exp_bits: int
    mant_bits: int  # mantissa (fraction) bits; sign is always 1

    @property
    def lo_bits(self) -> int:  # sign + mantissa
        return 1 + self.mant_bits

    @property
    def bits_dtype(self) -> torch.dtype:
        """Same-width integer dtype a float tensor is ``view``-ed as."""
        return {8: torch.uint8, 16: torch.int16, 32: torch.int32}[self.total_bits]

    @property
    def bits_mask(self) -> int:
        return (1 << self.total_bits) - 1


LAYOUTS: dict[str, FloatLayout] = {
    "float32": FloatLayout("float32", torch.float32, 32, 8, 23),
    "float16": FloatLayout("float16", torch.float16, 16, 5, 10),
    "bfloat16": FloatLayout("bfloat16", torch.bfloat16, 16, 8, 7),
    "float8_e4m3fn": FloatLayout("float8_e4m3fn", torch.float8_e4m3fn, 8, 4, 3),
    "float8_e5m2": FloatLayout("float8_e5m2", torch.float8_e5m2, 8, 5, 2),
}

_BY_DTYPE = {lay.dtype: lay for lay in LAYOUTS.values()}


def layout_of(dtype) -> FloatLayout:
    if isinstance(dtype, str):
        if dtype in LAYOUTS:
            return LAYOUTS[dtype]
    elif dtype in _BY_DTYPE:
        return _BY_DTYPE[dtype]
    raise ValueError(f"unsupported dtype for codec: {dtype}")


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """Raw unsigned bit pattern of a float tensor, as ``int64`` (flat)."""
    lay = layout_of(x.dtype)
    return x.reshape(-1).view(lay.bits_dtype).to(torch.int64) & lay.bits_mask


def from_bits(bits: torch.Tensor, lay: FloatLayout) -> torch.Tensor:
    """Inverse of :func:`to_bits`: ``int64`` bit patterns -> float tensor.
    Bits above ``total_bits`` are truncated, as a cast to the format's
    unsigned width truncates them in the reference."""
    return (bits & lay.bits_mask).to(lay.bits_dtype).view(lay.dtype)


def split_planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split ``x`` (any shape) into ``(exp_plane, lo_plane)``.

    exp_plane: uint8 (N,), one exponent field per element.
    lo_plane:  int32 (N,), ``sign << mant_bits | mantissa`` (< 2**lo_bits,
    at most 2**24), the reference's uint32 values.

    The bits are held in ``int32`` (sign-extended from 16 bits); every field
    is masked after its shift, so the extension never shows.
    """
    lay = layout_of(x.dtype)
    bits = x.reshape(-1).view(lay.bits_dtype).to(torch.int32)
    exp = (bits >> lay.mant_bits) & ((1 << lay.exp_bits) - 1)
    sign = (bits >> (lay.total_bits - 1)) & 1
    lo = (sign << lay.mant_bits) | (bits & ((1 << lay.mant_bits) - 1))
    return exp.to(torch.uint8), lo


# values a decode merges at a time where a wire is larger (1.1 G values
# merged whole would hold tens of GB of temporaries)
MERGE_SLICE = 1 << 24


def merge_bits(exp: torch.Tensor, lo: torch.Tensor, lay: FloatLayout) -> torch.Tensor:
    """Merge integer exponent and lo values into bit patterns, truncated to
    the format's width (exponents wider than ``exp_bits`` wrap exactly as the
    reference's shift in the format's unsigned dtype does).  Formats under
    32 bits compute in int32 (a shift's low bits do not depend on the width),
    float32 in int64; the result has that dtype."""
    wide = torch.int32 if lay.total_bits < 32 else torch.int64
    exp = exp.to(wide)
    lo = lo.to(wide)
    sign = (lo >> lay.mant_bits) & 1
    mant = lo & ((1 << lay.mant_bits) - 1)
    bits = (sign << (lay.total_bits - 1)) | (exp << lay.mant_bits) | mant
    return bits & lay.bits_mask


def merge_planes(exp: torch.Tensor, lo: torch.Tensor, dtype,
                 shape: tuple[int, ...]) -> torch.Tensor:
    """Exact inverse of :func:`split_planes`."""
    lay = layout_of(dtype)
    n = 1
    for s in shape:
        n *= int(s)
    lo = lo.reshape(-1)[:n].to(torch.int64) & lay.bits_mask
    bits = merge_bits(exp.reshape(-1)[:n], lo, lay)
    return from_bits(bits, lay).reshape(shape)


def exponent_entropy_bits(exp_plane: torch.Tensor, exp_bits: int) -> torch.Tensor:
    """Empirical entropy (bits/symbol) of an exponent plane, in float32: the
    floor any entropy coder (the paper's ANS) can reach."""
    nsym = 1 << exp_bits
    counts = torch.bincount(exp_plane.reshape(-1).to(torch.int64),
                            minlength=nsym)[:nsym]
    p = counts.to(torch.float32) / counts.sum().clamp_min(1).to(torch.float32)
    return -torch.sum(torch.where(p > 0, p * torch.log2(torch.where(p > 0, p, 1.0)), 0.0))


# ---------------------------------------------------------------------------
# XOR delta and bucket helpers of the weight-sync wire, in the bits domain
#
# Consecutive weight versions differ by small optimizer steps, so the XOR of
# a version against the receiver's base version is zero wherever a weight did
# not move and concentrates its nonzero bits in the low mantissa elsewhere.
# The delta is itself a bit pattern of the same format, so the split+pack
# wire applies to it unchanged.  Every helper below works on integer views of
# the tensors: no float operation touches a value, so NaN payloads,
# infinities and subnormals pass through exactly.
# ---------------------------------------------------------------------------

def xor_delta(x: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Bitwise XOR of two same-shape, same-dtype float tensors, as that
    float dtype.  Self-inverse: ``xor_delta(xor_delta(x, base), base)`` has
    the bits of ``x``."""
    lay = layout_of(x.dtype)
    if base.dtype != x.dtype or tuple(base.shape) != tuple(x.shape):
        raise ValueError(
            f"xor_delta needs matching operands, got {tuple(x.shape)}/{x.dtype} "
            f"vs {tuple(base.shape)}/{base.dtype}")
    bits = x.view(lay.bits_dtype) ^ base.view(lay.bits_dtype)
    return bits.view(lay.dtype)


def concat_bits(parts: list) -> torch.Tensor:
    """Concatenate same-dtype flat float tensors through their integer
    views (one part is returned as it is)."""
    if len(parts) == 1:
        return parts[0]
    lay = layout_of(parts[0].dtype)
    return torch.cat([p.view(lay.bits_dtype) for p in parts]).view(lay.dtype)


def slice_bits(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``x[lo:hi]`` of a flat float tensor, through its integer view."""
    lay = layout_of(x.dtype)
    return x.view(lay.bits_dtype)[lo:hi].view(lay.dtype)


def concat_members(src, members) -> torch.Tensor:
    """Fuse the leaves ``src[i]`` of a plan bucket's ``members`` ``((i,
    shape, size), ...)`` into one flat bucket, in member order."""
    return concat_bits([src[i].reshape(-1) for i, _, _ in members])


def split_members(got: torch.Tensor, members):
    """Inverse of :func:`concat_members`: yields ``(i, leaf)`` sliced out of
    the flat bucket ``got`` (trailing padding is ignored)."""
    off = 0
    for i, shape, size in members:
        yield i, slice_bits(got, off, off + size).reshape(shape)
        off += size


def pad_flat_bits(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad a flat float tensor to a multiple of ``multiple``, through
    its integer view (returned as it is when no pad is needed)."""
    r = (-x.shape[0]) % multiple
    if r == 0:
        return x
    lay = layout_of(x.dtype)
    bits = x.view(lay.bits_dtype)
    return torch.cat([bits, bits.new_zeros((r,))]).view(lay.dtype)


# ---------------------------------------------------------------------------
# fp8 exponent pair packing (paper §4.1: "pack two FP8 values into a single
# 16-bit unit and jointly extract their exponent fields")
# ---------------------------------------------------------------------------

def pack_fp8_exp_pairs(exp: torch.Tensor, exp_bits: int) -> torch.Tensor:
    """Pack two fp8 exponent fields a lane: uint8 ``(ceil(n/2),)`` for
    ``exp_bits <= 4`` (e4m3), else each pair a 16-bit unit stored
    little-endian as uint8 ``(2 ceil(n/2),)`` (e5m2).  An odd ``n`` gets a
    zero partner.  Computed in int32, as the reference's unsigned shifts
    truncated to the unit's width."""
    e = exp.reshape(-1).to(torch.int32)
    if e.shape[0] % 2:
        e = torch.cat([e, e.new_zeros(1)])
    e2 = e.reshape(-1, 2)
    pk = e2[:, 0] | (e2[:, 1] << exp_bits)
    if exp_bits <= 4:
        return (pk & 0xFF).to(torch.uint8)
    pk = pk & 0xFFFF
    return torch.stack([pk & 0xFF, pk >> 8], dim=-1).reshape(-1).to(torch.uint8)


def unpack_fp8_exp_pairs(packed: torch.Tensor, exp_bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_fp8_exp_pairs`: uint8 ``(n,)``."""
    mask = (1 << exp_bits) - 1
    p = packed.reshape(-1).to(torch.int32)
    if exp_bits > 4:
        p = p.reshape(-1, 2)
        p = p[:, 0] | (p[:, 1] << 8)
    lo_e, hi_e = p & mask, (p >> exp_bits) & mask
    return torch.stack([lo_e, hi_e], dim=-1).reshape(-1)[:n].to(torch.uint8)


# ---------------------------------------------------------------------------
# plane-size accounting (the policy, the roofline, the benchmarks)
# ---------------------------------------------------------------------------

def plane_fractions(dtype) -> tuple[float, float]:
    """``(uncompressed_fraction, compressible_fraction)`` of the raw size:
    the lo plane's bits and the exponent's over the format's width (paper
    Property 2: bf16 -> (0.5, 0.5); f32 -> (0.75, 0.25))."""
    lay = layout_of(dtype)
    return lay.lo_bits / lay.total_bits, lay.exp_bits / lay.total_bits
