"""Static-shape block-local wire codec (paper §3.3), torch port of
``repro.core.packing``.

Each block of ``block`` exponents stores its minimum nonzero exponent
(``base``) and packs the zero-escaped residuals at a fixed width ``W``.
Blocks whose range does not fit are exception blocks: their raw exponent
bytes ride in a static-capacity region and are restored exactly at decode;
if the region overflows, ``overflow`` is set and the caller retries the
transfer uncompressed.

Wire dtypes: the reference's ``uint32`` words are ``int32`` tensors with the
same bits (gloo and NCCL move ``int32``), ``bases``/``exc_raw`` are
``uint8``, ``exc_idx``/``overflow`` ``int32``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import codec

GROUP = 32  # residuals per packed group (one 32-bit word per bit-plane)
_U32 = 0xFFFFFFFF


def _as_u32(words: torch.Tensor) -> torch.Tensor:
    """32-bit wire words (any integer dtype) as non-negative ``int64``."""
    return words.to(torch.int64) & _U32


def _to_word(vals: torch.Tensor) -> torch.Tensor:
    """``int64`` values in ``[0, 2**32)`` -> ``int32`` words, same bits."""
    return vals.to(torch.int32)


# ---------------------------------------------------------------------------
# Bit-plane pack / unpack
# ---------------------------------------------------------------------------

def bitplane_pack(vals: torch.Tensor, width: int) -> torch.Tensor:
    """Pack ``vals`` (integer (n,), n % 32 == 0, each < 2**width) into
    bit-planes: returns int32 (n // 32, width); word ``[g, b]`` holds bit
    ``b`` of the 32 values of group ``g`` (value ``i`` at bit ``i``).  A CUDA
    tensor runs the pack kernel, a CPU tensor its plain version
    (``kernels/bitpack.py``); a view off a 16-byte boundary runs on an
    aligned copy (``kernels.aligned``)."""
    from repro_torch.kernels import bitpack

    return bitpack.pack(kernels.aligned(vals), width)


def bitplane_unpack(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`bitplane_pack`; returns int32 (n,), the
    reference's uint32 values with the same bits (unpack kernel on CUDA; a
    view off a 16-byte boundary runs on an aligned copy)."""
    from repro_torch.kernels import bitpack

    return bitpack.unpack(kernels.aligned(packed), width)


# ---------------------------------------------------------------------------
# Static-capacity helpers
# ---------------------------------------------------------------------------

def _pad_to(x: torch.Tensor, m: int, pad_mode: str = "edge") -> torch.Tensor:
    r = (-x.shape[0]) % m
    if r == 0:
        return x
    if pad_mode == "edge":
        return torch.cat([x, x[-1:].expand((r,) + tuple(x.shape[1:]))])
    return torch.cat([x, x.new_zeros((r,) + tuple(x.shape[1:]))])


def exception_capacity(n_blocks: int, exc_frac: float) -> int:
    """Static exception-region capacity: ``exc_frac`` of blocks, floor 4."""
    return min(n_blocks, max(4, int(np.ceil(n_blocks * exc_frac))))


def first_true(mask: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """Row-wise static-capacity ``nonzero``: the ascending column indices of
    the first ``cap`` True entries of each row of ``mask`` (rows, m), padded
    with ``fill``.  Returns int32 (rows, cap).

    The twin of ``jnp.nonzero(size=cap, fill_value=fill)``, as a cumsum plus
    a scatter: no data-dependent shape, no host sync.  Entries past the
    capacity scatter into private spill columns, so no index repeats."""
    rows, m = mask.shape
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    cols = torch.arange(m, dtype=torch.int64, device=dev).expand(rows, m)
    slot = torch.where(mask & (pos < cap), pos, cap + cols)
    out = torch.full((rows, cap + m), fill, dtype=torch.int64, device=dev)
    out.scatter_(1, slot, cols)
    return out[:, :cap].to(torch.int32)


# ---------------------------------------------------------------------------
# Packed exponent plane
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedPlane:
    payload: torch.Tensor  # int32 (n_pad // 32, width) bit-planes of residuals
    bases: torch.Tensor  # uint8 (n_blocks,) per-block minimum nonzero exponent
    exc_idx: torch.Tensor  # int32 (E,) exception block ids (n_blocks = unused)
    exc_raw: torch.Tensor  # uint8 (E, block) raw exponents of exception blocks
    overflow: torch.Tensor  # int32 scalar: 1 if exceptions overflowed capacity
    width: int
    block: int
    n: int  # original element count (pre-padding)
    exp_bits: int

    @property
    def n_blocks(self) -> int:
        return self.bases.shape[0]


def block_residuals(exp: torch.Tensor, *, width: int, block: int) -> tuple:
    """The zero-escape block codes of a uint8 exponent plane: ``(blocks``
    uint8 (nb, block) the edge-padded plane, ``base`` int32 (nb,), ``bad``
    (nb,) the blocks whose range does not fit ``width``, ``resid`` uint8
    (nb * block,) the residuals the payload packs, clamped to ``width``
    bits).  A residual is at most 255, so it travels to the pack kernel as
    one byte."""
    if block % GROUP:
        raise ValueError(f"block must be a multiple of {GROUP}, got {block}")
    blocks = _pad_to(exp, block).reshape(-1, block)
    b = blocks.to(torch.int32)
    nz = b != 0
    base = torch.where(nz, b, 255).amin(-1)
    base = torch.where(nz.any(-1), base, 1)
    mx = torch.where(nz, b, 0).amax(-1)
    bad = (mx - base + 1) >= (1 << width)
    resid = torch.where(nz, b - base[:, None] + 1, 0).clamp_max((1 << width) - 1)
    return blocks, base, bad, resid.to(torch.uint8).reshape(-1)


def pack_exponents(exp: torch.Tensor, *, width: int, block: int = 512,
                   exc_frac: float = 0.02) -> PackedPlane:
    """Encode a uint8 exponent plane into the static wire format (zero
    escape: code 0 is exponent 0, code r > 0 is ``r + base - 1``)."""
    n = exp.shape[0]
    blocks, base, bad, resid = block_residuals(exp, width=width, block=block)
    nb = blocks.shape[0]
    payload = bitplane_pack(resid, width)
    cap = exception_capacity(nb, exc_frac)
    exc_idx = first_true(bad[None], cap, nb)[0]
    rows = blocks[exc_idx.to(torch.int64).clamp_max(nb - 1)]
    exc_raw = torch.where((exc_idx < nb)[:, None], rows, 0).to(torch.uint8)
    overflow = (bad.sum() > cap).to(torch.int32)
    return PackedPlane(payload=payload, bases=base.to(torch.uint8),
                       exc_idx=exc_idx, exc_raw=exc_raw, overflow=overflow,
                       width=width, block=block, n=n, exp_bits=8)


def unpack_blocks(payload: torch.Tensor, bases: torch.Tensor,
                  exc_idx: torch.Tensor, exc_raw: torch.Tensor, *,
                  width: int, block: int) -> torch.Tensor:
    """Batched exponent decode of ``C`` packed planes: payload (C, n_g, W),
    bases (C, nb), exc_idx (C, E), exc_raw (C, E, block) -> int32
    (C, nb * block) exponents, exception blocks restored from the raw
    region (fill entries ``exc_idx == nb`` land in a discarded spare row).
    The arithmetic is int32: a code's low 8 bits plus the base wrap as the
    reference's uint32 ones do, at half the memory of int64 (a 1.1 G-value
    bucket decodes in ~13 GB of temporaries, not ~26)."""
    C, nb = bases.shape
    resid = bitplane_unpack(payload.reshape(-1, width), width).reshape(C, nb, block)
    b = bases.to(torch.int32)[:, :, None]
    blocks = torch.where(resid == 0, 0, (resid + b - 1) & 0xFF)
    blocks = torch.cat([blocks, blocks.new_zeros((C, 1, block))], dim=1)
    rows = torch.arange(C, device=bases.device)[:, None]
    blocks[rows, exc_idx.to(torch.int64)] = exc_raw.to(blocks.dtype)
    return blocks[:, :nb].reshape(C, -1)


def unpack_exponents(p: PackedPlane) -> torch.Tensor:
    """Exact inverse of :func:`pack_exponents` (when ``overflow == 0``)."""
    blocks = unpack_blocks(p.payload[None], p.bases[None], p.exc_idx[None],
                           p.exc_raw[None], width=p.width, block=p.block)
    return blocks[0, : p.n].to(torch.uint8)


# ---------------------------------------------------------------------------
# Whole-message codec: the packed lo plane plus the packed exponent plane.
#
# Message fields are tensors on the encoding device; the weight-sync engine
# carries them to the host as numpy arrays with the reference's dtypes
# (``sync/engine.host_message``), so ``wire_bytes`` takes either.
# ---------------------------------------------------------------------------

def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes


@dataclasses.dataclass(frozen=True)
class CompressedMessage:
    lo: torch.Tensor  # int32 (n_pad // 32, lo_bits) bit-planes of sign|mantissa
    exp: PackedPlane
    dtype_name: str
    shape: tuple

    def wire_bytes(self) -> int:
        e = self.exp
        return int(_nbytes(self.lo) + _nbytes(e.payload) + _nbytes(e.bases)
                   + _nbytes(e.exc_idx) + _nbytes(e.exc_raw) + 4)

    def raw_bytes(self) -> int:
        return math.prod(self.shape) * codec.LAYOUTS[self.dtype_name].total_bits // 8

    def ratio(self) -> float:
        return self.wire_bytes() / self.raw_bytes()


def encode_message(x: torch.Tensor, *, width: int, block: int = 512,
                   exc_frac: float = 0.02) -> CompressedMessage:
    """Encode a float tensor into the in-collective wire format with the
    one-pass split+pack (``kernels/ops.encode_fused``, the encode_fused
    kernel on CUDA).  Bit-identical to the reference's ``encode_message``
    in both of its forms, the fused one and the three-pass one."""
    from repro_torch.kernels import ops  # lazy: the kernels import this module

    lay = codec.layout_of(x.dtype)
    xf = x.reshape(-1)
    w = ops.encode_fused(xf, width, block=block, exc_frac=exc_frac)
    packed = PackedPlane(payload=w["payload"], bases=w["bases"],
                         exc_idx=w["exc_idx"], exc_raw=w["exc_raw"],
                         overflow=w["overflow"], width=width, block=block,
                         n=xf.shape[0], exp_bits=8)
    return CompressedMessage(lo=w["lo"], exp=packed, dtype_name=lay.name,
                             shape=tuple(x.shape))


def decode_message(m: CompressedMessage) -> torch.Tensor:
    """Exact inverse of :func:`encode_message` (when ``overflow == 0``), on
    the device of the message's tensors."""
    lay = codec.LAYOUTS[m.dtype_name]
    n = math.prod(m.shape)
    lo = bitplane_unpack(m.lo, lay.lo_bits)[:n]
    return codec.merge_planes(unpack_exponents(m.exp), lo, lay.dtype, m.shape)


# ---------------------------------------------------------------------------
# XOR-delta wire format (weight sync, ``sync/engine.py``).
#
# A warm delta is mostly zero in both planes: the exponent-delta plane packs
# with the block codec above at a narrow width (zero escape absorbs the
# untouched elements), and the lo-delta plane, which sits in the low bits,
# gets its own width packer.  Lo deltas have a carry tail (an update across a
# mantissa power boundary flips a run of bits), so the lo packer escapes per
# ELEMENT: outliers ride a static-capacity (idx, raw) list, restored exactly
# at decode.  If that list overflows, ``overflow`` is set and the sender falls
# back to a full message.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeltaPlane:
    """Width-packed lo-delta plane with element-granular exact exceptions."""

    payload: torch.Tensor  # int32 (n_pad // 32, width) bit-planes
    exc_idx: torch.Tensor  # int32 (E,) element indices (n_pad = unused slot)
    exc_raw: torch.Tensor  # int32 (E,) the reference's uint32 raw lo values
    overflow: torch.Tensor  # int32 scalar: 1 if exceptions overflowed capacity
    width: int
    n: int  # original element count (pre-padding)


def delta_planes(x: torch.Tensor, base: torch.Tensor) -> tuple:
    """The exponent-delta (uint8) and lo-delta (int32) planes of ``x`` XOR
    ``base``: what :func:`encode_delta` packs."""
    return codec.split_planes(codec.xor_delta(x, base))


def lo_delta_fit(vals: torch.Tensor, width: int) -> tuple:
    """``(v, fits, kept)`` of a lo-delta plane at ``width`` bits: ``vals``
    zero-padded to whole groups, the elements that fit, and ``v`` with the
    others zeroed, which :func:`pack_delta_plane` packs (the others escape)."""
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    v = _pad_to(vals, GROUP, pad_mode="zero")
    fits = _as_u32(v) <= (1 << width) - 1
    return v, fits, torch.where(fits, v, 0)


def pack_delta_plane(vals: torch.Tensor, width: int, *,
                     exc_frac: float = 0.02) -> DeltaPlane:
    """Pack a lo-delta stream (integer (n,), values < 2**32) at ``width``
    bits per element.  Elements that do not fit escape through a list of
    ``min(n, max(4, ceil(n * exc_frac)))`` entries; ``overflow`` reports that
    the list was too short (decode would be lossy)."""
    n = vals.shape[0]
    v, fits, kept = lo_delta_fit(vals, width)
    payload = bitplane_pack(kept, width)
    cap = min(n, max(4, int(np.ceil(n * exc_frac))))
    bad = ~fits
    n_pad = v.shape[0]
    exc_idx = first_true(bad[None], cap, n_pad)[0]
    picked = v[exc_idx.to(torch.int64).clamp_max(n_pad - 1)]
    exc_raw = _to_word(torch.where(exc_idx < n_pad, _as_u32(picked), 0))
    overflow = (bad.sum() > cap).to(torch.int32)
    return DeltaPlane(payload=payload, exc_idx=exc_idx, exc_raw=exc_raw,
                      overflow=overflow, width=width, n=n)


def unpack_delta_plane(p: DeltaPlane) -> torch.Tensor:
    """Exact inverse of :func:`pack_delta_plane` (when ``overflow == 0``):
    int32 (n,), the reference's uint32 values (fill entries land in a
    discarded spare slot)."""
    vals = bitplane_unpack(p.payload, p.width)
    vals = torch.cat([vals, vals.new_zeros((1,))])
    vals[p.exc_idx.to(torch.int64).clamp(0, vals.shape[0] - 1)] = p.exc_raw.to(vals.dtype)
    return vals[: p.n]


@dataclasses.dataclass(frozen=True)
class DeltaMessage:
    """Encoded XOR delta of one tensor against a shared base version: the
    exponent-delta plane rides the block packer, the lo-delta plane the
    width packer.  The wire size depends only on (n, widths)."""

    lo: DeltaPlane
    exp: PackedPlane
    dtype_name: str
    shape: tuple

    def wire_bytes(self) -> int:
        e, lo = self.exp, self.lo
        return int(_nbytes(lo.payload) + _nbytes(lo.exc_idx) + _nbytes(lo.exc_raw) + 4
                   + _nbytes(e.payload) + _nbytes(e.bases) + _nbytes(e.exc_idx)
                   + _nbytes(e.exc_raw) + 4)

    def raw_bytes(self) -> int:
        return math.prod(self.shape) * codec.LAYOUTS[self.dtype_name].total_bits // 8

    def ratio(self) -> float:
        return self.wire_bytes() / self.raw_bytes()

    @property
    def overflow(self):
        """1 if either plane's exceptions overflowed (decode would be lossy)."""
        return max(int(self.exp.overflow), int(self.lo.overflow))


def encode_delta(x: torch.Tensor, base: torch.Tensor, *, width: int,
                 lo_width: int, block: int = 512,
                 exc_frac: float = 0.02) -> DeltaMessage:
    """XOR ``x`` against ``base`` and encode the delta: ``width`` packs the
    exponent-delta plane, ``lo_width`` the lo-delta plane.  Bit-exact through
    :func:`decode_delta` whenever ``overflow == 0``."""
    lay = codec.layout_of(x.dtype)
    exp, lo = delta_planes(x, base)
    return DeltaMessage(
        lo=pack_delta_plane(lo, lo_width, exc_frac=exc_frac),
        exp=pack_exponents(exp, width=width, block=block, exc_frac=exc_frac),
        dtype_name=lay.name, shape=tuple(x.shape))


def delta_bits(m: DeltaMessage) -> torch.Tensor:
    """The XOR pattern a delta message carries (the new bits XOR the
    base's), as its float dtype: what :func:`decode_delta` XORs into the
    base, elementwise, so a block of it applies to the same block of the
    base alone."""
    lay = codec.LAYOUTS[m.dtype_name]
    n = math.prod(m.shape)
    lo = unpack_delta_plane(m.lo)[:n]
    return codec.merge_planes(unpack_exponents(m.exp), lo, lay.dtype, m.shape)


def decode_delta(m: DeltaMessage, base: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`encode_delta` given the same base version."""
    return codec.xor_delta(delta_bits(m), base.reshape(m.shape))
