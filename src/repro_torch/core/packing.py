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

import numpy as np
import torch

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
    (``kernels/bitpack.py``)."""
    from repro_torch.kernels import bitpack

    return bitpack.pack(vals, width)


def bitplane_unpack(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`bitplane_pack`; returns int32 (n,), the
    reference's uint32 values with the same bits (unpack kernel on CUDA)."""
    from repro_torch.kernels import bitpack

    return bitpack.unpack(packed, width)


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
    bases (C, nb), exc_idx (C, E), exc_raw (C, E, block) -> int64
    (C, nb * block) exponents, exception blocks restored from the raw
    region (fill entries ``exc_idx == nb`` land in a discarded spare row)."""
    C, nb = bases.shape
    resid = bitplane_unpack(payload.reshape(-1, width), width).reshape(C, nb, block)
    b = bases.to(torch.int64)[:, :, None]
    blocks = torch.where(resid == 0, 0, (resid + b - 1) & 0xFF)
    blocks = torch.cat([blocks, blocks.new_zeros((C, 1, block))], dim=1)
    rows = torch.arange(C, device=bases.device)[:, None]
    blocks[rows, exc_idx.to(torch.int64)] = exc_raw.to(torch.int64)
    return blocks[:, :nb].reshape(C, -1)


def unpack_exponents(p: PackedPlane) -> torch.Tensor:
    """Exact inverse of :func:`pack_exponents` (when ``overflow == 0``)."""
    blocks = unpack_blocks(p.payload[None], p.bases[None], p.exc_idx[None],
                           p.exc_raw[None], width=p.width, block=p.block)
    return blocks[0, : p.n].to(torch.uint8)
