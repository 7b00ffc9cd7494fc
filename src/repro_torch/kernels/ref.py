"""Plain PyTorch versions of the CUDA kernels (torch port of
``repro.kernels.ref``).

Their wrappers use them for CPU tensors; ``chip_smoke.py`` holds each kernel
against them on the card.  They repeat the kernels' arithmetic and are no
yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.core import codec, packing


def encode_fused(x: torch.Tensor, width: int, block: int = 512):
    """Split + zero-escape block stats + bit-plane pack of a flat float
    tensor, ``n % block == 0``.  Returns (payload int32 (n//32, width),
    lo_planes int32 (n//32, lo_bits), bases int32 (n_blocks,), rng int32
    (n_blocks,)); the int32 tensors hold the reference's uint32 bits.
    ``rng`` is the max residual code (``rng < 2**width`` iff the block is not
    an exception; 0 for an all-zero block, by uint32 wrap-around)."""
    lay = codec.layout_of(x.dtype)
    if x.shape[0] % block:
        raise ValueError(f"n={x.shape[0]} is not a multiple of block={block}")
    exp, lo = codec.split_planes(x)
    b = exp.reshape(-1, block).to(torch.int64)
    nz = b != 0
    base = torch.where(nz, b, 255).amin(-1)
    base = torch.where(nz.any(-1), base, 1)
    mx = torch.where(nz, b, 0).amax(-1)
    rng = (mx - base + 1) & packing._U32
    resid = torch.where(nz, b - base[:, None] + 1, 0).clamp_max((1 << width) - 1)
    payload = packing.bitplane_pack(resid.reshape(-1), width)
    lo_planes = packing.bitplane_pack(lo, lay.lo_bits)
    return payload, lo_planes, base.to(torch.int32), packing._to_word(rng)


def decode_reduce(payload: torch.Tensor, lo_planes: torch.Tensor,
                  group_bases: torch.Tensor, acc: torch.Tensor,
                  dtype_name: str, width: int) -> torch.Tensor:
    """Zero-escape wire decode + f32 accumulate: returns ``acc + decode``
    (a new tensor).  Code 0 is exponent 0, code r > 0 is ``(r + base - 1)
    & 0xFF``; the exponent is merged in the format's own width."""
    lay = codec.LAYOUTS[dtype_name]
    resid = packing.bitplane_unpack(payload, width).reshape(-1, packing.GROUP)
    gb = packing._as_u32(group_bases)[:, None]
    exp = torch.where(resid == 0, 0, (resid + gb - 1) & 0xFF).reshape(-1)
    lo = packing.bitplane_unpack(lo_planes, lay.lo_bits)
    vals = codec.from_bits(codec.merge_bits(exp, lo, lay), lay).to(torch.float32)
    return acc.reshape(-1) + vals
