"""Plain PyTorch versions of the CUDA kernels (torch port of
``repro.kernels.ref``).

Their wrappers use them for CPU tensors; ``chip_smoke.py`` holds each kernel
against them on the card.  They repeat the kernels' arithmetic and are no
yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.core import codec, packing

_U32 = packing._U32

# --- bitpack -----------------------------------------------------------------


def pack(vals: torch.Tensor, width: int) -> torch.Tensor:
    """Bit-plane pack of integer values (n,), n % 32 == 0: returns int32
    (n // 32, width) whose word ``[g, b]`` holds bit ``b`` of the 32 values of
    group ``g`` (value ``i`` at bit ``i``).  Each value counts with the low 32
    bits of its two's complement (the reference's cast to uint32); bits at
    ``width`` and above are dropped."""
    g = packing._as_u32(vals).reshape(-1, packing.GROUP)
    pos = torch.arange(packing.GROUP, dtype=torch.int64, device=vals.device)
    planes = [(((g >> b) & 1) << pos).sum(-1) for b in range(width)]
    if not planes:
        return torch.zeros((g.shape[0], 0), dtype=torch.int32, device=vals.device)
    return packing._to_word(torch.stack(planes, dim=-1))


def unpack(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`pack`: packed words (n_g, >= width) -> int32
    (32 * n_g,), the reference's uint32 values with the same bits."""
    p = packing._as_u32(packed)
    pos = torch.arange(packing.GROUP, dtype=torch.int64, device=packed.device)
    vals = torch.zeros((p.shape[0], packing.GROUP), dtype=torch.int64,
                       device=packed.device)
    for b in range(width):
        vals |= ((p[:, b : b + 1] >> pos) & 1) << b
    return packing._to_word(vals.reshape(-1))


# --- plane_split -------------------------------------------------------------


def split_with_stats(x: torch.Tensor, block: int = 512):
    """Split a flat float tensor (n % block == 0) into its planes, with the
    plain per-block statistics: returns (exp int32 (n,), lo int32 (n,),
    base int32 (n_blocks,), rng int32 (n_blocks,)) with ``base = min(exp)``
    and ``rng = max(exp) - base`` over every exponent of the block, zeros
    included (not the wire's zero-escape statistics)."""
    if x.shape[0] % block:
        raise ValueError(f"n={x.shape[0]} is not a multiple of block={block}")
    exp, lo = codec.split_planes(x)
    b = exp.reshape(-1, block).to(torch.int32)
    base = b.amin(-1)
    return exp.to(torch.int32), lo, base, b.amax(-1) - base


# --- encode_fused ------------------------------------------------------------


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
    payload = pack(resid.reshape(-1), width)
    lo_planes = pack(lo, lay.lo_bits)
    return payload, lo_planes, base.to(torch.int32), packing._to_word(rng)


def decode_reduce(payload: torch.Tensor, lo_planes: torch.Tensor,
                  group_bases: torch.Tensor, acc: torch.Tensor,
                  dtype_name: str, width: int) -> torch.Tensor:
    """Zero-escape wire decode + f32 accumulate: returns ``acc + decode``
    (a new tensor).  Code 0 is exponent 0, code r > 0 is ``(r + base - 1)
    & 0xFF``; the exponent is merged in the format's own width.  A wire of
    more than ``codec.MERGE_SLICE`` values decodes that many at a time."""
    lay = codec.LAYOUTS[dtype_name]
    G = packing.GROUP

    def decode(g0, g1):
        resid = unpack(payload[g0:g1], width).reshape(-1, G)
        gb = packing._as_u32(group_bases[g0:g1])[:, None]
        exp = torch.where(resid == 0, 0, (resid + gb - 1) & 0xFF).reshape(-1)
        lo = unpack(lo_planes[g0:g1], lay.lo_bits)
        return codec.from_bits(codec.merge_bits(exp, lo, lay), lay).to(torch.float32)

    acc = acc.reshape(-1)
    n_g, step = payload.shape[0], codec.MERGE_SLICE // G
    if n_g <= step:
        return acc + decode(0, n_g)
    out = torch.empty(acc.shape, dtype=torch.promote_types(acc.dtype, torch.float32),
                      device=acc.device)
    for g0 in range(0, n_g, step):
        g1 = min(g0 + step, n_g)
        out[g0 * G:g1 * G] = acc[g0 * G:g1 * G] + decode(g0, g1)
    return out


# --- rans (dense emission; the reference's ``kernels/ref.py`` formulation) ----
#
# One rANS stream per lane of a (per, lanes) symbol grid: 32-bit state,
# 16-bit renormalisation, L = 1 << 16, PROB_BITS = 12.  The arithmetic runs
# in int64 and is masked to 32 bits wherever the reference's uint32 wraps.
# ``n_valid``: symbols at flat index >= n_valid (row-major over (per,
# lanes)) leave the state as it is and emit nothing, as ``core/ans.py``
# masks its padding; ``n_valid = per * lanes`` is the TPU kernels' contract.

PROB_BITS = 12
M = 1 << PROB_BITS
RANS_L = 1 << 16


def _valid(per: int, lanes: int, n_valid, device) -> tuple:
    n_valid = per * lanes if n_valid is None else int(n_valid)
    lane = torch.arange(lanes, dtype=torch.int64, device=device)
    return lane, n_valid


def rans_encode(syms: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor,
                n_valid=None):
    """Encode symbols (per, lanes) with the table ``freq``/``cum`` (256
    entries used).  Returns (words int32 (per, lanes), mask int32 (per,
    lanes), state int32 (lanes,)): row r of ``words`` holds the 16-bit word
    the lane emitted while encoding row r (0 where it emitted none, and then
    ``mask`` is 0), and ``state`` the final states, as 32-bit words.  Rows
    are encoded from ``per - 1`` down to 0, so decoding runs forward."""
    per, lanes = syms.shape
    dev = syms.device
    lane, n_valid = _valid(per, lanes, n_valid, dev)
    f_tab = packing._as_u32(freq.reshape(-1)[:256])
    c_tab = packing._as_u32(cum.reshape(-1)[:256])
    s = syms.to(torch.int64)
    state = torch.full((lanes,), RANS_L, dtype=torch.int64, device=dev)
    words = torch.zeros((per, lanes), dtype=torch.int64, device=dev)
    mask = torch.zeros((per, lanes), dtype=torch.bool, device=dev)
    x_step = (RANS_L >> PROB_BITS) << 16
    for r in range(per - 1, -1, -1):
        v = r * lanes + lane < n_valid
        f, c = f_tab[s[r]], c_tab[s[r]]
        need = (state >= ((x_step * f) & _U32)) & v
        words[r] = torch.where(need, state & 0xFFFF, 0)
        mask[r] = need
        state = torch.where(need, state >> 16, state)
        q = state // f
        new = ((q << PROB_BITS) + (state - q * f) + c) & _U32
        state = torch.where(v, new, state)
    return (words.to(torch.int32), mask.to(torch.int32),
            packing._to_word(state))


def _decode_step(state, f_tab, c_tab, s2s):
    slot = state & (M - 1)
    sym = s2s[slot]
    f, c = f_tab[sym], c_tab[sym]
    return sym, (f * (state >> PROB_BITS) + slot - c) & _U32


def rans_decode(words: torch.Tensor, state: torch.Tensor, freq: torch.Tensor,
                cum: torch.Tensor, s2s: torch.Tensor, n_valid=None) -> torch.Tensor:
    """Inverse of :func:`rans_encode` on the dense buffer: words (per,
    lanes) and the final states (lanes,) as 32-bit words; ``s2s`` the
    slot -> symbol table (M,).  Returns uint8 symbols (per, lanes) (at an
    invalid position, the symbol the state points to)."""
    per, lanes = words.shape
    dev = words.device
    lane, n_valid = _valid(per, lanes, n_valid, dev)
    f_tab = packing._as_u32(freq.reshape(-1)[:256])
    c_tab = packing._as_u32(cum.reshape(-1)[:256])
    s2s = s2s.to(torch.int64)
    w = packing._as_u32(words)
    st = packing._as_u32(state)
    out = torch.empty((per, lanes), dtype=torch.uint8, device=dev)
    for r in range(per):
        v = r * lanes + lane < n_valid
        sym, new = _decode_step(st, f_tab, c_tab, s2s)
        need = (new < RANS_L) & v
        new = torch.where(need, ((new << 16) | w[r]) & _U32, new)
        st = torch.where(v, new, st)
        out[r] = sym.to(torch.uint8)
    return out


def rans_decode_stream(words: torch.Tensor, lens: torch.Tensor,
                       freq: torch.Tensor, cum: torch.Tensor, s2s: torch.Tensor,
                       per: int, n_valid=None) -> torch.Tensor:
    """:func:`rans_decode` reading each lane's COMPACTED stream (the wire of
    ``core/ans.py``): words uint16 (lanes, cap) holds the words lane j
    emitted, in the encoder's order, then the two flush words (low, high
    half of the final state); ``lens`` (lanes,) counts them.  The state
    starts from the flush words and pulls words LIFO from ``lens - 3`` down.
    Returns uint8 symbols (per, lanes)."""
    lanes = words.shape[0]
    dev = words.device
    lane, n_valid = _valid(per, lanes, n_valid, dev)
    f_tab = packing._as_u32(freq.reshape(-1)[:256])
    c_tab = packing._as_u32(cum.reshape(-1)[:256])
    s2s = s2s.to(torch.int64)
    w = words.view(torch.int16).to(torch.int64) & 0xFFFF
    ptr = lens.to(torch.int64) - 2
    st = w[lane, ptr] | (w[lane, ptr + 1] << 16)
    out = torch.empty((per, lanes), dtype=torch.uint8, device=dev)
    for r in range(per):
        v = r * lanes + lane < n_valid
        sym, new = _decode_step(st, f_tab, c_tab, s2s)
        need = (new < RANS_L) & v
        ptr = ptr - need.to(torch.int64)
        word = w[lane, ptr.clamp_min(0)]
        st = torch.where(v, torch.where(need, ((new << 16) | word) & _U32, new), st)
        out[r] = sym.to(torch.uint8)
    return out
