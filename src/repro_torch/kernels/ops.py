"""Public entry points of the kernels (torch port of ``repro.kernels.ops``).

Dispatch is by the tensor's device: a CUDA tensor goes to the CUDA kernel,
a CPU tensor to its plain PyTorch version (the wrappers in
``encode_fused.py``, ``decode_reduce.py`` and ``plane_split.py`` decide).
There is no switch and no counted fallback.  The bit-plane and rANS kernels
are reached through ``core/packing.py`` and ``core/ans.py``.

:func:`encode_fused` / :func:`encode_fused_chunks` produce the complete wire
dict ``{lo, payload, bases, exc_idx, exc_raw, overflow}`` in one pass over
the input plus a gather of the (at most ``exc_frac`` of) exception rows.
Ragged input is padded to the block multiple only, with an
exponent-preserving pad element (:func:`_edge_exp_pad`).
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core import codec, packing
from repro_torch.kernels import decode_reduce as _decode_reduce
from repro_torch.kernels import encode_fused as _encode_fused
from repro_torch.kernels import plane_split as _plane_split

GROUP = packing.GROUP


def decode_reduce(payload, lo_planes, group_bases, acc, dtype_name: str,
                  width: int) -> torch.Tensor:
    """``acc += decode(wire)`` in place (kernel on CUDA, plain on CPU);
    returns ``acc``.  A view off a 16-byte boundary runs on an aligned copy
    (:func:`kernels.aligned`); an accumulator's copy is copied back."""
    work = kernels.aligned(acc)
    _decode_reduce.decode_reduce(kernels.aligned(payload), kernels.aligned(lo_planes),
                                 kernels.aligned(group_bases), work, dtype_name, width)
    return acc if work is acc else acc.copy_(work)


def split_with_stats(x: torch.Tensor, block: int = 512):
    """Split a flat float tensor of whole blocks into (exp, lo) planes with
    the plain per-block ``min`` and ``max - min`` of the exponents (kernel on
    CUDA, plain on CPU); a ragged n raises."""
    return _plane_split.split_with_stats(x, block)


def _pad_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _edge_exp_pad(x: torch.Tensor, lay: codec.FloatLayout) -> torch.Tensor:
    """The (1,)-shaped pad element for ragged encodes: ``x[-1]``'s exponent
    field with zero sign/mantissa.  Padding with it edge-pads the exponent
    plane and zero-pads the lo plane at once, so the one-pass encode of the
    padded input is bit-identical to the unfused composition on ragged n."""
    bits = codec.to_bits(x[-1:])
    return codec.from_bits(bits & (((1 << lay.exp_bits) - 1) << lay.mant_bits), lay)


def _exceptions_from(x_blocks: torch.Tensor, rng: torch.Tensor,
                     lay: codec.FloatLayout, width: int, cap: int):
    """Exception extraction on the per-block stats of ``C`` rows:
    x_blocks float (C, nb, block), rng int32 (C, nb).  Returns exc_idx int32
    (C, cap) (ascending, filled with nb), exc_raw uint8 (C, cap, block) and
    overflow int32 (C,).  Re-reads only the (at most ``cap``) exception rows
    of the input.  Mirrors ``packing.pack_exponents``."""
    C, nb, block = x_blocks.shape
    bad = packing._as_u32(rng) > (1 << width) - 1
    exc_idx = packing.first_true(bad, cap, nb)
    rows = torch.arange(C, device=rng.device)[:, None]
    picked = x_blocks.view(lay.bits_dtype)[rows, exc_idx.to(torch.int64).clamp_max(nb - 1)]
    exp, _ = codec.split_planes(picked.view(lay.dtype))
    exc_raw = torch.where((exc_idx < nb)[:, :, None],
                          exp.reshape(C, cap, block), 0).to(torch.uint8)
    overflow = (bad.sum(-1) > cap).to(torch.int32)
    return exc_idx, exc_raw, overflow


def _pad_edge(x: torch.Tensor, lay: codec.FloatLayout, target: int) -> torch.Tensor:
    if target == x.shape[0]:
        return x
    pad = _edge_exp_pad(x, lay).view(lay.bits_dtype).expand(target - x.shape[0])
    return torch.cat([x.view(lay.bits_dtype), pad]).view(lay.dtype)


def encode_fused(x: torch.Tensor, width: int, *, block: int = 512,
                 exc_frac: float = 0.02) -> dict:
    """One-pass transmit-side encode of a flat float tensor (any n >= 1).

    Returns the wire dict, bit-identical field by field to the reference's
    ``kernels/ops.encode_fused``: ``payload`` covers n padded to a block
    multiple, ``lo`` covers n padded to a GROUP multiple."""
    lay = codec.layout_of(x.dtype)
    n = x.shape[0]
    n_blk = _pad_up(n, block)
    w = encode_fused_chunks(_pad_edge(x, lay, n_blk)[None], width, block=block,
                            exc_frac=exc_frac)
    w = {k: v[0] for k, v in w.items()}
    w["lo"] = w["lo"][: _pad_up(n, GROUP) // GROUP]
    return w


def encode_fused_chunks(x2d: torch.Tensor, width: int, *, block: int = 512,
                        exc_frac: float = 0.02) -> dict:
    """Fused encode of ``(n_chunks, chunk)`` rows, ``chunk % block == 0``:
    ONE kernel launch over the flattened rows (blocks never straddle
    chunks), then exceptions per chunk.  The wire dict layout of
    ``compressed_collectives._encode_chunks``."""
    lay = codec.layout_of(x2d.dtype)
    n_chunks, chunk = x2d.shape
    if chunk % block:
        raise ValueError(f"chunk={chunk} is not a multiple of block={block}")
    nb_c, gpc = chunk // block, chunk // GROUP
    x2d = kernels.aligned(x2d.contiguous())
    pay, lo, bases, rng = _encode_fused.encode_fused(x2d.reshape(-1), width, block)
    cap = packing.exception_capacity(nb_c, exc_frac)
    exc_idx, exc_raw, overflow = _exceptions_from(
        x2d.reshape(n_chunks, nb_c, block), rng.reshape(n_chunks, nb_c), lay,
        width, cap)
    return {
        "lo": lo.reshape(n_chunks, gpc, lay.lo_bits),
        "payload": pay.reshape(n_chunks, gpc, width),
        "bases": bases.reshape(n_chunks, nb_c).to(torch.uint8),
        "exc_idx": exc_idx,
        "exc_raw": exc_raw,
        "overflow": overflow,
    }
