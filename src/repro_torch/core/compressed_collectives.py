"""Compression-integrated collectives over ``torch.distributed`` (paper §3.4,
Fig. 9); torch port of ``repro.core.compressed_collectives``.

The two phases of the two-shot all-reduce, which ZeRO-1 drives:

  * :func:`reduce_scatter_compressed` encodes each destination chunk in one
    pass (``kernels/ops.encode_fused_chunks``), ships the packed planes with
    ``all_to_all``, and streams every received chunk, in rank order, through
    the fused decode+reduce into the f32 accumulator
    (:func:`_decode_reduce_chunks`), patching exception blocks exactly;
  * :func:`all_gather_compressed` encodes the local shard once and decodes
    the gathered wire (plain PyTorch on the device, as the reference's jnp).

Every reduce accumulates in f32 in rank order (:func:`_seq_sum`), so the
compressed and raw paths are bit-identical.  Each primitive returns
``(value, overflow_flag)``; the training loop retries the step uncompressed
when the flag fires.  Wire words travel as ``int32``/``uint8`` (gloo and
NCCL both move them); raw floats travel as their bytes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import codec, packing
from repro_torch.core.policy import WireReport, record_wire_report
from repro_torch.kernels import ops as kernel_ops


def _pad_flat(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad a flat tensor to a multiple, in the bits domain."""
    r = (-x.shape[0]) % multiple
    if r == 0:
        return x
    lay = codec.layout_of(x.dtype)
    bits = x.view(lay.bits_dtype)
    return torch.cat([bits, bits.new_zeros(r)]).view(x.dtype)


def _seq_sum(vals: torch.Tensor, acc_dtype=torch.float32) -> torch.Tensor:
    """Rank-order accumulation over axis 0: zeros, then += row 0, 1, ...
    The same order as the fused streaming decode+reduce."""
    acc = torch.zeros(vals.shape[1:], dtype=acc_dtype, device=vals.device)
    for v in vals:
        acc = acc + v.to(acc_dtype)
    return acc


# ---------------------------------------------------------------------------
# raw wires
# ---------------------------------------------------------------------------

def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Exchange rows of ``t`` (leading axis = destination rank)."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Gather ``t`` (leading axis of size 1) from every rank, rank order."""
    n_dev = dist.get_world_size(group)
    out = t.new_empty((n_dev,) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def raw_all_to_all(x2d: torch.Tensor, group) -> torch.Tensor:
    """Uncompressed all_to_all of ``(n_dev, chunk)`` rows, as bytes."""
    return _all_to_all(x2d.contiguous().view(torch.uint8), group).view(x2d.dtype)


def raw_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Uncompressed tiled all-gather of a flat tensor, as bytes."""
    got = _all_gather(x.contiguous().view(torch.uint8)[None], group)
    return got.view(x.dtype).reshape(-1)


# ---------------------------------------------------------------------------
# chunk codec
# ---------------------------------------------------------------------------

def _encode_chunks(x2d: torch.Tensor, *, width: int, block: int,
                   exc_frac: float) -> dict:
    """Transmit-side encode of ``(n_chunks, chunk)`` rows in one pass."""
    return kernel_ops.encode_fused_chunks(x2d, width, block=block,
                                          exc_frac=exc_frac)


def _decode_chunks(wire: dict, *, dtype, n: int, width: int, block: int):
    """Decode every chunk of a wire dict.  Returns (vals (C, n), flag)."""
    lay = codec.layout_of(dtype)
    C = wire["payload"].shape[0]
    exp = packing.unpack_blocks(wire["payload"], wire["bases"], wire["exc_idx"],
                                wire["exc_raw"], width=width, block=block)
    lo = packing.bitplane_unpack(wire["lo"].reshape(-1, lay.lo_bits), lay.lo_bits)
    bits = codec.merge_bits(exp[:, :n], lo.reshape(C, -1)[:, :n], lay)
    return codec.from_bits(bits, lay), wire["overflow"].max()


def wire_nbytes(wire: dict) -> int:
    """Static wire size of an encoded chunk dict."""
    return sum(v.numel() * v.element_size() for v in wire.values())


def encode_hbm_bytes_for(n_elems: int, itemsize: int) -> int:
    """Split-plane round-trip an UNFUSED encode would pay, 2*(1+itemsize)
    B/element; the fused one-pass encode eliminates it."""
    return int(2 * (1 + itemsize) * n_elems)


def _record_collective(name: str, group, *, raw_bytes: int, wire: dict,
                       fused: bool, decoded_elems: int = 0,
                       encoded_elems: int = 0, itemsize: int = 0) -> None:
    """The WireReport of one compressed wire.  ``fused``: the receive side
    reduced while it decoded (reduce-scatter), so the decoded-float
    round-trip of ``decoded_elems`` was eliminated."""
    record_wire_report(WireReport(
        name=name,
        axis=f"{dist.get_backend(group)}:{dist.get_world_size(group)}",
        raw_bytes=int(raw_bytes),
        wire_bytes=wire_nbytes(wire),
        fused=fused,
        decode_hbm_bytes=int(8 * decoded_elems),
        encode_fused=True,
        encode_hbm_bytes=encode_hbm_bytes_for(encoded_elems, itemsize),
    ))


def _decode_reduce_chunks(wire: dict, *, dtype, n: int, width: int,
                          block: int, acc: torch.Tensor | None = None):
    """Fused streaming decode+reduce over received chunks, in rank order.

    Each chunk runs the in-place decode+reduce kernel and then patches its
    exception blocks EXACTLY: their accumulator rows are saved before the
    kernel and rewritten as ``saved + exact`` afterwards, which keeps the
    rank accumulation order bit for bit.  The accumulator lives in a buffer
    with one spare block, where the unused capacity entries (``exc_idx ==
    nb``) read and write harmlessly, so no step needs the host.
    ``n % block == 0``.  Returns ``(acc f32 (n,), overflow_flag)``."""
    lay = codec.layout_of(dtype)
    if n % block:
        raise ValueError(f"n={n} is not a multiple of block={block}")
    nb, gpb = n // block, block // packing.GROUP
    dev = wire["payload"].device
    buf = torch.zeros(n + block, dtype=torch.float32, device=dev)
    if acc is not None:
        buf[:n] = acc
    acc = buf[:n]
    in_block = torch.arange(block, device=dev)
    in_groups = torch.arange(gpb, device=dev)
    for c in range(wire["payload"].shape[0]):
        exc_idx = wire["exc_idx"][c].to(torch.int64)  # (cap,); nb = unused
        pos = (exc_idx[:, None] * block + in_block).reshape(-1)
        saved = buf[pos]
        grp = (exc_idx.clamp_max(nb - 1)[:, None] * gpb + in_groups).reshape(-1)
        lo_vals = packing.bitplane_unpack(wire["lo"][c][grp], lay.lo_bits)
        exact = codec.from_bits(codec.merge_bits(
            wire["exc_raw"][c].reshape(-1), lo_vals, lay), lay).to(torch.float32)
        group_bases = wire["bases"][c].to(torch.int32).repeat_interleave(gpb)
        kernel_ops.decode_reduce(wire["payload"][c], wire["lo"][c], group_bases,
                                 acc, lay.name, width)
        buf[pos] = saved + exact
    return acc, wire["overflow"].max()


# ---------------------------------------------------------------------------
# two-shot phases
# ---------------------------------------------------------------------------

def reduce_scatter_compressed(x: torch.Tensor, group=None, *, width: int,
                              block: int = 512, exc_frac: float = 0.02):
    """Compressed reduce-scatter of a flat tensor over ``group``: rank i ends
    with ``sum_j chunk_i(rank j)`` in f32.  Returns (chunk sum (chunk,),
    overflow_flag)."""
    n_dev = dist.get_world_size(group)
    chunks = _pad_flat(x.reshape(-1), n_dev * block).reshape(n_dev, -1)
    wire = _encode_chunks(chunks, width=width, block=block, exc_frac=exc_frac)
    recv = {k: _all_to_all(v, group) for k, v in wire.items()}
    _record_collective(
        "reduce_scatter", group, raw_bytes=chunks.numel() * x.element_size(),
        wire=wire, fused=True, decoded_elems=chunks.numel(),
        encoded_elems=chunks.numel(),
        itemsize=x.element_size())
    return _decode_reduce_chunks(recv, dtype=x.dtype, n=chunks.shape[1],
                                 width=width, block=block)


def all_gather_compressed(y: torch.Tensor, group=None, *, width: int,
                          block: int = 512, exc_frac: float = 0.02):
    """Compressed all-gather of a flat local chunk: one encode at the source,
    one decode of the gathered wire.  Returns (stacked (n_dev, chunk),
    overflow_flag)."""
    n_dev = dist.get_world_size(group)
    yf = _pad_flat(y.reshape(-1), block)
    wire = _encode_chunks(yf[None], width=width, block=block, exc_frac=exc_frac)
    gathered = {k: _all_gather(v, group) for k, v in wire.items()}
    _record_collective(
        "all_gather", group, raw_bytes=n_dev * yf.numel() * y.element_size(),
        wire=gathered, fused=False, encoded_elems=yf.numel(),
        itemsize=y.element_size())
    return _decode_chunks(gathered, dtype=y.dtype, n=yf.shape[0], width=width,
                          block=block)
