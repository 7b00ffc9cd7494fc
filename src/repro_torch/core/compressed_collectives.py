"""Compression-integrated collectives over ``torch.distributed`` (paper §3.4,
Fig. 9); torch port of ``repro.core.compressed_collectives``.

Primitives:

  * :func:`psum_compressed`: the all-reduce.  ``two_shot`` (the paper's,
    Fig. 9) is a compressed reduce-scatter and a compressed all-gather, one
    encode and one decode a phase; ``ring`` (the paper's negative baseline,
    :func:`psum_compressed_ring`) encodes and decodes at every hop.  Tensors
    the policy leaves raw take the byte-exact raw two-shot
    (:func:`psum_raw_twoshot`) or, when small, an f32-promoted
    ``all_reduce`` (:func:`psum_safe`);
  * :func:`reduce_scatter_compressed` / :func:`all_gather_compressed`: the
    two phases, which ZeRO-1 drives.  The reduce-scatter encodes each
    destination chunk, ships the packed planes with ``all_to_all`` and
    streams every received chunk, in rank order, through the fused
    decode+reduce into the f32 accumulator (:func:`_decode_reduce_chunks`),
    patching exception blocks exactly; ``use_fused=False`` decodes first and
    sums after.  The all-gather encodes the local shard once and decodes the
    gathered wire;
  * :func:`psum_compressed_hierarchical`: reduce within the intra group,
    all-reduce the shards across the inter group, gather within the intra
    group;
  * :func:`all_to_all_compressed` (MoE dispatch, Fig. 8a) and
    :func:`ppermute_compressed` (P2P, Fig. 7);
  * :func:`tree_psum_compressed`: one two-shot bucket per dtype of a
    pytree, the gradient sync of data parallelism.

Every send encodes in one pass (``kernels/ops.encode_fused_chunks``) unless
``fused_encode=False``, which splits the planes and packs them
(``codec.split_planes``, ``packing.bitplane_pack``,
``packing.pack_exponents``); both give the same wire.

Transport and gate: every function takes a ``torch.distributed`` group as
its transport (``None``: the world) and, where the policy decides, an
``axis_name`` label ("data", "pod", "model") that the policy's
``should_compress`` and the plan keys read, as the reference's mesh axis
names.  A ppermute (:func:`raw_ppermute`, also the ring's hop) is one
``all_to_all_single`` whose split sizes are zero for every rank but the
source and the target: it runs on NCCL at one rank (a send to itself) and
on gloo at 2-4 ranks, where ``batch_isend_irecv`` would need a send to
itself at one rank.  :func:`raw_ppermute_start` issues one without waiting
(the early lo-plane send of ``core/split_send.split_send``).

Every reduce accumulates in f32 in rank order (:func:`_seq_sum`), so the
compressed and raw paths, fused and unfused, are bit-identical.  Each
primitive returns ``(value, overflow_flag)``; the training loop retries the
step uncompressed when the flag fires.  Wire words travel as
``int32``/``uint8`` (gloo and NCCL both move them); raw floats travel as
their bytes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import codec, packing
from repro_torch.core.policy import CompressionPolicy, WireReport, record_wire_report
from repro_torch.kernels import ops as kernel_ops

# sub-f32 floats that psum_safe promotes to f32 on the wire
_PROMOTE = (torch.bfloat16, torch.float16, torch.float8_e4m3fn, torch.float8_e5m2)
# the integer type of each element size, for moves and pads in the bits domain
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _pad_flat(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad a flat tensor to a multiple, in the bits domain."""
    return _pad_rows(x[None], multiple)[0]


def _pad_rows(x2d: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad every row of a 2-D tensor to a multiple, in the bits domain
    (a float copy would drop NaN payloads)."""
    r = (-x2d.shape[1]) % multiple
    if r == 0:
        return x2d
    bits = x2d.view(_BITS[x2d.element_size()])
    return torch.cat([bits, bits.new_zeros((x2d.shape[0], r))], 1).view(x2d.dtype)


def _seq_sum(vals: torch.Tensor, acc_dtype=torch.float32) -> torch.Tensor:
    """Rank-order accumulation over axis 0: zeros, then += row 0, 1, ...
    The same order as the fused streaming decode+reduce."""
    acc = torch.zeros(vals.shape[1:], dtype=acc_dtype, device=vals.device)
    for v in vals:
        acc = acc + v.to(acc_dtype)
    return acc


def _no_flag(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=like.device)


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
    """Uncompressed all_to_all of ``(n_dev, ...)`` rows, as bytes."""
    return _all_to_all(x2d.contiguous().view(torch.uint8), group).view(x2d.dtype)


def raw_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Uncompressed tiled all-gather of a flat tensor, as bytes."""
    got = _all_gather(x.contiguous().view(torch.uint8)[None], group)
    return got.view(x.dtype).reshape(-1)


class PendingPermute:
    """A ppermute in flight (:func:`raw_ppermute_start`): the receive
    buffer, the ``Work`` of its ``all_to_all_single`` and the tensors the
    backend reads or writes until :meth:`wait` (NCCL runs the op on its own
    stream, gloo on a thread of its own, so neither may be freed or written
    before then)."""

    def __init__(self, t: torch.Tensor, send: torch.Tensor, out: torch.Tensor,
                 work, received: bool):
        self.out, self.work = out, work
        self._send, self._received = send, received
        self._dtype, self._shape = t.dtype, t.shape

    def wait(self) -> torch.Tensor:
        """The received tensor, of the sent one's shape and dtype; a rank
        that no pair targets gets zeros."""
        self.work.wait()
        out = self.out if self._received else self._send.new_zeros(self._send.numel())
        self._send = None
        return out.view(self._dtype).reshape(self._shape)


def check_perm(perm) -> None:
    """Refuse a ``perm`` that repeats a source or a target, on every rank
    alike, as the reference's ``lax.ppermute`` refuses it: a rank that
    checked only its own pairs would enter a collective that the offending
    rank never joins."""
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"perm {perm} repeats a source or a target")


def raw_ppermute_start(t: torch.Tensor, group, perm) -> PendingPermute:
    """Issue an uncompressed ppermute of ``t`` along ``perm`` (``(source,
    target)`` group ranks), as bytes, and return without waiting: one
    ``all_to_all_single(async_op=True)`` whose splits are empty but toward
    this rank's target and from its source.  Work queued after it on the
    current stream overlaps with the transfer (the reference gets this from
    XLA's scheduler when nothing depends on the send)."""
    check_perm(perm)
    me, k = dist.get_rank(group), dist.get_world_size(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    nbytes = flat.numel()
    out = flat.new_empty(nbytes if src else 0)
    work = dist.all_to_all_single(
        out, flat if dst else flat[:0],
        output_split_sizes=[nbytes if src and j == src[0] else 0 for j in range(k)],
        input_split_sizes=[nbytes if dst and j == dst[0] else 0 for j in range(k)],
        group=group, async_op=True)
    return PendingPermute(t, flat, out, work, bool(src))


def raw_ppermute(t: torch.Tensor, group, perm) -> torch.Tensor:
    """Uncompressed ppermute of ``t`` along ``perm``: start, then wait
    (:func:`raw_ppermute_start`).  A rank that no pair targets gets zeros,
    as in the reference's ``ppermute``."""
    return raw_ppermute_start(t, group, perm).wait()


def psum_safe(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_reduce`` that promotes sub-f32 floats to f32 on the wire: for
    small tensors and leaves outside the codec.  The summation order is the
    backend's."""
    acc = x.to(torch.float32) if x.dtype in _PROMOTE else x.clone()
    dist.all_reduce(acc, group=group)
    return acc.to(x.dtype)


def psum_raw_twoshot(x: torch.Tensor, group=None, *, acc_dtype=torch.float32):
    """Uncompressed all-reduce as all_to_all + rank-order sum + all-gather:
    the byte-exact raw twin of the compressed two-shot (it moves
    ``2 (k - 1) / k`` of the bytes at the wire dtype)."""
    n_dev = dist.get_world_size(group)
    rows = _pad_flat(x.reshape(-1), n_dev).reshape(n_dev, -1)
    red = _seq_sum(raw_all_to_all(rows, group), acc_dtype).to(x.dtype)
    return raw_all_gather(red, group)[: x.numel()].reshape(x.shape)


# ---------------------------------------------------------------------------
# chunk codec
# ---------------------------------------------------------------------------

def _encode_chunks(x2d: torch.Tensor, *, width: int, block: int,
                   exc_frac: float, fused: bool = True) -> dict:
    """Transmit-side encode of ``(n_chunks, chunk)`` rows.

    ``fused``: one pass (``kernels/ops.encode_fused_chunks``, the
    encode_fused kernel on CUDA); the chunk must be a block multiple, and
    raises otherwise where the reference records a fallback (every
    collective pads its chunks to a block multiple).  Unfused: per row,
    split the planes, pack the zero-padded lo plane and pack the exponents
    (the pack kernel on CUDA, twice a row).  Both give the same wire."""
    if fused:
        return kernel_ops.encode_fused_chunks(x2d, width, block=block,
                                              exc_frac=exc_frac)
    lay = codec.layout_of(x2d.dtype)
    rows = []
    for row in x2d:
        exp, lo = codec.split_planes(row)
        pk = packing.pack_exponents(exp, width=width, block=block, exc_frac=exc_frac)
        rows.append({
            "lo": packing.bitplane_pack(packing._pad_to(lo, packing.GROUP, "zero"),
                                        lay.lo_bits),
            "payload": pk.payload, "bases": pk.bases, "exc_idx": pk.exc_idx,
            "exc_raw": pk.exc_raw, "overflow": pk.overflow})
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def _decode_chunks(wire: dict, *, dtype, n: int, width: int, block: int):
    """Decode every chunk of a wire dict.  Returns (vals (C, n), flag).  A
    wire of more than ``codec.MERGE_SLICE`` values a chunk merges that many
    columns at a time into the output."""
    lay = codec.layout_of(dtype)
    C = wire["payload"].shape[0]
    exp = packing.unpack_blocks(wire["payload"], wire["bases"], wire["exc_idx"],
                                wire["exc_raw"], width=width, block=block)
    lo = packing.bitplane_unpack(wire["lo"].reshape(-1, lay.lo_bits),
                                 lay.lo_bits).reshape(C, -1)
    if n <= codec.MERGE_SLICE:
        return codec.from_bits(codec.merge_bits(exp[:, :n], lo[:, :n], lay), lay), \
            wire["overflow"].max()
    out = torch.empty((C, n), dtype=lay.dtype, device=exp.device)
    for s0 in range(0, n, codec.MERGE_SLICE):
        s1 = min(s0 + codec.MERGE_SLICE, n)
        out[:, s0:s1] = codec.from_bits(codec.merge_bits(exp[:, s0:s1], lo[:, s0:s1], lay),
                                        lay)
    return out, wire["overflow"].max()


def wire_nbytes(wire: dict) -> int:
    """Static wire size of an encoded chunk dict."""
    return sum(v.numel() * v.element_size() for v in wire.values())


def encode_hbm_bytes_for(n_elems: int, itemsize: int) -> int:
    """Split-plane round-trip an UNFUSED encode pays, 2*(1+itemsize)
    B/element; the fused one-pass encode eliminates it."""
    return int(2 * (1 + itemsize) * n_elems)


def _record_collective(name: str, axis_name, *, raw_bytes: int, wire: dict,
                       fused: bool, decoded_elems: int = 0,
                       encoded_elems: int = 0, itemsize: int = 0,
                       encode_fused: bool = True) -> None:
    """The WireReport of one compressed wire.  ``fused``: the receive side
    reduced while it decoded, so the decoded-float round-trip of
    ``decoded_elems`` was eliminated; ``encode_fused``: the send encoded in
    one pass, so the split-plane round-trip of ``encoded_elems`` was."""
    record_wire_report(WireReport(
        name=name,
        axis=str(axis_name),
        raw_bytes=int(raw_bytes),
        wire_bytes=wire_nbytes(wire),
        fused=bool(fused),
        decode_hbm_bytes=int(8 * decoded_elems),
        encode_fused=bool(encode_fused),
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
# two-shot all-reduce (paper Fig. 9) and its phases
# ---------------------------------------------------------------------------

def reduce_scatter_compressed(x: torch.Tensor, group=None, *, width: int,
                              block: int = 512, exc_frac: float = 0.02,
                              acc_dtype=torch.float32, use_fused: bool = True,
                              fused_encode: bool = True, axis_name="data"):
    """Compressed reduce-scatter of a flat tensor over ``group``: rank i ends
    with ``sum_j chunk_i(rank j)`` in ``acc_dtype``.  The receive side is the
    fused decode+reduce unless ``use_fused=False`` or ``acc_dtype`` is not
    f32 (the kernel accumulates in f32 only); then it decodes every chunk
    and sums in rank order, to the same bits.  Returns (chunk sum (chunk,),
    overflow_flag)."""
    n_dev = dist.get_world_size(group)
    chunks = _pad_flat(x.reshape(-1), n_dev * block).reshape(n_dev, -1)
    wire = _encode_chunks(chunks, width=width, block=block, exc_frac=exc_frac,
                          fused=fused_encode)
    recv = {k: _all_to_all(v, group) for k, v in wire.items()}
    fused = use_fused and acc_dtype == torch.float32
    _record_collective(
        "reduce_scatter", axis_name, raw_bytes=chunks.numel() * x.element_size(),
        wire=wire, fused=fused, decoded_elems=chunks.numel(),
        encoded_elems=chunks.numel(), itemsize=x.element_size(),
        encode_fused=fused_encode)
    if fused:
        return _decode_reduce_chunks(recv, dtype=x.dtype, n=chunks.shape[1],
                                     width=width, block=block)
    vals, flag = _decode_chunks(recv, dtype=x.dtype, n=chunks.shape[1],
                                width=width, block=block)
    return _seq_sum(vals, acc_dtype), flag


def all_gather_compressed(y: torch.Tensor, group=None, *, width: int,
                          block: int = 512, exc_frac: float = 0.02,
                          fused_encode: bool = True, axis_name="data"):
    """Compressed all-gather of a flat local chunk: one encode at the source,
    one decode of the gathered wire.  Returns (stacked (n_dev, chunk),
    overflow_flag)."""
    n_dev = dist.get_world_size(group)
    yf = _pad_flat(y.reshape(-1), block)
    wire = _encode_chunks(yf[None], width=width, block=block, exc_frac=exc_frac,
                          fused=fused_encode)
    gathered = {k: _all_gather(v, group) for k, v in wire.items()}
    _record_collective(
        "all_gather", axis_name, raw_bytes=n_dev * yf.numel() * y.element_size(),
        wire=gathered, fused=False, encoded_elems=yf.numel(),
        itemsize=y.element_size(), encode_fused=fused_encode)
    return _decode_chunks(gathered, dtype=y.dtype, n=yf.shape[0], width=width,
                          block=block)


def psum_compressed(x: torch.Tensor, group=None, *, policy: CompressionPolicy,
                    axis_name="data", tensor_class: str = "gradient",
                    out_dtype=None):
    """Compressed all-reduce of ``x`` over ``group``.  Tensors the policy
    leaves raw take the raw two-shot when they reach ``min_bytes``, else
    :func:`psum_safe`.  Returns (sum, overflow_flag)."""
    out_dtype = out_dtype or x.dtype
    if not policy.should_compress(x, axis_name, tensor_class=tensor_class):
        if x.numel() * x.element_size() >= policy.min_bytes:
            return psum_raw_twoshot(x, group).to(out_dtype), _no_flag(x)
        return psum_safe(x, group).to(out_dtype), _no_flag(x)
    width = policy.width_for(tensor_class)
    block, exc = policy.profile.block, policy.profile.exc_frac
    if policy.allreduce_algorithm == "ring":
        return psum_compressed_ring(
            x, group, width=width, block=block, exc_frac=exc, out_dtype=out_dtype,
            use_fused=policy.fused_decode_reduce, fused_encode=policy.fused_encode,
            axis_name=axis_name)
    red, f1 = reduce_scatter_compressed(
        x, group, width=width, block=block, exc_frac=exc,
        use_fused=policy.fused_decode_reduce, fused_encode=policy.fused_encode,
        axis_name=axis_name)
    # the reduced chunk's block ranges stay comparable to the inputs', so the
    # calibrated width is reused, with ag_extra_bits of headroom
    ag_width = min(width + policy.profile.ag_extra_bits, 8)
    gath, f2 = all_gather_compressed(
        red.to(out_dtype), group, width=ag_width, block=block, exc_frac=exc,
        fused_encode=policy.fused_encode, axis_name=axis_name)
    out = gath.reshape(-1)[: x.numel()].reshape(x.shape).to(out_dtype)
    return out, torch.maximum(f1, f2)


def psum_compressed_ring(x: torch.Tensor, group=None, *, width: int,
                         block: int = 512, exc_frac: float = 0.02,
                         out_dtype=None, use_fused: bool = True,
                         fused_encode: bool = True, axis_name="data"):
    """Ring all-reduce with an encode and a decode at every hop: the
    paper's negative baseline (Fig. 9b).  ``k - 1`` reduce-scatter hops fuse
    the received chunk into the accumulator row (the decode+reduce of the
    two-shot), ``k - 1`` all-gather hops are pure decodes; each hop is a
    ppermute to rank ``(i + 1) % k``.  At one rank there is no hop."""
    out_dtype = out_dtype or x.dtype
    n_dev, idx = dist.get_world_size(group), dist.get_rank(group)
    xf = _pad_flat(x.reshape(-1), n_dev * block).reshape(n_dev, -1)
    chunk = xf.shape[1]
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    acc = xf.to(torch.float32)
    flag = _no_flag(x)

    def hop(v, phase):
        wire = _encode_chunks(v[None], width=width, block=block, exc_frac=exc_frac,
                              fused=fused_encode)
        recv = {k: raw_ppermute(a, group, perm) for k, a in wire.items()}
        _record_collective(
            f"ring_hop_{phase}", axis_name, raw_bytes=chunk * v.element_size(),
            wire=wire, fused=use_fused and phase == "rs",
            decoded_elems=chunk if phase == "rs" else 0, encoded_elems=chunk,
            itemsize=v.element_size(), encode_fused=fused_encode)
        return recv

    # reduce-scatter phase: hop h sends the partial sum of chunk (idx - h)
    send = acc[idx]
    for h in range(n_dev - 1):
        slot = (idx - h - 1) % n_dev
        v = send.to(x.dtype)
        recv = hop(v, "rs")
        if use_fused:
            send, f = _decode_reduce_chunks(recv, dtype=v.dtype, n=chunk, width=width,
                                            block=block, acc=acc[slot])
        else:
            vals, f = _decode_chunks(recv, dtype=v.dtype, n=chunk, width=width,
                                     block=block)
            send = acc[slot] + vals[0].to(torch.float32)
        flag = torch.maximum(flag, f)
        acc[slot] = send
    # all-gather phase: circulate the fully reduced chunks
    for h in range(n_dev - 1):
        v = send.to(out_dtype)
        vals, f = _decode_chunks(hop(v, "ag"), dtype=v.dtype, n=chunk, width=width,
                                 block=block)
        flag = torch.maximum(flag, f)
        send = vals[0].to(torch.float32)
        acc[(idx - n_dev - h) % n_dev] = send
    return acc.reshape(-1)[: x.numel()].reshape(x.shape).to(out_dtype), flag


def psum_compressed_hierarchical(x: torch.Tensor, intra_group, inter_group, *,
                                 policy: CompressionPolicy, group=None,
                                 intra_axis: str = "data", inter_axis: str = "pod",
                                 tensor_class: str = "gradient", out_dtype=None):
    """Two-level compressed all-reduce: a compressed reduce-scatter within
    ``intra_group``, a compressed two-shot of the shard across
    ``inter_group`` (both phases at the send width), and a compressed
    all-gather within ``intra_group``.  Only the reduced shards cross the
    inter level.  ``intra_axis``/``inter_axis`` are the labels the policy
    gates on; a tensor it leaves raw takes the raw two-shot over ``group``
    (default: the world), which spans both levels.  Returns (sum, flag)."""
    out_dtype = out_dtype or x.dtype
    axes = (intra_axis, inter_axis)
    if not policy.should_compress(x, axes, tensor_class=tensor_class):
        return psum_raw_twoshot(x, group).to(out_dtype), _no_flag(x)
    kw = dict(width=policy.width_for(tensor_class), block=policy.profile.block,
              exc_frac=policy.profile.exc_frac, fused_encode=policy.fused_encode)
    fused = policy.fused_decode_reduce
    shard, f1 = reduce_scatter_compressed(x, intra_group, use_fused=fused,
                                          axis_name=intra_axis, **kw)
    shard = shard.to(out_dtype)
    red, f2 = reduce_scatter_compressed(shard, inter_group, use_fused=fused,
                                        axis_name=inter_axis, **kw)
    gat, f3 = all_gather_compressed(red.to(out_dtype), inter_group,
                                    axis_name=inter_axis, **kw)
    shard_full = gat.reshape(-1)[: shard.shape[0]].to(out_dtype)
    out, f4 = all_gather_compressed(shard_full, intra_group, axis_name=intra_axis, **kw)
    out = out.reshape(-1)[: x.numel()].reshape(x.shape).to(out_dtype)
    return out, torch.stack([f1, f2, f3, f4]).max()


# ---------------------------------------------------------------------------
# all_to_all (MoE dispatch) and P2P
# ---------------------------------------------------------------------------

def all_to_all_compressed(x: torch.Tensor, group=None, *, policy: CompressionPolicy,
                          axis_name="data", tensor_class: str = "activation"):
    """Compressed all_to_all over the leading axis: row j of ``x`` goes to
    rank j, row j of the result came from rank j.  ``x.shape[0]`` is the
    group's size.  Returns (result, flag)."""
    n_dev = dist.get_world_size(group)
    if x.shape[0] != n_dev:
        raise ValueError(f"leading axis {x.shape[0]} is not the group size {n_dev}")
    if not policy.should_compress(x, axis_name, tensor_class=tensor_class):
        return raw_all_to_all(x, group), _no_flag(x)
    width, block = policy.width_for(tensor_class), policy.profile.block
    inner = x[0].numel()
    x2d = _pad_rows(x.reshape(n_dev, inner), block)
    wire = _encode_chunks(x2d, width=width, block=block,
                          exc_frac=policy.profile.exc_frac, fused=policy.fused_encode)
    recv = {k: _all_to_all(v, group) for k, v in wire.items()}
    _record_collective(
        "all_to_all", axis_name, raw_bytes=x2d.numel() * x.element_size(),
        wire=wire, fused=False, encoded_elems=x2d.numel(),
        itemsize=x.element_size(), encode_fused=policy.fused_encode)
    vals, flag = _decode_chunks(recv, dtype=x.dtype, n=x2d.shape[1], width=width,
                                block=block)
    return vals[:, :inner].reshape(x.shape), flag


def ppermute_compressed(x: torch.Tensor, perm, group=None, *,
                        policy: CompressionPolicy, axis_name="data",
                        tensor_class: str = "weight"):
    """Compressed point-to-point transfer along ``perm`` (``(source,
    target)`` group ranks): encode, send, decode.  A rank no pair targets
    gets zeros.  Returns (received, flag)."""
    if not policy.should_compress(x, axis_name, tensor_class=tensor_class):
        return raw_ppermute(x, group, perm), _no_flag(x)
    width, block = policy.width_for(tensor_class), policy.profile.block
    xf = _pad_flat(x.reshape(-1), block)
    wire = _encode_chunks(xf[None], width=width, block=block,
                          exc_frac=policy.profile.exc_frac, fused=policy.fused_encode)
    recv = {k: raw_ppermute(v, group, perm) for k, v in wire.items()}
    _record_collective(
        "ppermute", axis_name, raw_bytes=xf.numel() * x.element_size(),
        wire=wire, fused=False, encoded_elems=xf.numel(),
        itemsize=x.element_size(), encode_fused=policy.fused_encode)
    vals, flag = _decode_chunks(recv, dtype=x.dtype, n=xf.shape[0], width=width,
                                block=block)
    return vals[0, : x.numel()].reshape(x.shape), flag


# ---------------------------------------------------------------------------
# pytree gradient bucket sync
# ---------------------------------------------------------------------------

def tree_psum_compressed(tree, group=None, *, policy: CompressionPolicy,
                         axis_name="data", tensor_class: str = "gradient"):
    """All-reduce a pytree: the codec-float leaves fuse into one flat bucket
    per dtype (sorted by dtype name; the plan compiler's grouping rule,
    ``sched/compile._group_leaves``), each synced by one
    :func:`psum_compressed`, so every leaf stays exact at its own
    precision; every other leaf takes :func:`psum_safe`.  Returns (tree,
    overflow_flag)."""
    from repro_torch.sched.compile import _group_leaves
    from repro_torch.tree_util import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(tree)
    groups, raw_ix = _group_leaves(leaves)
    out = list(leaves)
    flag = _no_flag(leaves[0])
    for name in sorted(groups):
        members = groups[name]
        parts = [leaves[i].reshape(-1) for i, _, _ in members]
        red, f = psum_compressed(torch.cat(parts) if len(parts) > 1 else parts[0],
                                 group, policy=policy, axis_name=axis_name,
                                 tensor_class=tensor_class)
        flag = torch.maximum(flag, f)
        off = 0
        for i, shape, size in members:
            out[i] = red[off: off + size].reshape(shape)
            off += size
    for i in raw_ix:
        out[i] = psum_safe(leaves[i], group)
    return tree_unflatten(treedef, out), flag
