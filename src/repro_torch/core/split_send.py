"""Split-send P2P pipeline (paper §3.2, Fig. 4d) over ``torch.distributed``;
torch port of ``repro.core.split_send``.

After the cheap split, the lo plane (sign and mantissa: half of a bf16
tensor, three quarters of an f32) is final and can go on the wire at once,
while the exponent plane is still being encoded.  :func:`split_send` issues
the packed lo plane's ppermute without waiting
(``compressed_collectives.raw_ppermute_start``: on NCCL the transfer runs on
the communicator's stream while the current stream packs the exponents; on
gloo on a thread of its own), then packs and sends the exponent wire, and
waits for the lo plane last.  The reference gets the same overlap from XLA's
scheduler, since nothing depends on the send.

The baselines: :func:`encode_send` (Fig. 4a) sends nothing until the whole
message is encoded, by default in one pass (the encode_fused kernel);
:func:`chunked_pipeline_send` (Fig. 4b/c) cuts the tensor into chunks, each
encoded and sent after the previous one was received.  All three give the
bits of a raw ppermute; they differ only in their schedule.

Reducing receivers (``reduce_into=``): a consumer that adds what it receives
(gradient accumulation across pipeline stages) gets ``reduce_into +
received`` in f32.  :func:`split_send` streams the received wire through the
fused decode+reduce (``compressed_collectives._decode_reduce_chunks``, the
decode_reduce kernel on CUDA), the P2P analogue of the two-shot's receive
(paper §3.4); the other strategies decode first and add after, to the same
bits.

:func:`delta_send` ships the XOR delta of a weight tensor against a base
version both ends hold (weight sync, paper §5.3.1); :func:`wsync_dispatch`
routes a weight bucket to it or to :func:`p2p_dispatch`.

Every function takes the ``torch.distributed`` group that carries the wire
and ``perm``, ``(source, target)`` pairs of group ranks; ``axis_name`` is
the label the policy gates on and the WireReports carry.  The plan executor
(``sched/executor.py``, kinds ``p2p``, ``kv`` and ``wsync``) replays the
decisions of :func:`p2p_send` through the same :func:`p2p_dispatch` and
:func:`wsync_dispatch`, so planned and planless sends give the same bits.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import codec, packing
from repro_torch.core.compressed_collectives import (_decode_chunks, _decode_reduce_chunks,
                                                     _encode_chunks, _no_flag, _pad_flat,
                                                     encode_hbm_bytes_for, raw_ppermute,
                                                     raw_ppermute_start)
from repro_torch.core.policy import (CompressionPolicy, WireReport, capture_wire_reports,
                                     record_wire_report)

STRATEGIES = ("split_send", "encode_send", "chunked")


def _record_p2p(name: str, axis_name, *, n_elems: int, itemsize: int, lo_planes,
                exp_wire: dict, fused: bool = False, decoded_elems: int = 0,
                encode_fused: bool = False) -> None:
    """The WireReport of one P2P strategy's send of ``n_elems`` (padded)
    elements: the lo plane at 4 bytes a word plus the exponent wire.  A pure
    decode has no decoded-float round-trip to account; a reducing receiver
    pays ``8 * decoded_elems`` bytes unless it runs fused.  ``split_send``
    always pays the split-plane round-trip (its early lo send needs the
    split), ``encode_send`` by default does not (``encode_fused``)."""
    wire_bytes = lo_planes.numel() * 4 + sum(
        v.numel() * v.element_size() for v in exp_wire.values())
    record_wire_report(WireReport(
        name=name, axis=str(axis_name), raw_bytes=int(n_elems) * itemsize,
        wire_bytes=int(wire_bytes), fused=fused,
        decode_hbm_bytes=int(8 * decoded_elems), encode_fused=encode_fused,
        encode_hbm_bytes=encode_hbm_bytes_for(n_elems, itemsize)))


def _exp_wire(pk: packing.PackedPlane) -> dict:
    return {"payload": pk.payload, "bases": pk.bases, "exc_idx": pk.exc_idx,
            "exc_raw": pk.exc_raw, "overflow": pk.overflow}


def _one_chunk(lo_recv: torch.Tensor, recv: dict) -> dict:
    """A received message as the one-chunk wire dict that the chunk decoders
    (``compressed_collectives._decode_chunks``, ``_decode_reduce_chunks``)
    take."""
    return {"lo": lo_recv[None], **{k: v[None] for k, v in recv.items()}}


def _add_f32(acc: torch.Tensor, got: torch.Tensor, shape) -> torch.Tensor:
    """``acc + got`` in f32, shaped ``shape``: the unfused reducing receive."""
    return (acc.reshape(-1).to(torch.float32)
            + got.reshape(-1).to(torch.float32)).reshape(shape)


def split_send(x: torch.Tensor, group, perm, *, width: int, block: int = 512,
               exc_frac: float = 0.02, reduce_into: torch.Tensor | None = None,
               use_fused: bool = True, axis_name="data"):
    """Split-send pipeline: the lo plane is on the wire while the exponents
    are packed.  Returns (received tensor, overflow flag), the bits of a
    raw ppermute of ``x``.

    ``reduce_into``: the reducing receiver.  The received wire streams
    through the fused decode+reduce into a padded f32 copy of
    ``reduce_into`` (exception blocks patched exactly), and the result is
    ``reduce_into + received`` in f32, shaped like ``x``;
    ``use_fused=False`` decodes first and adds after, to the same bits."""
    lay = codec.layout_of(x.dtype)
    n = x.numel()
    xf = _pad_flat(x.reshape(-1), block)
    n_pad = xf.shape[0]
    exp, lo = codec.split_planes(xf)
    # stage A, the early send: the lo plane is final after the split
    lo_planes = packing.bitplane_pack(packing._pad_to(lo, packing.GROUP, "zero"),
                                      lay.lo_bits)
    lo_pending = raw_ppermute_start(lo_planes, group, perm)
    # stage B, overlapped with A: pack the exponent plane, then send it
    exp_wire = _exp_wire(packing.pack_exponents(exp, width=width, block=block,
                                                exc_frac=exc_frac))
    recv = {k: raw_ppermute(v, group, perm) for k, v in exp_wire.items()}
    lo_recv = lo_pending.wait()
    fused = reduce_into is not None and use_fused
    _record_p2p("split_send", axis_name, n_elems=n_pad, itemsize=x.element_size(),
                lo_planes=lo_planes, exp_wire=exp_wire, fused=fused,
                decoded_elems=n_pad if reduce_into is not None else 0)
    wire = _one_chunk(lo_recv, recv)
    if fused:
        acc = _pad_flat(reduce_into.reshape(-1).to(torch.float32), block)
        acc, flag = _decode_reduce_chunks(wire, dtype=x.dtype, n=n_pad, width=width,
                                          block=block, acc=acc)
        return acc[:n].reshape(x.shape), flag
    # the decode: the unpack kernel on the payload and the lo plane, then the
    # zero-escape decode and the merge
    out = _decode_chunks(wire, dtype=x.dtype, n=n_pad, width=width, block=block)[0][0]
    if reduce_into is not None:
        return _add_f32(reduce_into, out[:n], x.shape), recv["overflow"]
    return out[:n].reshape(x.shape), recv["overflow"]


def encode_send(x: torch.Tensor, group, perm, *, width: int, block: int = 512,
                exc_frac: float = 0.02, fused_encode: bool = True, axis_name="data"):
    """The naive baseline (paper Fig. 4a): nothing is sent until the whole
    message is encoded, by default in one pass (the encode_fused kernel on
    CUDA, ``compressed_collectives._encode_chunks``); ``fused_encode=False``
    runs the three-pass composition, to the same wire.  Each send is waited
    on before the next.  Returns (received tensor, overflow flag), the bits
    of a raw ppermute."""
    n = x.numel()
    xf = _pad_flat(x.reshape(-1), block)
    chunks = _encode_chunks(xf[None], width=width, block=block, exc_frac=exc_frac,
                            fused=fused_encode)
    wire = {k: v[0] for k, v in chunks.items()}
    lo_planes = wire.pop("lo")
    lo_recv = raw_ppermute(lo_planes, group, perm)
    recv = {k: raw_ppermute(v, group, perm) for k, v in wire.items()}
    _record_p2p("encode_send", axis_name, n_elems=xf.shape[0], itemsize=x.element_size(),
                lo_planes=lo_planes, exp_wire=wire, encode_fused=fused_encode)
    out = _decode_chunks(_one_chunk(lo_recv, recv), dtype=x.dtype, n=xf.shape[0],
                         width=width, block=block)[0][0]
    return out[:n].reshape(x.shape), recv["overflow"]


def chunk_grid(n: int, chunks: int, block: int) -> tuple:
    """``(per, chunks)`` of :func:`chunked_pipeline_send`: the per-chunk
    length, ``ceil(n / chunks)`` rounded up to a block multiple, and the
    effective chunk count, so that no chunk is all padding."""
    ideal = -(-n // max(chunks, 1))
    per = -(-ideal // block) * block
    return per, -(-n // per)


def chunked_pipeline_send(x: torch.Tensor, group, perm, *, width: int, chunks: int = 4,
                          block: int = 512, exc_frac: float = 0.02,
                          fused_encode: bool = True, axis_name="data"):
    """The chunk-pipelining baseline (paper Fig. 4b/c): the tensor in
    ``chunks`` chunks of whole blocks (fewer when it is small: the
    degenerate-chunk guard of :func:`chunk_grid`), each encoded and sent by
    :func:`encode_send`; chunk ``k + 1`` is encoded after chunk ``k`` was
    received.  Returns (received tensor, the chunks' largest flag)."""
    n = x.numel()
    if n == 0:
        raise ValueError("chunked_pipeline_send: empty tensor")
    per, chunks = chunk_grid(n, chunks, block)
    parts = _pad_flat(x.reshape(-1), chunks * per).reshape(chunks, per)
    outs, flag = [], _no_flag(x)
    for part in parts:
        got, f = encode_send(part, group, perm, width=width, block=block,
                             exc_frac=exc_frac, fused_encode=fused_encode,
                             axis_name=axis_name)
        outs.append(got)
        flag = torch.maximum(flag, f)
    return codec.concat_bits(outs)[:n].reshape(x.shape), flag


def p2p_dispatch(x: torch.Tensor, group, perm, *, compressed: bool, width: int,
                 block: int = 512, exc_frac: float = 0.02, strategy: str = "split_send",
                 reduce_into: torch.Tensor | None = None, fused: bool = True,
                 encode_fused: bool = True, axis_name="data"):
    """Send ``x`` through one strategy with every choice (gate, width, the
    fused knobs) given by the caller: the seam that :func:`p2p_send` (which
    derives them from a policy) and the plan executor (which reads them off
    a compiled plan) share, so both give the same bits.

    ``reduce_into``: the reducing receiver; ``split_send`` fuses the add
    into the decode when ``fused``, the others and the raw path decode and
    add after, in f32.  Returns (result, flag)."""
    if not compressed:
        got = raw_ppermute(x, group, perm)
        if reduce_into is not None:
            got = _add_f32(reduce_into, got, x.shape)
        return got, _no_flag(x)
    kw = dict(width=width, block=block, exc_frac=exc_frac, axis_name=axis_name)
    if strategy == "split_send":
        return split_send(x, group, perm, reduce_into=reduce_into, use_fused=fused, **kw)
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown P2P strategy {strategy!r}")
    fn = encode_send if strategy == "encode_send" else chunked_pipeline_send
    if reduce_into is None:
        return fn(x, group, perm, fused_encode=encode_fused, **kw)
    # a reducing receiver on a pure-decode strategy materialises the decoded
    # floats between decode and add: its reports carry that round-trip
    itemsize = x.element_size()
    with capture_wire_reports() as caught:
        got, flag = fn(x, group, perm, fused_encode=encode_fused, **kw)
    for r in caught:
        record_wire_report(dataclasses.replace(
            r, fused=False, decode_hbm_bytes=8 * (r.raw_bytes // itemsize)))
    return _add_f32(reduce_into, got, x.shape), flag


def delta_send(x: torch.Tensor, base: torch.Tensor, group, perm, *, width: int,
               lo_width: int, block: int = 512, exc_frac: float = 0.02,
               axis_name="data"):
    """XOR-delta P2P send (weight sync): both ends hold ``base``, only the
    encoded delta crosses the wire (``packing.encode_delta``: the
    exponent-delta plane at ``width``, the lo-delta plane at ``lo_width``
    with element-exact exceptions, the pack kernel twice on CUDA).  The
    receiver decodes against its own ``base``.

    Returns (received tensor, flag).  The flag is an int32 tensor, the
    larger of the two planes' received overflow flags (read on the device,
    no host sync): 0 means the result has the bits of a raw ppermute of
    ``x``; 1 that the delta did not fit the widths, and the caller must send
    in full."""
    n = x.numel()
    # padded in the bits domain: the delta wire is exact down to NaN payloads
    xf = codec.pad_flat_bits(x.reshape(-1), block)
    bf = codec.pad_flat_bits(base.reshape(-1).to(x.dtype), block)
    m = packing.encode_delta(xf, bf, width=width, lo_width=lo_width, block=block,
                             exc_frac=exc_frac)

    def move(plane, fields):
        return dataclasses.replace(plane, **{
            f: raw_ppermute(getattr(plane, f), group, perm) for f in fields})

    recv = dataclasses.replace(
        m, lo=move(m.lo, ("payload", "exc_idx", "exc_raw", "overflow")),
        exp=move(m.exp, ("payload", "bases", "exc_idx", "exc_raw", "overflow")))
    itemsize = x.element_size()
    # the delta encode is the three-pass split-then-pack composition, and the
    # receive a pure decode
    record_wire_report(WireReport(
        name="delta_send", axis=str(axis_name), raw_bytes=xf.shape[0] * itemsize,
        wire_bytes=m.wire_bytes(),
        encode_hbm_bytes=encode_hbm_bytes_for(xf.shape[0], itemsize)))
    out = packing.decode_delta(recv, bf)
    flag = torch.maximum(recv.exp.overflow, recv.lo.overflow)
    return codec.slice_bits(out, 0, n).reshape(x.shape), flag


def wsync_dispatch(x: torch.Tensor, base, group, perm, *, compressed: bool, width: int,
                   delta_width: int, delta_lo_width: int, block: int = 512,
                   exc_frac: float = 0.02, strategy: str = "split_send",
                   fused: bool = True, encode_fused: bool = True, axis_name="data"):
    """One weight bucket, every choice given by the caller (the seam of
    ``sync/wire.sync_weights`` and the plan executor's ``execute_wsync``): a
    compressed bucket with a base version rides :func:`delta_send` at the
    delta widths; a full send (no base) or a raw bucket goes through
    :func:`p2p_dispatch`."""
    if compressed and base is not None and delta_width:
        return delta_send(x, base, group, perm, width=delta_width,
                          lo_width=delta_lo_width, block=block, exc_frac=exc_frac,
                          axis_name=axis_name)
    return p2p_dispatch(x, group, perm, compressed=compressed, width=width, block=block,
                        exc_frac=exc_frac, strategy=strategy, fused=fused,
                        encode_fused=encode_fused, axis_name=axis_name)


def send_raw_leaves(leaves, raw_ix, out: list, group, perm) -> None:
    """Move ``leaves[i]`` for ``i`` in ``raw_ix`` with the raw ppermute into
    ``out[i]``: the pytree wires' leaves outside every bucket.  A 0-d leaf
    rides as ``[None]`` and comes back as ``[0]``."""
    for i in raw_ix:
        leaf = leaves[i]
        got = raw_ppermute(leaf[None] if leaf.ndim == 0 else leaf, group, perm)
        out[i] = got[0] if leaf.ndim == 0 else got


def p2p_send(x: torch.Tensor, group, perm, *, policy: CompressionPolicy,
             tensor_class: str = "weight", strategy: str = "split_send",
             reduce_into: torch.Tensor | None = None, plan=None, axis_name="data"):
    """Policy-gated P2P send (weight sync, KV-cache transfer): the gate, the
    width and the fused knobs come from ``policy`` at every call, then
    :func:`p2p_dispatch`.  ``plan`` (a compiled kind-"p2p" ``CommPlan``)
    replays its recorded schedule instead (``sched/executor.execute_p2p``),
    to the same bits; ``sched.p2p_send_with_plan`` adds the plan cache.
    Returns (result, flag)."""
    if plan is not None:
        from repro_torch.sched.executor import execute_p2p

        return execute_p2p(plan, x, group, perm, reduce_into=reduce_into)
    return p2p_dispatch(
        x, group, perm,
        compressed=policy.should_compress(x, axis_name, tensor_class=tensor_class),
        width=policy.width_for(tensor_class), block=policy.profile.block,
        exc_frac=policy.profile.exc_frac, strategy=strategy, reduce_into=reduce_into,
        fused=policy.fused_decode_reduce, encode_fused=policy.fused_encode,
        axis_name=axis_name)
