"""Host-orchestrated P2P transfer engine with split-send compression (torch
port of ``repro.p2p.engine``).

The paper's UZIP-P2P is a host-driven pipeline: the GPU splits the tensor,
the NIC ships the uncompressed plane while the GPU encodes the exponent
plane, then the (smaller) compressed payload follows.  This module is the
port's engine for out-of-band transfers (PD-disaggregated KV shipment): the
split and the codec run on the tensor's device (the bit-plane pack kernel,
and the rANS kernels for the ``rans`` codec), and the wire is a
:class:`Message` of numpy arrays with the reference's dtypes, so a message
encoded by either package decodes in the other.

Observability (``obs``): the ``p2p:encode`` and ``p2p:decode`` spans, the
stage spans ``p2p:split`` and ``p2p:entropy_code`` (rANS) or ``p2p:pack``
(packed) around the intervals the stage timers close at a device sync, the
encode and decode seconds histograms, and each encode's bytes in the
per-bucket ledger under the host kind ``p2p_host`` with a bounded sample of
its payload for the width-regret analysis.

Pipeline timing model (paper Fig. 4d):
    T_split_send = T_split + max(T_lo_wire, T_encode) + T_exp_wire
    T_encode_send = T_split + T_encode + (T_lo_wire + T_exp_wire)
    T_raw = T_raw_wire
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import kernels, obs
from repro_torch.core import ans, codec, packing
from repro_torch.core.calibrate import choose_width


@dataclasses.dataclass(frozen=True)
class WireModel:
    """First-order link model (~50 GB/s ICI-class link)."""
    bandwidth: float = 50e9  # bytes/s
    latency: float = 5e-6  # s per message

    def t(self, nbytes: int, messages: int = 1) -> float:
        return self.latency * messages + nbytes / self.bandwidth


@dataclasses.dataclass(frozen=True)
class CodecModel:
    """Codec-rate model with the paper's H200 figures (Fig. 3: 16 MB ~ 90 us,
    4 MB ~ 70 us, t = t0 + c * n), the split at 14% of the total (paper
    Property 2).  A model, not a measurement of this port."""
    t0: float = 60e-6
    per_byte: float = (90e-6 - 60e-6) / (16 << 20)
    split_frac: float = 0.14

    def t_total(self, nbytes: int) -> float:
        return self.t0 + self.per_byte * nbytes

    def t_split(self, nbytes: int) -> float:
        return self.split_frac * self.t_total(nbytes)

    def t_encode(self, nbytes: int) -> float:
        return (1 - self.split_frac) * self.t_total(nbytes)


@dataclasses.dataclass
class Message:
    """Encoded wire message + metadata (paper §4.1 metadata extension).
    Arrays are numpy with the reference's dtypes: ``lo_payload`` and the
    packed ``payload`` uint32, ``bases``/``exc_raw`` uint8, ``exc_idx``
    int32; rANS ``words`` uint16, ``lens`` int32, ``freq`` uint32."""
    dtype_name: str
    shape: tuple
    raw_bytes: int
    lo_payload: np.ndarray  # bit-packed sign|mantissa plane
    exp_payload: dict  # codec-dependent
    codec: str  # "rans" | "packed"
    width: int = 0
    t_split: float = 0.0
    t_encode: float = 0.0

    def wire_bytes(self) -> int:
        n = self.lo_payload.nbytes
        if self.codec == "rans":
            # variable-length: only the USED words ship (+ table + lens)
            n += self.exp_payload["used_bytes"] + 256 * 12 // 8
            n += np.asarray(self.exp_payload["lens"]).nbytes
        else:
            for k in ("payload", "bases", "exc_idx", "exc_raw"):
                n += np.asarray(self.exp_payload[k]).nbytes
        return n + 64  # metadata header

    def ratio(self) -> float:
        return self.wire_bytes() / self.raw_bytes


def host_array(t: torch.Tensor, np_dtype) -> np.ndarray:
    """A tensor on any device as a numpy array of ``np_dtype`` with the same
    bits (int32 words -> uint32, uint16 via int16; 0-d stays 0-d)."""
    t = t.detach()
    if t.dtype == torch.uint16:
        t = t.view(torch.int16)
    return t.cpu().numpy().view(np_dtype)


def _device(a, torch_dtype, dev) -> torch.Tensor:
    """A wire array as a tensor of ``torch_dtype`` with the same bits on
    ``dev`` (uint32 -> int32, uint16 -> uint16 through int16)."""
    a = np.ascontiguousarray(np.asarray(a))
    view = {torch.int32: np.int32, torch.uint8: np.uint8,
            torch.uint16: np.int16}[torch_dtype]
    t = torch.from_numpy(a.view(view).copy()).to(dev)
    return t.view(torch.uint16) if torch_dtype == torch.uint16 else t


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Compressor:
    """The per-process host compressor (paper §4.1: one compressor per GPU
    serving the single send/recv thread pair).  ``device`` is where the codec
    runs (``cuda`` by default; it raises without a GPU unless ``cpu`` is
    asked for); encode takes a tensor on that device or a numpy array."""

    _instance: Optional["Compressor"] = None
    _lock = threading.Lock()

    def __init__(self, *, codec_name: str = "packed", lanes: int = 128,
                 block: int = 512, device="cuda"):
        if codec_name not in ("packed", "rans"):
            raise ValueError(f"unknown codec {codec_name!r}")
        self.codec_name = codec_name
        self.lanes = lanes
        self.block = block
        self.device = kernels.resolve_device(device)
        self._width_cache = {}  # (tensor-class, dtype) -> calibrated width
        self._table_cache = {}  # (tensor-class, dtype) -> FreqTable (paper:
        #                          table transmitted once, reused across calls)

    @classmethod
    def instance(cls, **kw) -> "Compressor":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(**kw)
        return cls._instance

    def _flat(self, x) -> tuple:
        if not isinstance(x, torch.Tensor):
            a = np.asarray(x)
            from repro_torch.models.transformer import numpy_to_torch

            x = numpy_to_torch(a, codec.layout_of(a.dtype.name).dtype)
        return tuple(x.shape), x.to(self.device).reshape(-1)

    def _split_lo(self, flat: torch.Tensor, lay: codec.FloatLayout):
        exp, lo = codec.split_planes(flat)
        lo_packed = packing.bitplane_pack(
            packing._pad_to(lo, packing.GROUP, "zero"), lay.lo_bits)
        return exp, lo_packed

    # -- encode ----------------------------------------------------------------

    def encode(self, x, *, tensor_class: str = "weight",
               reuse_table: bool = True, plan=None) -> Message:
        """Encode one tensor into a wire :class:`Message` (bit-exact
        round-trip through :meth:`decode`).

        Width of the packed codec, in priority order: the compiled schedule
        (``plan``, a kind-"kv" ``CommPlan`` whose recorded per-dtype width is
        used instead of a probe), the per-(class, dtype) width cache, else a
        one-time ``calibrate.choose_width`` probe on the live data.  Stage
        times are host clock up to a device sync."""
        with obs.span("p2p:encode", codec=self.codec_name,
                      tensor_class=tensor_class) as sp:
            shape, flat = self._flat(x)
            msg = self._encode_impl(shape, flat, tensor_class=tensor_class,
                                    reuse_table=reuse_table, plan=plan)
            sp.args["raw_bytes"] = msg.raw_bytes
            sp.args["wire_bytes"] = msg.wire_bytes()
        obs.metric("p2p_encode_seconds").observe(msg.t_split + msg.t_encode,
                                                 codec=self.codec_name)
        if obs.enabled():
            # host-path wire ledger + recalibration sample, under its own
            # kind so the plan-kind exactness check stays exact
            w_used = int(msg.width or 0)
            obs.metric("bucket_wire_raw_bytes_total").inc(
                msg.raw_bytes, kind="p2p_host", dtype=msg.dtype_name, width=w_used)
            obs.metric("bucket_wire_bytes_total").inc(
                msg.wire_bytes(), kind="p2p_host", dtype=msg.dtype_name, width=w_used)
            from repro_torch.obs import regret as regret_lib

            regret_lib.record_sample("p2p_host", msg.dtype_name, flat)
        return msg

    def _encode_impl(self, shape: tuple, flat: torch.Tensor, *, tensor_class: str,
                     reuse_table: bool, plan) -> Message:
        lay = codec.layout_of(flat.dtype)
        dev = flat.device
        if self.codec_name == "rans":
            with obs.span("p2p:split", nbytes=flat.numel() * lay.total_bits // 8):
                t0 = time.perf_counter()
                exp, lo_packed = self._split_lo(flat, lay)
                _sync(dev)
                t_split = time.perf_counter() - t0
            with obs.span("p2p:entropy_code", lanes=self.lanes):
                t1 = time.perf_counter()
                key = (tensor_class, lay.name) if reuse_table else None
                table = self._table_cache.get(key)
                if table is None:
                    table = ans.build_freq_table(exp)
                    if key is not None:
                        self._table_cache[key] = table
                stream = ans.encode(exp, table, lanes=self.lanes)
                lens = host_array(stream.lens, np.int32)
                exp_payload = {
                    "words": host_array(stream.words, np.uint16),
                    "lens": lens,
                    "freq": host_array(table.freq, np.uint32),
                    "n": exp.shape[0],
                    "used_bytes": int(lens.sum()) * 2,
                }
                width = 0
                t_encode = time.perf_counter() - t1
        else:
            width = None
            if plan is not None:  # decided-once schedule beats re-probing
                width = plan.width_for_dtype(lay.name)
            if width is None:
                width = self._width_cache.get((tensor_class, lay.name))
            if width is None:
                width = choose_width(flat, block=self.block).width
                self._width_cache[(tensor_class, lay.name)] = width
            with obs.span("p2p:pack", width=width):
                t0 = time.perf_counter()
                exp, lo_packed = self._split_lo(flat, lay)
                pk = packing.pack_exponents(exp, width=width, block=self.block)
                _sync(dev)
                t_total = time.perf_counter() - t0
            # one pipeline: attribute stage times by plane bytes
            lo_frac = lay.lo_bits / (lay.lo_bits + max(width, 1))
            t_split = t_total * lo_frac
            t_encode = t_total * (1 - lo_frac)
            exp_payload = {
                "payload": host_array(pk.payload, np.uint32),
                "bases": host_array(pk.bases, np.uint8),
                "exc_idx": host_array(pk.exc_idx, np.int32),
                "exc_raw": host_array(pk.exc_raw, np.uint8),
                "overflow": int(pk.overflow),
                "n": flat.shape[0],
            }
        return Message(
            dtype_name=lay.name, shape=shape,
            raw_bytes=flat.numel() * lay.total_bits // 8,
            lo_payload=host_array(lo_packed, np.uint32), exp_payload=exp_payload,
            codec=self.codec_name, width=width,
            t_split=t_split, t_encode=t_encode,
        )

    # -- decode ----------------------------------------------------------------

    def decode(self, msg: Message) -> torch.Tensor:
        """The tensor of ``msg`` on this compressor's device, bit-exact."""
        t0 = time.perf_counter()
        with obs.span("p2p:decode", codec=msg.codec, raw_bytes=msg.raw_bytes):
            out = self._decode_impl(msg)
        obs.metric("p2p_decode_seconds").observe(time.perf_counter() - t0,
                                                 codec=msg.codec)
        return out

    def _decode_impl(self, msg: Message) -> torch.Tensor:
        lay = codec.LAYOUTS[msg.dtype_name]
        dev = self.device
        n = int(np.prod(msg.shape)) if msg.shape else 1
        lo_words = _device(msg.lo_payload, torch.int32, dev)
        lo = packing.bitplane_unpack(lo_words, lay.lo_bits)[:n]
        p = msg.exp_payload
        if msg.codec == "rans":
            table = ans.table_from_freq(_device(p["freq"], torch.int32, dev))
            stream = ans.AnsStream(words=_device(p["words"], torch.uint16, dev),
                                   lens=_device(p["lens"], torch.int32, dev),
                                   table=table, n=int(p["n"]), lanes=self.lanes)
            exp = ans.decode(stream)
        else:
            pk = packing.PackedPlane(
                payload=_device(p["payload"], torch.int32, dev),
                bases=_device(p["bases"], torch.uint8, dev),
                exc_idx=_device(p["exc_idx"], torch.int32, dev),
                exc_raw=_device(p["exc_raw"], torch.uint8, dev),
                overflow=torch.tensor(int(p["overflow"]), dtype=torch.int32),
                width=msg.width, block=self.block, n=int(p["n"]),
                exp_bits=lay.exp_bits)
            exp = packing.unpack_exponents(pk)
        return codec.merge_planes(exp, lo, lay.dtype, tuple(msg.shape))

    # -- transfer (timing model) -----------------------------------------------

    def transfer_times(self, msg: Message, wire: WireModel,
                       codec_model: Optional[CodecModel] = None) -> dict:
        """Modelled transfer times of the three pipelines (paper Fig. 4).
        ``codec_model`` substitutes the paper's H200 codec rates for the
        measured stage times."""
        lo_b = msg.lo_payload.nbytes
        if msg.codec == "rans":
            exp_b = msg.exp_payload["used_bytes"] + 256 * 12 // 8
        else:
            exp_b = sum(msg.exp_payload[k].nbytes
                        for k in ("payload", "bases", "exc_idx", "exc_raw"))
        if codec_model is not None:
            t_split = codec_model.t_split(msg.raw_bytes)
            t_encode = codec_model.t_encode(msg.raw_bytes)
        else:
            t_split, t_encode = msg.t_split, msg.t_encode
        t_raw = wire.t(msg.raw_bytes)
        t_encode_send = t_split + t_encode + wire.t(lo_b + exp_b)
        t_split_send = t_split + max(wire.t(lo_b), t_encode) + wire.t(exp_b)
        return {
            "raw_bytes": msg.raw_bytes,
            "wire_bytes": lo_b + exp_b,
            "ratio": (lo_b + exp_b) / msg.raw_bytes,
            "t_raw": t_raw,
            "t_encode_send": t_encode_send,
            "t_split_send": t_split_send,
            "speedup_split_send": t_raw / t_split_send,
            "speedup_encode_send": t_raw / t_encode_send,
        }


def send_tensor(x, *, tensor_class: str = "weight",
                wire: WireModel = WireModel(), codec_name: str = "packed",
                device="cuda"):
    """One-call helper: encode -> (modelled) transfer -> decode.  Returns
    (tensor, report)."""
    eng = Compressor.instance(codec_name=codec_name, device=device)
    if eng.codec_name != codec_name or eng.device != kernels.resolve_device(device):
        eng = Compressor(codec_name=codec_name, device=device)
    msg = eng.encode(x, tensor_class=tensor_class)
    report = eng.transfer_times(msg, wire)
    out = eng.decode(msg)
    return out, report
