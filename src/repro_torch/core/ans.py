"""Interleaved rANS entropy codec for exponent planes (paper §2.1.2, Steps
2-3); torch port of ``repro.core.ans``.

The host P2P path's coder: ``K`` interleaved lanes, each an independent
rANS stream (lane j owns symbols ``j, j+K, j+2K, ...``), over a frequency
table quantised to ``M = 2**PROB_BITS`` in which every symbol keeps at least
one slot, so a table built from a sample stays lossless for symbols it never
saw.  32-bit state, 16-bit renormalisation, ``L = 1 << 16``.

:func:`encode` runs the dense-emission kernel (``kernels/rans.encode``)
on the ``(per, lanes)`` grid and then compacts each lane's words on the
device into the variable-length wire of the reference (``AnsStream``):
lane j's words in the order the encoder emitted them, then two flush words.
:func:`decode` runs the decode kernel on that compacted stream directly.
Both are bit for bit the reference's ``encode``/``decode``.
"""
from __future__ import annotations

import dataclasses

import torch

PROB_BITS = 12
M = 1 << PROB_BITS
RANS_L = 1 << 16
NSYM = 256


@dataclasses.dataclass(frozen=True)
class FreqTable:
    freq: torch.Tensor  # int32 (NSYM,) quantised frequencies, sum == M
    cum: torch.Tensor  # int32 (NSYM + 1,) exclusive prefix sums

    def nbytes(self) -> int:
        # wire representation: 256 x 12-bit frequencies
        return NSYM * PROB_BITS // 8


def table_from_freq(freq: torch.Tensor) -> FreqTable:
    """The table of quantised frequencies ``freq`` (NSYM,) (as it travels on
    the wire), with its prefix sums."""
    freq = freq.to(torch.int64)
    cum = torch.cat([freq.new_zeros(1), torch.cumsum(freq, 0)])
    return FreqTable(freq=freq.to(torch.int32), cum=cum.to(torch.int32))


def build_freq_table(symbols: torch.Tensor) -> FreqTable:
    """Quantised frequency table with every symbol >= 1 slot, bit for bit
    the reference's: ``floor(counts / total * (M - NSYM)) + 1`` in float32
    (an int32 product would overflow beyond ~0.5 M counts), the rounding
    drift added onto the first most frequent symbol."""
    counts = torch.bincount(symbols.reshape(-1).to(torch.int64), minlength=NSYM)
    counts = counts[:NSYM] + 1  # Laplace floor: unseen symbols stay encodable
    total = counts.sum()
    freq = torch.floor(counts.to(torch.float32) / total.to(torch.float32)
                       * (M - NSYM)).to(torch.int64) + 1
    freq[torch.argmax(freq)] += M - freq.sum()
    return table_from_freq(freq)


def _slot_to_symbol(table: FreqTable) -> torch.Tensor:
    """uint8 (M,) decode lookup: slot -> symbol."""
    slots = torch.arange(M, dtype=torch.int64, device=table.cum.device)
    return torch.searchsorted(table.cum[1:].to(torch.int64), slots,
                              right=True).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class AnsStream:
    words: torch.Tensor  # uint16 (lanes, cap) per-lane emitted words (incl. flush)
    lens: torch.Tensor  # int32 (lanes,) words used per lane
    table: FreqTable
    n: int  # symbol count
    lanes: int

    def compressed_nbytes(self) -> int:
        """Variable-length payload size (words + table + lens header)."""
        return int(self.lens.sum()) * 2 + self.table.nbytes() + self.lanes * 4


def _lane_layout(n: int, lanes: int) -> int:
    return -(-n // lanes)  # symbols per lane (ceil)


def _to_u16(vals: torch.Tensor) -> torch.Tensor:
    """int values in [0, 2**16) -> uint16 with the same bits."""
    return vals.to(torch.int16).view(torch.uint16)


def encode(symbols: torch.Tensor, table: FreqTable, lanes: int = 128) -> AnsStream:
    """Encode uint8 symbols (n,) with ``lanes`` interleaved rANS lanes.

    Symbols are consumed in reverse so decoding runs forward; the padding of
    the last row is masked (``n_valid = n``), not encoded."""
    from repro_torch.kernels import rans

    n = symbols.shape[0]
    per = _lane_layout(n, lanes)
    dev = symbols.device
    syms = torch.zeros(per * lanes, dtype=torch.uint8, device=dev)
    syms[:n] = symbols.reshape(-1)
    words, mask, state = rans.encode(syms.reshape(per, lanes), table.freq.to(dev),
                                     table.cum.to(dev), n)
    # compaction: lane j's words in emission order (rows per-1 .. 0), then
    # the 32-bit final state as two words, low half first
    emitted = mask.flip(0).to(torch.bool)
    pos = torch.cumsum(emitted.to(torch.int64), 0) - 1
    cnt = emitted.sum(0)
    lane_of = torch.arange(lanes, device=dev).expand(per, lanes)
    buf = torch.zeros((lanes, per + 2), dtype=torch.int32, device=dev)
    buf[lane_of[emitted], pos[emitted]] = words.flip(0)[emitted]
    st = state.to(torch.int64) & 0xFFFFFFFF
    ix = torch.arange(lanes, device=dev)
    buf[ix, cnt] = (st & 0xFFFF).to(torch.int32)
    buf[ix, cnt + 1] = (st >> 16).to(torch.int32)
    return AnsStream(words=_to_u16(buf), lens=(cnt + 2).to(torch.int32),
                     table=table, n=n, lanes=lanes)


def decode(stream: AnsStream) -> torch.Tensor:
    """Exact inverse of :func:`encode`; returns uint8 (n,)."""
    from repro_torch.kernels import rans

    per = _lane_layout(stream.n, stream.lanes)
    dev = stream.words.device
    table = FreqTable(freq=stream.table.freq.to(dev), cum=stream.table.cum.to(dev))
    syms = rans.decode_stream(stream.words, stream.lens, table.freq, table.cum,
                              _slot_to_symbol(table), per, stream.n)
    return syms.reshape(-1)[: stream.n]  # [step, lane] layout == original order


def roundtrip_exact(symbols: torch.Tensor, lanes: int = 128) -> bool:
    table = build_freq_table(symbols)
    out = decode(encode(symbols, table, lanes=lanes))
    return bool((out == symbols.reshape(-1).to(torch.uint8)).all())


def ans_ratio_estimate(exp_plane: torch.Tensor) -> torch.Tensor:
    """Predicted ANS bits/symbol from the quantised table (cross-entropy)."""
    counts = torch.bincount(exp_plane.reshape(-1).to(torch.int64),
                            minlength=NSYM)[:NSYM]
    table = build_freq_table(exp_plane)
    p = counts.to(torch.float32) / counts.sum().clamp_min(1).to(torch.float32)
    q = table.freq.to(torch.float32) / M
    return -torch.sum(torch.where(p > 0, p * torch.log2(q), 0.0))
