"""Wire integrity: content checksums for host-path messages (torch port of
``repro.core.integrity``, numpy only and copied as it is).

The compressed wires are lossless *given intact bits* — a single flipped
bit in a packed plane decodes to silently wrong weights (the XOR-delta
wire is the worst case: corruption XORs straight into the receiver's
base).  Every host-path shipment therefore carries a cheap CRC-32 over
its payload, computed at encode time and re-verified by the receiver
BEFORE anything is applied (``serve.kv_transfer.unpack_cache``).
Mismatch means reject-and-renegotiate, never apply: the serve engine
re-packs the shipment under a bounded retry (``serve/engine._ship_kv``).

The checksum covers the *payload* (packed planes, exception lists, raw
arrays, bucket schedule strings), not the (version, epoch, base)
envelope: envelope fields are self-protecting — the receiver fences them
against its own state.

CRC-32 (zlib) is deliberate: integrity here defends against *transport
corruption* (the fault model injects bit flips), not adversaries, and
the checksum must stay far cheaper than the encode it protects.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np


class WireIntegrityError(ValueError):
    """A shipped payload failed its content checksum (or exhausted the
    bounded integrity-retry budget).  Receivers raise it BEFORE applying
    anything — corruption is detected, never installed."""


def crc32_bytes(data: bytes, seed: int = 0) -> int:
    return zlib.crc32(data, seed & 0xFFFFFFFF)


def tree_chunks(obj):
    """The byte chunks of every array/scalar reachable from ``obj``, in a
    fixed order: what :func:`crc32_tree` hashes.

    Walks tuples/lists/dicts/dataclasses natively (the host wire's message
    type ``p2p.engine.Message`` is a dataclass), giving each ndarray's
    dtype, shape and bytes and each scalar/str's repr.  Two payloads give
    equal chunks iff their bits agree."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        yield repr(obj).encode()
    elif isinstance(obj, bytes):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from tree_chunks(x)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=repr):
            yield from tree_chunks(k)
            yield from tree_chunks(obj[k])
    elif hasattr(obj, "shape") and hasattr(obj, "dtype"):
        arr = np.ascontiguousarray(np.asarray(obj))  # device -> host view
        yield str(arr.dtype).encode()
        yield repr(arr.shape).encode()
        yield arr.tobytes()
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tree_chunks(getattr(obj, f.name))
    else:
        yield repr(obj).encode()


def crc32_tree(obj, seed: int = 0) -> int:
    """CRC-32 over :func:`tree_chunks` of ``obj``.  Deterministic for a
    given payload, so sender and receiver agree iff the bits agree."""
    c = seed & 0xFFFFFFFF
    for chunk in tree_chunks(obj):
        c = zlib.crc32(chunk, c)
    return c


def flip_bit(arr: np.ndarray, bit_index: int) -> np.ndarray:
    """A copy of ``arr`` with one bit flipped in its raw byte stream —
    the fault injector's corruption primitive.  Never mutates the input
    (encoded messages may be shared)."""
    src = np.ascontiguousarray(np.asarray(arr))
    raw = bytearray(src.tobytes())
    if not raw:
        return src
    bit_index %= len(raw) * 8
    raw[bit_index // 8] ^= 1 << (bit_index % 8)
    return np.frombuffer(bytes(raw), dtype=src.dtype).reshape(src.shape)
