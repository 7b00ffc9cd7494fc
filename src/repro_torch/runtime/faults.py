"""Deterministic fault injection for the weight-sync fleet (torch port of
``repro.runtime.faults``).

A chaos run proves something only if a failing run can be replayed: all
here is a function of a seed, so one :class:`FaultPlan` gives the same
schedule, the same flipped bits and the same recovery trace on every run,
and the reference's plan of the same seed gives the same ones (numpy's
``default_rng`` streams, drawn in the same order).

  * :class:`FaultPlan`: the seeded schedule.  Lifecycle events (replica
    ``kill``/``join``, ``trainer_restart``) are placed when it is generated;
    message faults (``drop``/``corrupt``/``delay``) are drawn from a stream
    of their own, one draw a delivered message.  ``FaultPlan.scripted`` pins
    faults to message ordinals for unit tests.
  * :class:`FaultyWire`: the hand-off between sender and receiver.
    ``send``/``drain`` is the only way the fleet moves messages; with
    ``plan=None`` it passes everything through.  Faults damage copies: the
    trainer's memoised updates are shared and are never changed in place.
  * :func:`corrupt_payload`: one bit flipped in one array of a payload
    (``core.integrity.flip_bit``).  Payloads without array content (acks,
    nacks) pass unchanged: control messages are only dropped or delayed.

Every injected fault is counted in ``FaultyWire.counts``, in the ``obs``
counter ``fault_injected_total`` by kind, and marked on the trace by a
``fault:inject`` instant.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core import integrity, packing

FAULT_KINDS = ("drop", "corrupt", "delay", "kill", "join", "trainer_restart")

# message faults the wire applies per delivery; the rest are lifecycle events
# the fleet applies per round
MESSAGE_FAULTS = ("drop", "corrupt", "delay")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled lifecycle fault."""

    round: int
    kind: str  # "kill" | "join" | "trainer_restart"
    target: str = ""  # replica name (kill/join); "" for trainer_restart


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs of :meth:`FaultPlan.generate`: rates are per delivered message,
    counts are totals over the plan's ``rounds``."""

    seed: int = 0
    rounds: int = 16  # message faults fire only while round <= rounds
    drop_rate: float = 0.05
    corrupt_rate: float = 0.05
    delay_rate: float = 0.05
    max_delay: int = 2  # a delayed message is held 1..max_delay rounds
    kills: int = 0
    joins: int = 0
    trainer_restarts: int = 0
    replicas: tuple = ()  # names eligible for kill


class FaultPlan:
    """A deterministic schedule of faults (module docstring)."""

    def __init__(self, *, events=(), message_faults: Optional[dict] = None,
                 seed: Optional[int] = None, cfg: Optional[FaultConfig] = None):
        self.cfg = cfg
        self.events = tuple(events)
        self._scripted = dict(message_faults) if message_faults is not None else None
        self._msg_rng = np.random.default_rng(seed) if seed is not None else None
        # corruption bits come from a stream of their own, so a drop added or
        # removed upstream does not change which bit later flips
        self.corrupt_rng = np.random.default_rng((seed if seed is not None else 0) + 0x5eed)
        self.msg_index = -1  # ordinal of the last message decided on

    @classmethod
    def generate(cls, cfg: FaultConfig) -> "FaultPlan":
        """The seeded chaos schedule: lifecycle events placed now, message
        faults drawn per delivery from ``seed + 1``."""
        if cfg.kills and not cfg.replicas:
            raise ValueError("kills > 0 requires cfg.replicas names")
        rng = np.random.default_rng(cfg.seed)
        events = []
        for _ in range(cfg.kills):
            name = cfg.replicas[int(rng.integers(len(cfg.replicas)))]
            events.append(FaultEvent(int(rng.integers(2, max(cfg.rounds, 3))), "kill", name))
        for i in range(cfg.joins):
            events.append(FaultEvent(int(rng.integers(2, max(cfg.rounds, 3))), "join",
                                     f"joiner-{i}"))
        for _ in range(cfg.trainer_restarts):
            events.append(FaultEvent(int(rng.integers(2, max(cfg.rounds, 3))),
                                     "trainer_restart"))
        events.sort(key=lambda e: (e.round, e.kind, e.target))
        return cls(events=events, seed=cfg.seed + 1, cfg=cfg)

    @classmethod
    def scripted(cls, message_faults: dict, events=()) -> "FaultPlan":
        """Faults pinned to message ordinals: ``{ordinal: "drop" | "corrupt" |
        ("delay", rounds)}``."""
        for v in message_faults.values():
            kind = v[0] if isinstance(v, tuple) else v
            if kind not in MESSAGE_FAULTS:
                raise ValueError(f"unknown message fault {v!r}")
        return cls(events=events, message_faults=message_faults)

    def events_for_round(self, r: int) -> tuple:
        return tuple(e for e in self.events if e.round == r)

    def message_fault(self, r: int) -> Optional[tuple]:
        """The fault of the next delivered message (the ordinal advances on
        every call): ``None`` or ``(kind, delay_rounds)``."""
        self.msg_index += 1
        if self._scripted is not None:
            f = self._scripted.get(self.msg_index)
            if f is None:
                return None
            if isinstance(f, tuple):
                return f
            return (f, 1 if f == "delay" else 0)
        cfg = self.cfg
        if self._msg_rng is None or cfg is None or r > cfg.rounds:
            return None  # past the horizon: the wire goes quiet
        u = float(self._msg_rng.random())
        if u < cfg.drop_rate:
            return ("drop", 0)
        if u < cfg.drop_rate + cfg.corrupt_rate:
            return ("corrupt", 0)
        if u < cfg.drop_rate + cfg.corrupt_rate + cfg.delay_rate:
            return ("delay", 1 + int(self._msg_rng.integers(cfg.max_delay)))
        return None


# The array fields of the wire messages, in the order in which the
# reference's pytree registration (``repro/core/packing.py``) flattens them:
# a bucket message's leaves, and so the bit a seed flips, are the reference's.
_DATA_FIELDS = {
    packing.PackedPlane: ("payload", "bases", "exc_idx", "exc_raw", "overflow"),
    packing.CompressedMessage: ("lo", "exp"),
    packing.DeltaPlane: ("payload", "exc_idx", "exc_raw", "overflow"),
    packing.DeltaMessage: ("lo", "exp"),
}


def _message_leaves(msg) -> list:
    """The arrays of a bucket message (a raw bucket is one array)."""
    fields = _DATA_FIELDS.get(type(msg))
    if fields is None:
        return [msg]
    return [leaf for f in fields for leaf in _message_leaves(getattr(msg, f))]


def _message_rebuild(msg, leaves):
    """A copy of ``msg`` holding the arrays of the iterator ``leaves``."""
    fields = _DATA_FIELDS.get(type(msg))
    if fields is None:
        return next(leaves)
    return dataclasses.replace(msg, **{f: _message_rebuild(getattr(msg, f), leaves)
                                       for f in fields})


def corrupt_payload(payload, rng):
    """One bit flipped in one array of ``payload`` (a deep enough copy), or
    ``None`` when the payload carries no array (a control message).

    Takes a ``sync.fleet.RoutedUpdate`` (its inner update), a
    ``sync.SyncUpdate`` (a bucket message's planes and exception lists, or a
    raw leaf) and the KV wire dict of ``serve.kv_transfer.pack_cache``."""

    def flip_in(leaves):
        cands = [i for i, leaf in enumerate(leaves)
                 if hasattr(leaf, "dtype") and getattr(leaf, "size", 0) > 0]
        if not cands:
            return None
        j = cands[int(rng.integers(len(cands)))]
        arr = np.asarray(leaves[j])
        bit = int(rng.integers(max(arr.size * arr.dtype.itemsize * 8, 1)))
        out = list(leaves)
        out[j] = integrity.flip_bit(arr, bit)
        return out

    if hasattr(payload, "update") and hasattr(payload, "route"):
        # a RoutedUpdate (a forwarded hop): corrupt the inner wire, never the
        # routing envelope, so the next hop's CRC check must catch it
        bad = corrupt_payload(payload.update, rng)
        if bad is None:
            return None
        return dataclasses.replace(payload, update=bad)
    if hasattr(payload, "buckets"):  # a SyncUpdate
        for bi in rng.permutation(len(payload.buckets)):
            dtn, members, mode, msg = payload.buckets[bi]
            flipped = flip_in(_message_leaves(msg))
            if flipped is None:
                continue
            buckets = list(payload.buckets)
            buckets[bi] = (dtn, members, mode, _message_rebuild(msg, iter(flipped)))
            return dataclasses.replace(payload, buckets=tuple(buckets))
        if payload.raw_leaves:
            raws = list(payload.raw_leaves)
            flipped = flip_in([a for _, a in raws])
            if flipped is not None:
                raws = [(i, f) for (i, _), f in zip(raws, flipped)]
                return dataclasses.replace(payload, raw_leaves=tuple(raws))
        return None
    if isinstance(payload, dict) and "messages" in payload:  # the KV wire
        for mi in rng.permutation(len(payload["messages"])):
            msg = payload["messages"][int(mi)]
            leaves = _host_leaves(msg)
            flipped = flip_in([leaf for _, leaf in leaves])
            if flipped is None:
                continue
            msgs = list(payload["messages"])
            msgs[int(mi)] = _host_rebuild(msg, leaves, flipped)
            return dict(payload, messages=msgs)
        return None
    return None


def _host_leaves(msg):
    """``(path, array)`` pairs of a host message: an ndarray, a dataclass
    (``p2p.engine.Message``) or nested dicts."""
    out = []

    def walk(o, path):
        if hasattr(o, "dtype") and hasattr(o, "shape"):
            out.append((path, o))
        elif isinstance(o, dict):
            for k in sorted(o, key=repr):
                walk(o[k], path + (("k", k),))
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name), path + (("f", f.name),))

    walk(msg, ())
    return out


def _host_rebuild(msg, leaves, flipped):
    """A copy of ``msg`` with the arrays at ``leaves``' paths replaced."""
    out = copy.copy(msg)
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        out = dataclasses.replace(out)  # a fresh instance
    for (path, _), new in zip(leaves, flipped):
        _set_path(out, path, new)
    return out


def _set_path(obj, path, value):
    if not path:
        raise ValueError("cannot replace the root payload in place")
    for kind, key in path[:-1]:
        nxt = obj[key] if kind == "k" else getattr(obj, key)
        # copy on write down the spine, so the original stays intact
        cp = dict(nxt) if isinstance(nxt, dict) else (
            dataclasses.replace(nxt) if dataclasses.is_dataclass(nxt) else nxt)
        if kind == "k":
            obj[key] = cp
        else:
            object.__setattr__(obj, key, cp)
        obj = cp
    kind, key = path[-1]
    if kind == "k":
        obj[key] = value
    else:
        object.__setattr__(obj, key, value)


class FaultyWire:
    """Message hand-off: ``send(dst, payload)`` applies the plan's fault of
    that message, ``drain(dst)`` pops what is deliverable this round.
    ``plan=None`` passes everything through."""

    def __init__(self, plan: Optional[FaultPlan] = None,
                 corrupter: Callable = corrupt_payload):
        self.plan = plan
        self.corrupter = corrupter
        self.round = 0
        self.sent = 0
        self.counts = {k: 0 for k in MESSAGE_FAULTS}
        self._queues: dict = {}  # dst -> [(payload, corrupted_flag)]
        self._delayed: list = []  # (due_round, dst, (payload, flag))

    def send(self, dst, payload) -> None:
        self.sent += 1
        if self.plan is None:
            self._queues.setdefault(dst, []).append((payload, False))
            return
        fault = self.plan.message_fault(self.round)
        if fault is None:
            self._queues.setdefault(dst, []).append((payload, False))
            return
        kind, arg = fault
        if kind == "corrupt":
            bad = self.corrupter(payload, self.plan.corrupt_rng)
            if bad is None:  # nothing to corrupt: deliver it as it is
                self._queues.setdefault(dst, []).append((payload, False))
                return
            self._count(kind, dst)
            self._queues.setdefault(dst, []).append((bad, True))
        elif kind == "drop":
            self._count(kind, dst)
        elif kind == "delay":
            self._count(kind, dst)
            self._delayed.append((self.round + max(int(arg), 1), dst, (payload, False)))

    def _count(self, kind: str, dst) -> None:
        self.counts[kind] += 1
        obs.metric("fault_injected_total").inc(kind=kind)
        obs.instant("fault:inject", kind=kind, dst=str(dst), round=self.round)

    def advance_round(self) -> None:
        """Start a new delivery round: matured delayed messages become
        deliverable (possibly out of order with fresh traffic)."""
        self.round += 1
        still = []
        for due, dst, item in self._delayed:
            if due <= self.round:
                self._queues.setdefault(dst, []).append(item)
            else:
                still.append((due, dst, item))
        self._delayed = still

    def drain(self, dst, with_flags: bool = False) -> list:
        """Pop every payload deliverable to ``dst`` this round; with
        ``with_flags`` each item is ``(payload, was_corrupted)``."""
        items = self._queues.pop(dst, [])
        if with_flags:
            return items
        return [p for p, _ in items]

    def pending(self) -> int:
        """Messages still in flight (delayed and queued, every destination)."""
        return len(self._delayed) + sum(len(v) for v in self._queues.values())
