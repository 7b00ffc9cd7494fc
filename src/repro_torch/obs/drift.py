"""Wire-ratio drift detection: live traffic vs compile-time prediction
(torch port of ``repro.obs.drift``).

Every ``CommPlan`` carries a compile-time wire-bytes prediction
(``plan.wire_bytes`` / ``delta_wire_bytes``); the widths and
compress-vs-raw gates behind it are frozen at plan-compile time.  When
live traffic drifts away from the calibration data — an RL policy update
that stopped being sub-ULP, a KV distribution shift — the live wire
ratio detaches from the prediction and the plan is *stale*.  This module
is the trigger signal a versioned-plan hot-swap would consume: a
windowed comparison of live vs predicted ratio per plan key, with
hysteresis so a sustained excursion fires exactly once
(``wire_drift_events_total{kind}`` + a ``drift:fire`` instant span) and
re-arms only after the window recovers.

The window holds *normalized residuals* — ``live/predicted`` at the time
each observation was made — not raw live ratios.  The prediction is
allowed to move between observations (a delta-planned sync predicts the
cheap delta wire once the receiver acks a base, the full wire before),
and comparing old raw ratios against the NEW prediction would read a
legitimate mode transition as drift.  Residuals make every window entry
self-normalizing: stationary traffic contributes exactly 1.0 regardless
of which regime it was observed under.

Static-wire paths cannot false-positive by construction: executor
collective wires are sized by the plan compiler from shapes alone, so
their live ratio EQUALS the prediction sample-for-sample (excess 0).
Data-dependent drift enters through the host paths — the sync engine's
delta→full→raw overflow fallbacks and the rANS codec's ``used_bytes`` —
which is exactly where the detector is plumbed.

Disabled mode (``REPRO_OBS=0``): :meth:`DriftDetector.observe` returns
``False`` without touching any state.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

from repro_torch.obs import config

DEFAULT_WINDOW = 8       # observations averaged per plan key
DEFAULT_MIN_COUNT = 3    # observations required before a verdict
DEFAULT_ENTER = 0.25     # fire when mean live ratio > predicted * (1+enter)
DEFAULT_EXIT = 0.10      # re-arm when it recovers below predicted * (1+exit)
EVENT_CAPACITY = 256     # fired events retained for the report


def _key_hex(key) -> str:
    """Stable-ish short id for a plan key; matches the executor's
    ``plan:<kind>`` span arg convention."""
    return f"{hash(key) & 0xFFFFFFFF:08x}"


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """One detector firing: a plan whose live window left its prediction."""
    key_hex: str
    kind: str
    predicted_ratio: float
    live_ratio: float  # window mean at fire time
    n_obs: int         # observations of this key when it fired

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class StalePlan:
    """A plan key currently beyond its hysteresis threshold."""
    key_hex: str
    kind: str
    predicted_ratio: float
    live_ratio: float  # current window mean
    events: int        # lifetime firings for this key
    n_obs: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Structured drift summary: every firing + the currently-stale keys."""
    events: tuple  # tuple[DriftEvent]
    stale: tuple   # tuple[StalePlan]

    def to_dict(self) -> dict:
        return {"events": [e.to_dict() for e in self.events],
                "stale": [s.to_dict() for s in self.stale]}


class _KeyState:
    __slots__ = ("kind", "predicted", "ring", "fired", "events", "n_obs")

    def __init__(self, kind: str, window: int):
        self.kind = kind
        self.predicted = 0.0
        self.ring = collections.deque(maxlen=window)
        self.fired = False
        self.events = 0
        self.n_obs = 0


class DriftDetector:
    """Windowed live-vs-predicted ratio comparison with hysteresis."""

    def __init__(self, *, window: int = DEFAULT_WINDOW,
                 min_count: int = DEFAULT_MIN_COUNT,
                 enter: float = DEFAULT_ENTER, exit: float = DEFAULT_EXIT):
        if not (enter > exit >= 0):
            raise ValueError(
                f"hysteresis wants enter > exit >= 0, got {enter=} {exit=}")
        self.window = window
        self.min_count = max(min_count, 1)
        self.enter = enter
        self.exit = exit
        self._lock = threading.Lock()
        self._state: dict = {}  # plan key -> _KeyState
        self._events = collections.deque(maxlen=EVENT_CAPACITY)

    def observe(self, key, kind: str, predicted_ratio: float,
                live_ratio: float) -> bool:
        """Record one (predicted, live) ratio pair; returns True iff the
        detector fired on THIS observation (once per excursion)."""
        if not config.enabled():
            return False
        if predicted_ratio <= 0:
            return False
        with self._lock:
            st = self._state.get(key)
            if st is None:
                st = self._state[key] = _KeyState(kind, self.window)
            st.predicted = float(predicted_ratio)
            # normalized residual: self-consistent even when the
            # prediction moves between observations (see module doc)
            st.ring.append(float(live_ratio) / st.predicted)
            st.n_obs += 1
            if len(st.ring) < self.min_count:
                return False
            mean_resid = sum(st.ring) / len(st.ring)
            excess = mean_resid - 1.0
            if st.fired:
                if excess < self.exit:
                    st.fired = False  # recovered: re-arm
                return False
            if excess <= self.enter:
                return False
            st.fired = True
            st.events += 1
            ev = DriftEvent(_key_hex(key), kind, st.predicted,
                            mean_resid * st.predicted, st.n_obs)
            self._events.append(ev)
        # metric + span emission outside the detector lock (the registry
        # and tracer have their own)
        from repro_torch import obs
        obs.metric("wire_drift_events_total").inc(kind=kind)
        obs.instant("drift:fire", kind=kind, plan_key=ev.key_hex,
                    predicted=round(ev.predicted_ratio, 4),
                    live=round(ev.live_ratio, 4))
        return True

    def observe_plan(self, plan, report) -> bool:
        """Convenience seam for the executor: compare a consolidated
        WireReport against its plan's compile-time prediction.

        The prediction covers EVERY bucket (raw-path buckets predict
        wire == raw), because the consolidated report may contain raw
        wires too — predicting compressed-only would read persistently
        high against mixed plans and false-fire on stationary traffic."""
        if report is None or report.raw_bytes <= 0:
            return False
        pred_wire = sum(b.wire_bytes if b.compressed else b.raw_bytes
                        for b in plan._flat_buckets())
        pred_raw = sum(b.raw_bytes for b in plan._flat_buckets())
        if pred_raw <= 0:
            return False
        return self.observe(plan.key, plan.kind, pred_wire / pred_raw,
                            report.ratio)

    def report(self) -> DriftReport:
        with self._lock:
            stale = tuple(
                StalePlan(_key_hex(k), st.kind, st.predicted,
                          st.predicted * sum(st.ring) / len(st.ring),
                          st.events, st.n_obs)
                for k, st in self._state.items() if st.fired)
            return DriftReport(events=tuple(self._events), stale=stale)

    def reset(self) -> None:
        with self._lock:
            self._state.clear()
            self._events.clear()


_DETECTOR = DriftDetector()


def detector() -> DriftDetector:
    """The process-default drift detector (executor/sync/serve feed it)."""
    return _DETECTOR


def observe(key, kind: str, predicted_ratio: float,
            live_ratio: float) -> bool:
    return _DETECTOR.observe(key, kind, predicted_ratio, live_ratio)


def observe_plan(plan, report) -> bool:
    return _DETECTOR.observe_plan(plan, report)


def reset() -> None:
    _DETECTOR.reset()
