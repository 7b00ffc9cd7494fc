"""Keyed CommPlan cache (torch port of ``repro.sched.cache``): a repeated
wire signature hits a precompiled plan instead of re-deriving its
decisions.

The key is everything the compiled schedule depends on (tree signature,
policy fingerprint, axis names, device count, kind, kernel routing), so any
change that could alter the schedule misses and recompiles.  The store is an
LRU bounded by ``capacity`` (``None`` = unbounded; the process cache's is
``REPRO_PLAN_CACHE_CAP``, default 512); hits, misses and evictions are
counted.  :func:`save_plans` and :func:`load_plans` carry the plans across
a restart (next to a checkpoint: ``CheckpointManager.save_plans``).  Every
lookup mirrors the counts into the ``obs``
gauges (``plan_cache_*``, labeled ``default`` for the process cache and
``local`` for private instances), marks a hit with a ``plan_cache:hit``
instant and times a miss's compile in a ``plan_cache:compile`` span.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import threading
from typing import Callable, Optional

from repro_torch import obs
from repro_torch.sched.plan import CommPlan


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def compiles(self) -> int:
        return self.misses

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PlanCache:
    """Thread-safe keyed LRU plan store with hit/miss/eviction accounting."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None, got {capacity}")
        self._plans: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.capacity = capacity
        self.stats = CacheStats()

    def _obs_label(self) -> str:
        """Gauge label: the process cache is "default", private instances
        (tests, runs) are "local", so they cannot overwrite its series."""
        return "default" if self is globals().get("_DEFAULT") else "local"

    def _export_obs(self) -> None:
        """Mirror :meth:`cache_info` into the metrics registry (no-op when
        obs is off)."""
        if not obs.enabled():
            return
        label = self._obs_label()
        with self._lock:
            hits, misses = self.stats.hits, self.stats.misses
            evictions, size = self.stats.evictions, len(self._plans)
        obs.metric("plan_cache_hits").set(hits, cache=label)
        obs.metric("plan_cache_misses").set(misses, cache=label)
        obs.metric("plan_cache_evictions").set(evictions, cache=label)
        obs.metric("plan_cache_size").set(size, cache=label)

    def get_or_compile(self, key: tuple, compile_fn: Callable[[], CommPlan]) -> CommPlan:
        """Return the plan for ``key``, compiling (and storing) on a miss."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self.stats.hits += 1
        if plan is not None:
            obs.instant("plan_cache:hit", kind=getattr(plan, "kind", "?"),
                        cache=self._obs_label())
            self._export_obs()
            return plan
        # compile outside the lock: compiling is pure, so a racing double
        # compile is wasted work, not a fault
        with obs.span("plan_cache:compile", cache=self._obs_label()) as sp:
            plan = compile_fn()
            sp.args["kind"] = getattr(plan, "kind", "?")
        with self._lock:
            self._plans.setdefault(key, plan)
            self._plans.move_to_end(key)
            self.stats.misses += 1
            self._evict_over_capacity_locked()
        self._export_obs()
        return plan

    def _evict_over_capacity_locked(self) -> None:
        while self.capacity is not None and len(self._plans) > self.capacity:
            self._plans.popitem(last=False)
            self.stats.evictions += 1

    def cache_info(self) -> dict:
        """Hits, misses, evictions, size, capacity and hit rate."""
        with self._lock:
            return {
                "hits": self.stats.hits,
                "misses": self.stats.misses,
                "evictions": self.stats.evictions,
                "size": len(self._plans),
                "capacity": self.capacity,
                "hit_rate": self.stats.hit_rate,
            }

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, key) -> bool:
        return key in self._plans

    def clear(self) -> None:
        """Drop every stored plan; the lifetime counters stay (see
        :meth:`reset_stats`)."""
        with self._lock:
            self._plans.clear()
        self._export_obs()

    def reset_stats(self) -> None:
        """Zero the hit/miss/eviction counters without touching the plans."""
        with self._lock:
            self.stats = CacheStats()
        self._export_obs()


# ---------------------------------------------------------------------------
# Plan persistence: a CommPlan is pure hashable data (no tensors, devices or
# process groups; dtypes by name), so the compiled schedules pickle next to a
# checkpoint and reload after a restart.  Each plan carries the key it was
# compiled under (``CommPlan.key``), so the file is a tuple of plans.
# ---------------------------------------------------------------------------

# v2: CommPlan holds the ``broadcast`` field (BroadcastSchedule); files of
# another version are refused rather than half-loaded
_PLANS_VERSION = 2


def save_plans(path: str, cache: "PlanCache" = None) -> int:
    """Write every plan of ``cache`` (default: the process cache) to
    ``path`` (atomically: a temporary file, then a rename).  Returns the
    number saved."""
    cache = default_cache() if cache is None else cache
    with cache._lock:
        plans = tuple(cache._plans.values())
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        pickle.dump({"version": _PLANS_VERSION, "plans": plans}, f)
    os.replace(tmp, path)
    return len(plans)


def load_plans(path: str, cache: "PlanCache" = None, *, validate_backend: bool = True,
               device="cuda") -> int:
    """Load the plans :func:`save_plans` wrote into ``cache`` (default: the
    process cache), each under its own compile key.

    ``validate_backend`` (default) drops the plans whose recorded device and
    kernel routing differ from ``compile.probe_backend(device)``: a plan
    compiled on the card is not kept in a CPU process, nor the other way
    round (its key, which holds the probe, would never be looked up).
    Entries already present stay as they are, and loading counts as neither
    hit nor miss.  Returns the number of plans inserted."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("version") != _PLANS_VERSION:
        raise ValueError(f"unsupported plan-cache version in {path}: "
                         f"{payload.get('version')}")
    cache = default_cache() if cache is None else cache
    probe = None
    if validate_backend:
        from repro_torch.sched.compile import probe_backend

        probe = probe_backend(device)
    loaded = 0
    with cache._lock:
        for plan in payload["plans"]:
            if probe is not None and (plan.backend, plan.use_kernels) != probe:
                continue
            if plan.key not in cache._plans:
                cache._plans[plan.key] = plan
                loaded += 1
        cache._evict_over_capacity_locked()
    return loaded


# The process-default cache, bounded so that signature churn in a
# long-running loop cannot leak; tests make private PlanCache instances.
_DEFAULT = PlanCache(capacity=int(os.environ.get("REPRO_PLAN_CACHE_CAP", "512")))


def default_cache() -> PlanCache:
    return _DEFAULT


def cache_stats() -> CacheStats:
    return _DEFAULT.stats


def cache_info() -> dict:
    """``cache_info()`` of the process-default plan cache."""
    return _DEFAULT.cache_info()
