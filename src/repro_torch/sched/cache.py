"""Keyed CommPlan cache (torch port of ``repro.sched.cache``; saving and
loading plans come later): a repeated wire signature hits a precompiled
plan instead of re-deriving its decisions.

The key is everything the compiled schedule depends on (tree signature,
policy fingerprint, axis names, device count, kind, kernel routing), so any
change that could alter the schedule misses and recompiles.  The store is an
LRU bounded by ``capacity`` (``None`` = unbounded); hits, misses and
evictions are counted.  Every lookup mirrors the counts into the ``obs``
gauges (``plan_cache_*``, labeled ``default`` for the process cache and
``local`` for private instances), marks a hit with a ``plan_cache:hit``
instant and times a miss's compile in a ``plan_cache:compile`` span.
"""
from __future__ import annotations

import collections
import dataclasses
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
            while self.capacity is not None and len(self._plans) > self.capacity:
                self._plans.popitem(last=False)
                self.stats.evictions += 1
        self._export_obs()
        return plan

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


# The process-default cache, bounded so that signature churn in a
# long-running loop cannot leak; tests make private PlanCache instances.
_DEFAULT = PlanCache(capacity=512)


def default_cache() -> PlanCache:
    return _DEFAULT
