"""Keyed CommPlan cache (torch port of ``repro.sched.cache``; saving and
loading plans come later): a repeated wire signature hits a precompiled
plan instead of re-deriving its decisions.

The key is everything the compiled schedule depends on (tree signature,
policy fingerprint, axis names, device count, kind, kernel routing), so any
change that could alter the schedule misses and recompiles.  The store is an
LRU bounded by ``capacity`` (``None`` = unbounded); hits, misses and
evictions are counted.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Optional

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

    def get_or_compile(self, key: tuple, compile_fn: Callable[[], CommPlan]) -> CommPlan:
        """Return the plan for ``key``, compiling (and storing) on a miss."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self.stats.hits += 1
                return plan
        # compile outside the lock: compiling is pure, so a racing double
        # compile is wasted work, not a fault
        plan = compile_fn()
        with self._lock:
            self._plans.setdefault(key, plan)
            self._plans.move_to_end(key)
            self.stats.misses += 1
            while self.capacity is not None and len(self._plans) > self.capacity:
                self._plans.popitem(last=False)
                self.stats.evictions += 1
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

    def reset_stats(self) -> None:
        """Zero the hit/miss/eviction counters without touching the plans."""
        with self._lock:
            self.stats = CacheStats()


# The process-default cache, bounded so that signature churn in a
# long-running loop cannot leak; tests make private PlanCache instances.
_DEFAULT = PlanCache(capacity=512)


def default_cache() -> PlanCache:
    return _DEFAULT
