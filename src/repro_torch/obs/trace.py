"""Comm-span tracer with Chrome-trace/Perfetto export (torch port of
``repro.obs.trace``).

Spans make the runtime's overlap claims *verifiable instead of asserted*:
``with obs.span("plan:psum", plan_key=...)`` records a wall-clock
(``perf_counter``) interval into a bounded ring buffer; spans nest (a
per-thread stack tracks depth), and :func:`export_chrome_trace` writes the
buffer as Chrome-trace JSON (``{"traceEvents": [{"ph": "X", "ts", "dur",
"name", "pid", "tid", "args"}, ...]}``) that loads directly in
Perfetto / ``chrome://tracing`` — a train step, a wsync publish fan-out or
a serve admission renders as a readable timeline.

Point-in-time markers (cache hits, retries) are ``instant`` events
(``ph: "i"``).  The ring buffer (``REPRO_OBS_SPAN_CAP``, default 65536)
keeps the newest records; ``REPRO_TRACE_DIR`` names the default export
directory.  Span names follow ``<subsystem>:<operation>`` — the canonical
list lives in ``obs/names.py``.

Timestamps are relative to a process-wide epoch taken at import, so one
export shows every thread on a common clock.  With ``REPRO_OBS=0``,
``span()``/``instant()`` collapse to a shared no-op.  A span reads the
host clock only: it never synchronises the device, so around work that
launches kernels it measures the host's enqueue, unless the wrapped code
waits for the device itself.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import threading
import time

from repro_torch.obs import config

DEFAULT_SPAN_CAPACITY = int(os.environ.get("REPRO_OBS_SPAN_CAP", "65536"))

_EPOCH = time.perf_counter()


def trace_dir() -> str:
    """Default Chrome-trace output directory (``REPRO_TRACE_DIR``)."""
    return os.environ.get(
        "REPRO_TRACE_DIR", os.path.join(tempfile.gettempdir(),
                                        "repro_traces"))


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One completed span (or instant marker) in the ring buffer."""

    name: str
    ts: float  # seconds since the tracer epoch (start time)
    dur: float  # seconds; 0.0 for instants
    tid: int
    depth: int  # nesting depth at start (0 = top-level) in its thread
    args: dict
    ph: str = "X"  # Chrome phase: "X" complete span, "i" instant


class _NoopSpan:
    """Shared do-nothing span for REPRO_OBS=0 (reentrant, stateless)."""

    __slots__ = ()

    dur = 0.0
    depth = 0

    @property
    def args(self) -> dict:  # assignments vanish by design
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    """Live span handle: ``with tracer.span(...) as sp: sp.args[...] = ...``.

    The args dict is read at exit, so instrumentation may attach values
    discovered inside the span body (e.g. the plan kind a cache compile
    produced)."""

    __slots__ = ("_tracer", "name", "args", "t0", "dur", "depth")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.dur = 0.0
        self.depth = 0

    def __enter__(self):
        stack = self._tracer._stack()
        self.depth = len(stack)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.dur = t1 - self.t0
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record(SpanRecord(
            name=self.name, ts=self.t0 - _EPOCH, dur=self.dur,
            tid=threading.get_ident(), depth=self.depth, args=self.args))
        return False


def _jsonable(v):
    return v if isinstance(v, (int, float, str, bool, type(None))) else str(v)


class SpanTracer:
    """Bounded ring buffer of spans with per-thread nesting stacks."""

    def __init__(self, capacity: int = DEFAULT_SPAN_CAPACITY) -> None:
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._buf.append(rec)

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **args) -> _Span:
        """Context manager recording one wall-clock span (nestable)."""
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Record a point-in-time marker (Chrome ``ph: "i"``)."""
        self._record(SpanRecord(
            name=name, ts=time.perf_counter() - _EPOCH, dur=0.0,
            tid=threading.get_ident(), depth=len(self._stack()), args=args,
            ph="i"))

    # -- inspection / export -------------------------------------------------

    def spans(self) -> tuple:
        """Buffered records, oldest first (completion order per thread)."""
        with self._lock:
            return tuple(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def export_chrome_trace(self, path: str = None) -> str:
        """Write the buffer as Chrome-trace JSON; returns the path.

        Default path: ``<REPRO_TRACE_DIR>/trace_<pid>.json``.  The format
        is the Trace Event Format's JSON-object flavor (``traceEvents`` +
        ``displayTimeUnit``), timestamps in microseconds — loadable in
        Perfetto and ``chrome://tracing`` as-is."""
        if path is None:
            path = os.path.join(trace_dir(), f"trace_{os.getpid()}.json")
        pid = os.getpid()
        events = []
        for r in self.spans():
            ev = {
                "name": r.name,
                "ph": r.ph,
                "pid": pid,
                "tid": r.tid,
                "ts": round(r.ts * 1e6, 3),
                "cat": r.name.split(":", 1)[0],
                "args": {k: _jsonable(v) for k, v in r.args.items()},
            }
            if r.ph == "X":
                ev["dur"] = round(r.dur * 1e6, 3)
            else:
                ev["s"] = "t"  # thread-scoped instant
            events.append(ev)
        events.sort(key=lambda e: e["ts"])
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        os.replace(tmp, path)
        return path


_TRACER = SpanTracer()


def tracer() -> SpanTracer:
    """The process-default tracer every instrumented module records into."""
    return _TRACER


def span(name: str, **args):
    """``with obs.span("plan:psum", plan_key=...):`` — no-op when disabled."""
    if not config.enabled():
        return NOOP_SPAN
    return _TRACER.span(name, **args)


def instant(name: str, **args) -> None:
    if not config.enabled():
        return
    _TRACER.instant(name, **args)


def spans() -> tuple:
    return _TRACER.spans()


def clear_spans() -> None:
    _TRACER.clear()


def export_chrome_trace(path: str = None) -> str:
    return _TRACER.export_chrome_trace(path)
