"""Span tracer with a near-zero disabled fast path and a Chrome
trace-event exporter (DESIGN.md §17).

The runtime is instrumented unconditionally — every pipeline stage calls
:func:`span` / :func:`instant` — so the disabled path must cost almost
nothing.  The fast path is one module-global load and an ``is None`` test:
``span()`` returns a preallocated no-op singleton when no tracer is
installed (measured well under 100 ns per call; ``benchmarks/run_all.py``
gates this in CI via :func:`disabled_span_overhead_ns`).

When a :class:`Tracer` is installed (:func:`enable`), events accumulate in
memory in Chrome trace-event form and export with
:meth:`Tracer.export_chrome` — load the JSON in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` to see a whole serving
session as one timeline.  Event kinds used by the runtime:

* complete spans (``ph: "X"``) — ``flush`` plus the six stages
  ``stage.trace`` / ``stage.graph`` / ``stage.partition`` /
  ``stage.schedule`` / ``stage.lower`` / ``stage.execute``, per-block
  ``block`` dispatches and backend ``build`` compiles;
* instants (``ph: "i"``) — cache probes (``cache.merge``, ``cache.exec``),
  loop-fuser transitions (``loop.defer`` / ``loop.arm`` / ``loop.drain`` /
  ``loop.break``) and ``profiler.sample`` measurements;
* async pairs (``ph: "b"``/``"e"``) — ``loop.deferred``, spanning the whole
  deferred window from the first queued iteration to its drain.

Per-flush trace ids ride a context overlay (:func:`context`): ``Runtime.
flush`` sets ``flush=<n>`` once and every event emitted below it — planning,
block dispatches, backend builds, even a loop drain triggered by a later
flush — inherits the id in its ``args``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = ["Tracer", "Span", "enable", "disable", "active", "span",
           "instant", "context", "traced", "disabled_span_overhead_ns"]


class _NullSpan:
    """The disabled-mode span: a preallocated, argument-free singleton."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None

    def set(self, **args: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class Span:
    """One live complete-event being timed (context manager)."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0

    def set(self, **args: Any) -> "Span":
        """Attach result args discovered while the span is open."""
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: object) -> None:
        self._tracer.complete(self.name, self._t0, time.perf_counter_ns(),
                              self.args)
        return None


class Tracer:
    """In-memory event sink; one per :func:`enable` session.

    Events are stored directly in Chrome trace-event dict form with
    timestamps in microseconds relative to the tracer's epoch, so export is
    a plain ``json.dump``.  ``max_events`` bounds memory for long serving
    sessions (oldest events are NOT evicted — recording simply stops — so
    a truncated trace is still a valid prefix of the session)."""

    def __init__(self, max_events: int = 1_000_000):
        self.events: List[Dict[str, Any]] = []
        self.max_events = max_events
        self.dropped = 0
        self._epoch_ns = time.perf_counter_ns()
        self._pid = os.getpid()
        # the context overlay is per-thread: concurrent serving flushes
        # (DESIGN.md §18) each carry their own ``flush=<n>`` without
        # bleeding ids into events another thread emits concurrently
        self._ctx_local = threading.local()

    @property
    def _ctx(self) -> Dict[str, Any]:
        d = getattr(self._ctx_local, "d", None)
        if d is None:
            d = {}
            self._ctx_local.d = d
        return d

    # -- low-level emitters --------------------------------------------
    def _emit(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def _base(self, name: str, ph: str, t_ns: int,
              args: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        merged = dict(self._ctx)
        if args:
            merged.update(args)
        return {"name": name, "ph": ph, "cat": "repro",
                "ts": round((t_ns - self._epoch_ns) / 1000.0, 3),
                "pid": self._pid, "tid": threading.get_ident() % 1_000_000,
                "args": merged}

    def complete(self, name: str, t0_ns: int, t1_ns: int,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record a finished span given raw ``perf_counter_ns`` endpoints —
        the retroactive form ``Runtime.flush`` uses for ``stage.trace``
        (recording happened before the flush span opened)."""
        ev = self._base(name, "X", t0_ns, args)
        ev["dur"] = round((t1_ns - t0_ns) / 1000.0, 3)
        self._emit(ev)

    def span(self, name: str, args: Optional[Dict[str, Any]] = None) -> Span:
        return Span(self, name, dict(args) if args else {})

    def instant(self, name: str, args: Optional[Dict[str, Any]] = None) -> None:
        ev = self._base(name, "i", time.perf_counter_ns(), args)
        ev["s"] = "t"                      # thread-scoped instant
        self._emit(ev)

    def async_begin(self, name: str, aid: str,
                    args: Optional[Dict[str, Any]] = None) -> None:
        ev = self._base(name, "b", time.perf_counter_ns(), args)
        ev["id"] = aid
        self._emit(ev)

    def async_end(self, name: str, aid: str,
                  args: Optional[Dict[str, Any]] = None) -> None:
        ev = self._base(name, "e", time.perf_counter_ns(), args)
        ev["id"] = aid
        self._emit(ev)

    # -- context overlay -----------------------------------------------
    @contextlib.contextmanager
    def context(self, **kv: Any) -> Iterator[None]:
        """Merge ``kv`` into the args of every event emitted inside."""
        missing = object()
        saved = {k: self._ctx.get(k, missing) for k in kv}
        self._ctx.update(kv)
        try:
            yield
        finally:
            for k, old in saved.items():
                if old is missing:
                    self._ctx.pop(k, None)
                else:
                    self._ctx[k] = old

    # -- inspection & export -------------------------------------------
    def span_counts(self) -> Dict[str, int]:
        """Event counts by name — the bench snapshot's per-flush profile."""
        counts: Dict[str, int] = {}
        for ev in self.events:
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
        return counts

    def to_chrome(self) -> Dict[str, Any]:
        """The trace as a Chrome trace-event JSON object (Perfetto/
        ``chrome://tracing`` loadable)."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.core.obs.trace",
                              "dropped_events": self.dropped}}

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")


# ---------------------------------------------------------------------------
# Module-level fast path
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None
_NULL_CONTEXT = contextlib.nullcontext()


def active() -> Optional[Tracer]:
    """The installed tracer, or None.  Hot loops hoist this once and skip
    their per-item instrumentation entirely when it returns None."""
    return _TRACER


def enable(tracer: Optional[Tracer] = None) -> Tracer:
    """Install (and return) a tracer; subsequent runtime work records into
    it until :func:`disable`."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    return _TRACER


def disable() -> Optional[Tracer]:
    """Uninstall the tracer and return it (for export/inspection)."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def span(name: str, **args: Any):
    """Open a span context manager — the universal instrumentation call.

    Disabled mode is ONE global load + ``is None`` test returning a shared
    no-op singleton; nothing is allocated and no clock is read."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, args)


def instant(name: str, **args: Any) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, args)


def context(**kv: Any):
    """Context manager merging ``kv`` into every event emitted inside
    (no-op when disabled)."""
    t = _TRACER
    if t is None:
        return _NULL_CONTEXT
    return t.context(**kv)


def traced(name: Optional[str] = None) -> Callable:
    """Decorator form: ``@traced()`` wraps the call in a span named after
    the function (disabled mode adds one global load per call)."""
    def deco(fn: Callable) -> Callable:
        label = name if name is not None else fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a: Any, **kw: Any) -> Any:
            t = _TRACER
            if t is None:
                return fn(*a, **kw)
            with t.span(label):
                return fn(*a, **kw)
        return wrapper
    return deco


def disabled_span_overhead_ns(iterations: int = 200_000,
                              repeats: int = 7) -> float:
    """Measured cost of one disabled :func:`span` call in nanoseconds.

    Benchmarks a tight ``span("bench")`` loop with tracing forced off and
    subtracts an empty-loop baseline, taking the minimum over ``repeats``
    (noise only ever adds time).  ``benchmarks/run_all.py`` records this in
    the ``obs`` snapshot section and ``--compare`` gates it at
    100 ns/span — the acceptance bar for "near-zero overhead when
    disabled"."""
    global _TRACER
    saved, _TRACER = _TRACER, None
    try:
        r = range(iterations)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in r:
                span("bench")
            best = min(best, time.perf_counter() - t0)
        base = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in r:
                pass
            base = min(base, time.perf_counter() - t0)
        return max(0.0, (best - base) / iterations * 1e9)
    finally:
        _TRACER = saved
