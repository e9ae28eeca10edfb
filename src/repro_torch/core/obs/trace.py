"""Span tracer with a near-zero disabled fast path and a Chrome
trace-event exporter (DESIGN.md §17).

The runtime is instrumented unconditionally — every pipeline stage calls
:func:`span` / :func:`instant` — so the disabled path must cost almost
nothing.  The fast path is one module-global load and an ``is None`` test:
``span()`` returns a preallocated no-op singleton when no tracer is
installed (under 100 ns per call: ``tests/test_torch_serve_trace.py``
holds :func:`disabled_span_overhead_ns` to it).

When a :class:`Tracer` is installed (:func:`enable`), events accumulate in
memory in Chrome trace-event form and export with
:meth:`Tracer.export_chrome` — load the JSON in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` to see a whole serving
session as one timeline.  Event kinds used by the runtime:

* complete spans (``ph: "X"``) — ``flush`` plus the six stages
  ``stage.trace`` / ``stage.graph`` / ``stage.partition`` /
  ``stage.schedule`` / ``stage.lower`` / ``stage.execute``, per-block
  ``block`` dispatches and backend ``build`` compiles; the serving steps'
  ``serve.*`` spans (``launch/serve.py``); the train step's
  ``train_step.*`` and the plain backwards of B3 and B5;
* instants (``ph: "i"``) — cache probes (``cache.merge``, ``cache.exec``),
  loop-fuser transitions (``loop.defer`` / ``loop.arm`` / ``loop.drain`` /
  ``loop.break``) and ``profiler.sample`` measurements;
* async pairs (``ph: "b"``/``"e"``) — ``loop.deferred``, spanning the whole
  deferred window from the first queued iteration to its drain.

Per-flush trace ids ride a context overlay (:func:`context`): ``Runtime.
flush`` sets ``flush=<n>`` once and every event emitted below it — planning,
block dispatches, backend builds, even a loop drain triggered by a later
flush — inherits the id in its ``args``; ``serve_requests`` sets
``batch=<n>`` the same way.

While a ``torch.profiler`` is recording, every span also opens a
``torch.profiler.record_function`` range of its name, so the program's
spans stand in the device trace on the profiler's own clock.

**Device spans and counters** (:func:`device_span`, :func:`counter_rows`,
:func:`count`) time and count work on the device inside a
:class:`DeviceRecord`, which a serving step opens around one eager call or
one CUDA-graph capture (:func:`new_record`, :func:`recording`).  On a CUDA
device a device span records a pair of timing events on the current
stream: captured, the pair becomes two event-record nodes of the graph and
every replay times it again.  On the CPU the work is synchronous and the
host clock times it.  Device counts are written (``out=``) by the counted
code into rows of the record's staging buffer, and the record adds what a
run staged into its accumulator when the run ends: one kernel a run, with
no host read, so it can be captured; :meth:`DeviceRecord.counters` reads
it once, after a synchronize.  With no tracer installed neither launches
anything.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["Tracer", "Span", "DeviceRecord", "enable", "disable", "active",
           "span", "device_span", "count", "counter_rows", "new_record",
           "recording", "instant", "context", "disabled_span_overhead_ns"]


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


def _profiler_range(name: str):
    """A ``torch.profiler.record_function`` range of ``name``, entered,
    while a profiler is recording; else None.  torch is looked up, not
    imported: where it is not loaded, no profiler can be recording."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return None
    rf = prof.record_function(name)
    rf.__enter__()
    return rf


class Span:
    """One live complete-event being timed (context manager)."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_t1", "_range")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = self._t1 = 0
        self._range = None

    def set(self, **args: Any) -> "Span":
        """Attach result args discovered while the span is open."""
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self._tracer.open_spans().append(self.name)
        self._range = _profiler_range(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: object) -> None:
        self._t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._tracer.open_spans().pop()
        self._tracer.complete(self.name, self._t0, self._t1, self.args)
        return None


class _TimedSpan(Span):
    """A device span off the card: the work is synchronous, so a host span,
    which its record keeps too."""

    __slots__ = ("_record",)

    def __init__(self, record: "DeviceRecord", name: str,
                 args: Dict[str, Any]):
        super().__init__(record.tracer, name, args)
        self._record = record

    def __exit__(self, *exc: object) -> None:
        super().__exit__(*exc)
        self._record._spans.append((self.name, self.args, self._t0,
                                    self._t1))


class _EventSpan:
    """A device span on a CUDA device: a pair of timing events recorded on
    the current stream (external, so a capture makes them event-record
    nodes of its graph), kept by the record."""

    __slots__ = ("_record", "name", "args", "_start", "_range")

    def __init__(self, record: "DeviceRecord", name: str,
                 args: Dict[str, Any]):
        self._record = record
        self.name = name
        self.args = args
        self._start = None
        self._range = None

    def set(self, **args: Any) -> "_EventSpan":
        self.args.update(args)
        return self

    def __enter__(self) -> "_EventSpan":
        self._record.tracer.open_spans().append(self.name)
        self._range = _profiler_range(self.name)
        self._start = self._record._event()
        return self

    def __exit__(self, *exc: object) -> None:
        end = self._record._event()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._record.tracer.open_spans().pop()
        self._record._spans.append((self.name, self.args, self._start, end))
        return None


#: the slots of one record's counter accumulator and of its staging buffer
COUNTER_SLOTS = 4096


class DeviceRecord:
    """The device spans and counters of one eager call or one CUDA-graph
    capture of a serving step on ``device`` (:func:`new_record`; the step
    keeps it and opens it with :func:`recording`).  ``runs`` counts the
    calls or replays that ran the recorded work: the step adds one at
    each.  After a synchronize, :meth:`spans` times the last run's device
    spans and :meth:`counters` sums every run's counts."""

    def __init__(self, tracer: "Tracer", device):
        import torch
        self.tracer = tracer
        self.device = torch.device(device)
        self.runs = 0
        self._on_card = self.device.type == "cuda"
        self._spans: List[Tuple[str, Dict[str, Any], Any, Any]] = []
        self._host: Dict[str, float] = {}
        self._run_host: Dict[str, float] = {}
        # the staged rows in the order a run asks for them:
        # (names, slots a row, first slot)
        self._rows: List[Tuple[Tuple[str, ...], int, int]] = []
        self._asked = 0
        # made here, before any capture: a captured run then writes and
        # adds into them, never fills what every replay would repeat
        self._stage = torch.zeros(COUNTER_SLOTS, dtype=torch.float32,
                                  device=self.device)
        self._acc = torch.zeros(COUNTER_SLOTS, dtype=torch.float64,
                                device=self.device)

    def _event(self):
        import torch
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        return ev

    def _span(self, name: str, args: Dict[str, Any]):
        if self._on_card:
            return _EventSpan(self, name, args)
        return _TimedSpan(self, name, args)

    def _add(self, name: str, value: float) -> None:
        """A host number: the last run's counts are those of every run."""
        self._run_host[name] = self._run_host.get(name, 0) + value

    def _staged(self, names: Tuple[str, ...], n: int):
        """The next ``(len(names), n)`` rows of the staging buffer; every
        run asks for the same rows in the same order."""
        i, self._asked = self._asked, self._asked + 1
        if i < len(self._rows):
            if self._rows[i][:2] != (names, n):
                raise ValueError(f"counter rows {names!r} of {n}: the "
                                 f"record's runs count different rows")
            at = self._rows[i][2]
        else:
            at = self._rows[-1][2] + len(self._rows[-1][0]) * \
                self._rows[-1][1] if self._rows else 0
            if at + len(names) * n > COUNTER_SLOTS:
                raise ValueError(f"counter rows {names!r}: the record's "
                                 f"{COUNTER_SLOTS} slots are spent")
            self._rows.append((names, n, at))
        return self._stage[at:at + len(names) * n].view(len(names), n)

    def _begin_run(self) -> None:
        """A run keeps its own device spans, counts its host numbers
        afresh and stages from the first row; a run that raises changes no
        count."""
        self._spans = []
        self._run_host = {}
        self._asked = 0

    def _end_run(self) -> None:
        """Add the rows this run staged into the accumulator: one kernel."""
        self._host = self._run_host
        if self._asked:
            names, n, at = self._rows[self._asked - 1]
            end = at + len(names) * n
            self._acc[:end].add_(self._stage[:end])
        self._asked = 0

    def spans(self) -> List[Tuple[str, Dict[str, Any], float, float]]:
        """``(name, args, start_ms, ms)`` of each device span of the last
        run, in the order the spans closed; ``start_ms`` from the first
        span's start.  Call it after a synchronize."""
        if not self._spans:
            return []
        first = self._spans[0][2]
        if self._on_card:
            return [(n, a, first.elapsed_time(s), s.elapsed_time(e))
                    for n, a, s, e in self._spans]
        return [(n, a, (s - first) / 1e6, (e - s) / 1e6)
                for n, a, s, e in self._spans]

    def counters(self) -> Dict[str, float]:
        """Each counter summed over every run since the record was made or
        :meth:`reset`: one read of the device, after a synchronize."""
        out = {k: v * self.runs for k, v in self._host.items()}
        if not self._rows:
            return out
        names, n, at = self._rows[-1]
        acc = self._acc[:at + len(names) * n].tolist()
        for names, n, at in self._rows:
            for i, name in enumerate(names):
                row = acc[at + i * n:at + (i + 1) * n]
                out[name] = out.get(name, 0) + sum(row)
        return out

    def reset(self) -> None:
        """Zero the counters and ``runs``."""
        self._acc.zero_()
        self.runs = 0


class Tracer:
    """In-memory event sink; one per :func:`enable` session.

    Events are stored directly in Chrome trace-event dict form with
    timestamps in microseconds relative to the tracer's epoch, so export is
    a plain ``json.dump``.  ``max_events`` bounds memory for long serving
    sessions (oldest events are NOT evicted — recording simply stops — so
    a truncated trace is still a valid prefix of the session).
    ``counters`` holds the host counters counted outside any
    :class:`DeviceRecord`."""

    def __init__(self, max_events: int = 1_000_000):
        self.events: List[Dict[str, Any]] = []
        self.max_events = max_events
        self.dropped = 0
        self.counters: Dict[str, float] = {}
        self._epoch_ns = time.perf_counter_ns()
        self._pid = os.getpid()
        # the context overlay, the open spans and the open record are
        # per-thread: concurrent serving flushes (DESIGN.md §18) each
        # carry their own ``flush=<n>`` without bleeding ids into events
        # another thread emits concurrently
        self._ctx_local = threading.local()

    @property
    def _ctx(self) -> Dict[str, Any]:
        d = getattr(self._ctx_local, "d", None)
        if d is None:
            d = {}
            self._ctx_local.d = d
        return d

    def open_spans(self) -> List[str]:
        """The names of this thread's open spans, outermost first."""
        stack = getattr(self._ctx_local, "stack", None)
        if stack is None:
            stack = self._ctx_local.stack = []
        return stack

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

    def device_span(self, name: str, args: Optional[Dict[str, Any]] = None):
        """A device span of this thread's open record; outside any record,
        a host span."""
        args = dict(args) if args else {}
        rec = getattr(self._ctx_local, "record", None)
        if rec is None:
            return Span(self, name, args)
        return rec._span(name, args)

    def count(self, name: str, value: float) -> None:
        """Add the host number ``value`` to counter ``name`` of this
        thread's open record; outside any record, to :attr:`counters`."""
        rec = getattr(self._ctx_local, "record", None)
        if rec is not None:
            rec._add(name, value)
        else:
            self.counters[name] = self.counters.get(name, 0) + value

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

    # -- context overlay and records -----------------------------------
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

    @contextlib.contextmanager
    def recording(self, record: DeviceRecord) -> Iterator[DeviceRecord]:
        """Open ``record`` on this thread: device spans and counters inside
        go to it."""
        saved = getattr(self._ctx_local, "record", None)
        self._ctx_local.record = record
        record._begin_run()
        try:
            yield record
            record._end_run()
        finally:
            self._ctx_local.record = saved

    # -- export ----------------------------------------------------------
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


def device_span(name: str, **args: Any):
    """A span of device work: inside an open :class:`DeviceRecord` a pair
    of timing events on a CUDA device (captured with the work, timed again
    by every replay), a host span on the CPU; outside any record a host
    span.  Disabled, the shared no-op singleton, as :func:`span`: a
    capture gets no extra nodes."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.device_span(name, args)


def count(name: str, value: float) -> None:
    """Add the host number ``value`` to counter ``name``: a constant of
    each run of the open record, or outside any record the tracer's
    :attr:`Tracer.counters`.  Disabled, nothing."""
    t = _TRACER
    if t is not None:
        t.count(name, value)


def counter_rows(names: Tuple[str, ...], n: int):
    """A ``(len(names), n)`` float32 view of the open record's staging
    buffer, row ``i`` counted to ``names[i]`` (the sum of its slots), for
    the counted code to write with ``out=`` kernels; the record adds the
    rows into its accumulator when the run ends.  None when no tracer is
    installed or this thread has no record open: code skips the kernels
    that make the counts."""
    t = _TRACER
    if t is None:
        return None
    rec = getattr(t._ctx_local, "record", None)
    return None if rec is None else rec._staged(tuple(names), n)


def new_record(device) -> Optional[DeviceRecord]:
    """A fresh :class:`DeviceRecord` on ``device``, or None when no tracer
    is installed."""
    t = _TRACER
    return None if t is None else DeviceRecord(t, device)


def recording(record: Optional[DeviceRecord]):
    """Context manager opening ``record`` on this thread (no-op for
    None)."""
    if record is None:
        return _NULL_CONTEXT
    return record.tracer.recording(record)


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


def disabled_span_overhead_ns(iterations: int = 10_000,
                              repeats: int = 50) -> float:
    """Measured cost of one disabled :func:`span` call in nanoseconds.

    Times a tight ``span("bench")`` loop with tracing forced off against an
    empty loop, the two in turn ``repeats`` times, and takes the least of
    each (noise only ever adds time).  ``tests/test_torch_serve_trace.py``
    holds it under 100 ns a span — the acceptance bar for "near-zero
    overhead when disabled"."""
    global _TRACER
    saved, _TRACER = _TRACER, None
    try:
        r = range(iterations)
        best = base = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in r:
                span("bench")
            best = min(best, time.perf_counter() - t0)
            t0 = time.perf_counter()
            for _ in r:
                pass
            base = min(base, time.perf_counter() - t0)
        return max(0.0, (best - base) / iterations * 1e9)
    finally:
        _TRACER = saved
