"""What the traced run reads from ``torch.profiler``: the device's kernels
(name, start, end) and the harness's own spans (``record_function``
ranges around each step call, ``bench.prefill`` and ``bench.decode``),
both on the profiler's clock, in seconds; and the reductions the
per-layer metrics share."""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Tuple

SPANS = ("bench.prefill", "bench.decode")
#: a device operation's name in the breakdown is cut to this length
NAME_CHARS = 160

Interval = Tuple[float, float]


@dataclass
class Trace:
    kernels: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]

    def __post_init__(self):
        self.kernels.sort(key=lambda k: k[1])
        self._starts = [k[1] for k in self.kernels]

    def starting_in(self, s: float, e: float):
        """The kernels that start in ``[s, e]``, by start."""
        return self.kernels[bisect.bisect_left(self._starts, s):
                            bisect.bisect_right(self._starts, e)]

    @property
    def window(self) -> Interval:
        return (min(s for _, s, _ in self.spans),
                max(e for _, _, e in self.spans))

    def in_spans(self, label: str):
        """The kernels that start inside a span named ``label``: each step
        synchronises inside its span, so its kernels all run there."""
        return [k for n, s, e in sorted(self.spans) if n == label
                for k in self.starting_in(s, e)]

    def span_seconds(self, label: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == label)


def from_profile(prof) -> Trace:
    from torch.autograd import DeviceType
    kernels, spans = [], []
    for e in prof.events():
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            if e.name in SPANS or getattr(e, "is_user_annotation", False):
                continue
            kernels.append((e.name, start, end))
        elif e.name in SPANS:
            spans.append((e.name, start, end))
    return Trace(kernels=kernels, spans=spans)


def union(intervals) -> float:
    """Seconds covered by the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def busy_seconds(trace: Trace) -> float:
    lo, hi = trace.window
    return union((max(s, lo), min(e, hi)) for _, s, e in trace.kernels
                 if e > lo and s < hi)


def kernel_seconds(kernels, name_part: str) -> float:
    return sum(e - s for n, s, e in kernels if name_part in n)


def breakdown(trace: Trace, n: int = 10) -> dict:
    """The ``n`` device operations with most time (summed by name) and the
    ``n`` longest idle gaps of the traced window, each named by where the
    host spent most of it: a span's ``:lead`` (from its start to its first
    kernel), ``:inner`` (between its kernels) or ``:tail`` (from its last
    kernel's end to its end), or ``host`` outside every span."""
    by = {}
    for name, s, e in trace.kernels:
        by[name] = by.get(name, 0.0) + (e - s)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    lo, hi = trace.window
    gaps, end = [], lo
    for _, s, e in trace.starting_in(lo, hi):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    named = [[_label(trace, a, b), b - a]
             for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]]
    return {"device_ops": [[k[:NAME_CHARS], v] for k, v in ops],
            "idle_gaps": named}


def _label(trace: Trace, a: float, b: float) -> str:
    best, label = 0.0, "host"
    for name, s, e in trace.spans:
        inside = trace.starting_in(s, e)
        if not inside:
            continue
        k0, k1 = inside[0][1], max(k[2] for k in inside)
        for part, lo, hi in ((":lead", s, k0), (":inner", k0, k1),
                             (":tail", k1, e)):
            overlap = min(b, hi) - max(a, lo)
            if overlap > best:
                best, label = overlap, name + part
    return label if best > (b - a) / 2 else "host"


def busy_in(trace: Trace, label: str) -> float:
    """Seconds the device was busy inside the spans named ``label``."""
    return sum(union((max(a, s), min(b, e)) for _, a, b in
                     trace.starting_in(s, e)) for n, s, e in trace.spans
               if n == label)
