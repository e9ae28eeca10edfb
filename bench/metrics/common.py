"""What several metric readers share: the window's served work and the
percentiles of per-request times."""

from __future__ import annotations

import numpy as np


def per_request(run, key: str):
    """Each request's copy of a per-batch (or per-step) host time: every
    request of a batch waits the same prefill and the same steps."""
    out = []
    for b in run.batches:
        vals = b[key] if isinstance(b[key], list) else [b[key]]
        out.extend(vals * run.mix["batch"])
    return out


def p95_ms(values):
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95)) \
        * 1e3 if values else None


def window_flops(run) -> float:
    """Model FLOPs of every batch the window served (``work/``)."""
    b, s, n = run.mix["batch"], run.mix["max_prompt"], run.mix["new_tokens"]
    per_batch = run.work.prefill_flops(b, s) + sum(
        run.work.decode_flops(b, s + j) for j in range(n - 1))
    return per_batch * len(run.batches)


def mfu(run):
    from bench.peaks import BF16_FLOPS
    return 100.0 * window_flops(run) / (run.window_s * BF16_FLOPS)


def unprofiled(run):
    """The window's batches that ran outside the profiler: the profiler's
    own cost of launching a graph of thousands of kernels stretches the
    traced steps (an idle gap of about 8 ms before each OLMoE decode
    replay's first kernel, PERF.md), so device times are read here."""
    return [b for b in run.batches if not b.get("profiled")]


def idle_share(run, label: str, key: str):
    """100 × (1 - the device's busy seconds a traced step, the union of
    its busy intervals inside the spans named ``label`` over their count,
    ÷ the device time of the same steps outside the profiler: CUDA events
    ``key``, ``prefill_dev`` or ``decode_dev`` of the same step indices)."""
    from bench.trace import busy_in
    if run.trace is None or not run.trace.kernels:
        return None
    n = sum(name == label for name, _, _ in run.trace.spans)
    took = []
    for b in unprofiled(run):
        if key in b:
            took.extend(b[key][:n] if isinstance(b[key], list) else [b[key]])
    if not n or not took:
        return None
    busy = busy_in(run.trace, label) / n
    return 100.0 * (1.0 - busy / (sum(took) / len(took)))


def roofline(run, kernel: str, least_per_call, calls_per_prefill: int):
    """100 × the least time of ``calls_per_prefill`` calls a traced
    prefill (``least_per_call`` seconds each) over the summed time of the
    kernels whose name holds ``kernel`` inside the traced prefills."""
    from bench.trace import kernel_seconds
    if run.trace is None:
        return None
    took = kernel_seconds(run.trace.in_spans("bench.prefill"), kernel)
    prefills = sum(n == "bench.prefill" for n, _, _ in run.trace.spans)
    if took <= 0.0 or not prefills:
        return None
    return 100.0 * prefills * calls_per_prefill * least_per_call / took
