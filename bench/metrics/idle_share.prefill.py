"""The device's idle share in a prefill: 1 - its busy seconds (the
profile's union of busy intervals in the traced prefill) over its device
time outside the profiler (CUDA events, ``common.idle_share``)."""

from bench.metrics.common import idle_share


def read(run):
    return idle_share(run, "bench.prefill", "prefill_dev")
