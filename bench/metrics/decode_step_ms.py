"""Median device time of a decode step (CUDA events around the step
call: the token's copy into the graph's input and the replay), in the
batches outside the profiler."""

import statistics

from bench.metrics.common import unprofiled


def read(run):
    steps = [t for b in unprofiled(run) for t in b.get("decode_dev", [])]
    return 1e3 * statistics.median(steps) if steps else None
