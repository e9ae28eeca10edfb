"""Median device time of a prefill (CUDA events around the step call: the
tokens' copy to the card and the replay), in the batches outside the
profiler."""

import statistics

from bench.metrics.common import unprofiled


def read(run):
    steps = [b["prefill_dev"] for b in unprofiled(run) if "prefill_dev" in b]
    return 1e3 * statistics.median(steps) if steps else None
