"""Mean idle gap between one decode replay's end and the next one's start
on the device (CUDA events around each step call): the host's turn
between steps, in the batches outside the profiler."""

from bench.metrics.common import unprofiled


def read(run):
    gaps = [g for b in unprofiled(run) for g in b.get("gaps_dev", [])]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
