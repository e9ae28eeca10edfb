"""The window's model FLOPs (``work/``: prefills and decode steps) over the
window's seconds times the bf16 peak, in a decode-heavy cell."""

from bench.metrics.common import mfu


def read(run):
    return mfu(run)
