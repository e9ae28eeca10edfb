"""The window's model FLOPs (``work/``: prefills and decode steps) over the
window's seconds times the bf16 peak, in a prefill-heavy cell."""

from bench.metrics.common import mfu


def read(run):
    return mfu(run)
