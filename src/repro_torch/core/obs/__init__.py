"""Observability for the PyTorch port: the span tracer and the metrics
registry behind ``BlockExecutor.stats`` (copies of ``repro.core.obs.trace``
and ``repro.core.obs.metrics``).  The reference's ``explain`` report is not
ported yet."""

from . import trace
from .metrics import MetricsRegistry, StatsView

__all__ = ["trace", "MetricsRegistry", "StatsView"]
