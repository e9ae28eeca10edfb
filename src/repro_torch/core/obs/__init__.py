"""Observability for the PyTorch port: the span tracer, the metrics
registry behind ``BlockExecutor.stats`` and the fusion-decision explain
report (copies of ``repro.core.obs.trace``, ``repro.core.obs.metrics`` and
``repro.core.obs.explain``).

* :mod:`repro_torch.core.obs.trace`   — spans with a near-zero disabled
  fast path and a Chrome trace-event JSON exporter;
* :mod:`repro_torch.core.obs.metrics` — counters, gauges and histograms
  with labels;
* :mod:`repro_torch.core.obs.explain` — for one flush, the priced story of
  every fusion decision: merges taken vs rejected, per-backend lowering
  verdicts, cache provenance and the loop-fuser state machine.
"""

from . import trace
from .explain import ExplainReport, explain
from .metrics import MetricsRegistry, StatsView

__all__ = ["trace", "explain", "ExplainReport", "MetricsRegistry",
           "StatsView"]
