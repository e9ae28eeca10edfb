"""Admission control for the serving layer (DESIGN.md §18) — a copy of
``repro/core/serve/admission.py`` (pure Python).

Bounded pending work with backpressure: every request acquires a slot
before tracing and releases it after its results materialize, so a burst
cannot queue unbounded tapes (and their buffers) behind a slow flush.  An
optional per-tenant cap keeps one chatty tenant from occupying the whole
window — other tenants' requests are admitted while the greedy tenant
waits, which is the fairness policy: FIFO among admissible requests,
bounded share per tenant.

A full queue *waits* (backpressure) rather than failing; ``timeout``
bounds the wait, after which the request is rejected with
:class:`ServeRejected`.  Everything is instrumented on the shared metrics
registry: ``serve.admission.admitted`` / ``.rejected`` (per tenant),
``serve.admission.backpressure_waits`` and the live ``serve.queue_depth``
gauge.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, Optional

from ..obs.metrics import MetricsRegistry


class ServeRejected(RuntimeError):
    """Raised when a request cannot be admitted within its timeout."""


class AdmissionController:
    def __init__(self, max_pending: int = 64,
                 per_tenant: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.max_pending = int(max_pending)
        self.per_tenant = per_tenant
        self._cond = threading.Condition()
        self._pending = 0
        self._by_tenant: Dict[Hashable, int] = {}
        self._metrics = metrics if metrics is not None else MetricsRegistry()

    def bind_metrics(self, registry: MetricsRegistry) -> None:
        self._metrics = registry

    @property
    def pending(self) -> int:
        return self._pending

    def acquire(self, tenant: Hashable, timeout: Optional[float] = None) -> None:
        """Block until a slot is free (backpressure); raise
        :class:`ServeRejected` if none frees within ``timeout`` seconds
        (``timeout=0`` = reject immediately when full)."""
        reg = self._metrics

        def room() -> bool:
            if self._pending >= self.max_pending:
                return False
            if self.per_tenant is not None \
                    and self._by_tenant.get(tenant, 0) >= self.per_tenant:
                return False
            return True

        with self._cond:
            if not room():
                reg.counter("serve.admission.backpressure_waits").inc()
                if not self._cond.wait_for(room, timeout=timeout):
                    reg.counter("serve.admission.rejected",
                                ("tenant",)).inc(labels=(str(tenant),))
                    raise ServeRejected(
                        f"tenant {tenant!r}: queue full "
                        f"({self._pending}/{self.max_pending} pending)")
            self._pending += 1
            self._by_tenant[tenant] = self._by_tenant.get(tenant, 0) + 1
            reg.counter("serve.admission.admitted",
                        ("tenant",)).inc(labels=(str(tenant),))
            reg.gauge("serve.queue_depth").set(self._pending)

    def release(self, tenant: Hashable) -> None:
        with self._cond:
            self._pending = max(0, self._pending - 1)
            n = self._by_tenant.get(tenant, 1) - 1
            if n <= 0:
                self._by_tenant.pop(tenant, None)
            else:
                self._by_tenant[tenant] = n
            self._metrics.gauge("serve.queue_depth").set(self._pending)
            self._cond.notify_all()
