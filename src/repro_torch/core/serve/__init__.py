"""Production serving layer (DESIGN.md §18) — the port of
``repro/core/serve``: thread-safe concurrent flushes over shared caches, a
disk-backed plan store for warm process starts, cross-request
micro-batching, and bounded admission control.

Public surface:

* :class:`Server` — the multi-tenant front door (``submit(tenant, fn)``);
* :class:`PlanStore` — persistent ``tape_signature`` → (blocks, lowering
  decisions) cache, corruption-tolerant by contract;
* :class:`AdmissionController` / :class:`ServeRejected` — bounded pending
  work with backpressure and per-tenant fairness.

Per-tenant sessions come from :meth:`repro_torch.core.lazy.Runtime.session`;
this package only orchestrates them.
"""

from .admission import AdmissionController, ServeRejected
from .server import Server
from .store import SERVE_STORE_VERSION, PlanStore

__all__ = ["AdmissionController", "PlanStore", "SERVE_STORE_VERSION",
           "Server", "ServeRejected"]
