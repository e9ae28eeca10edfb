"""Disk-backed plan cache for warm process starts (DESIGN.md §18) — the
port of ``repro/core/serve/store.py``.

The merge cache makes the *second* flush of a structure cheap within one
process; the :class:`PlanStore` makes the *first* flush of a warm process
cheap too.  It persists exactly what the merge cache holds — block
structure (tape-index lists) plus per-block lowering decisions — and
nothing executable: kernels and floor functions are process-local, so a
warm start still builds them, but it skips graph, partition and lower.

Entries are keyed by the full merge-cache key (``cache.tape_signature``),
whose repr is stable across processes (nested tuples of primitives), and
land in one JSON file per key named by the key's sha256.  Writes publish
atomically (a ``mkstemp`` file, fsynced, then ``os.replace``), so a
concurrent writer or a crash mid-write never leaves a half-written entry
where a reader finds it: the old entry (or no entry) stays readable.

Every load is corruption-tolerant by contract: a truncated file, garbage
bytes, a foreign schema, a stale envelope — anything at all — degrades to a
clean cache miss with a counter bumped (``serve.store.corrupt`` /
``serve.store.stale``), never an exception into the serving path.

Envelope invalidation keys, beyond the filename's tape signature:

* ``version``                — this file format (``SERVE_STORE_VERSION``,
  the port's own token: an envelope the JAX package wrote reads here as a
  stale miss, and one written here reads as stale there);
* ``cost_registry_version``  — pricing semantics (``cost.py``): plans
  partitioned under an older cost registry are not replayed;
* ``calibration_epoch``      — checked only for ``epoch_sensitive``
  entries (keys priced by the ``calibrated`` model embed their epoch in
  the signature at ``key[2]``, so this catches doctored or hand-migrated
  files);
* ``key_repr``               — the full key, guarding against sha
  collisions and stale files renamed into place.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional, Tuple

from ..backends import LoweringDecision
from ..cost import COST_REGISTRY_VERSION
from ..obs import trace
from ..obs.metrics import MetricsRegistry
from ..tuning.calibrate import current_epoch

#: the envelope schema of the port's store; change it when the schema
#: changes, and older files become stale misses
SERVE_STORE_VERSION = "repro_torch_plan_v1"


class PlanStore:
    """One directory of atomically published plan files.

    Thread- and process-safe by construction: loads only read, stores only
    write-then-rename, and same-key racers write identical content (the
    key determines the plan).  Bind the owning executor's registry with
    :meth:`bind_metrics` so hits and misses land beside the runtime's other
    cache counters."""

    def __init__(self, root: str, metrics: Optional[MetricsRegistry] = None):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._metrics = metrics if metrics is not None else MetricsRegistry()

    def bind_metrics(self, registry: MetricsRegistry) -> None:
        self._metrics = registry

    def _count(self, name: str) -> None:
        self._metrics.counter(name).inc()

    def path_for(self, key: Tuple) -> str:
        digest = hashlib.sha256(repr(key).encode()).hexdigest()
        return os.path.join(self.root, digest + ".json")

    def __len__(self) -> int:
        return sum(1 for n in os.listdir(self.root) if n.endswith(".json"))

    def clear(self) -> None:
        for n in os.listdir(self.root):
            if n.endswith(".json"):
                try:
                    os.unlink(os.path.join(self.root, n))
                except OSError:
                    pass

    # -- write ---------------------------------------------------------
    def store(self, key: Tuple, blocks, decisions) -> bool:
        """Persist one plan; returns False (with ``serve.store.write_error``
        bumped) instead of raising on an I/O failure — persistence is an
        optimization, never a liveness dependency."""
        env = {
            "version": SERVE_STORE_VERSION,
            "cost_registry_version": COST_REGISTRY_VERSION,
            "calibration_epoch": current_epoch(),
            # key[2] is the cost model's cache token — non-empty exactly
            # when the model's prices move with the calibration epoch
            "epoch_sensitive": bool(key[2]),
            "key_repr": repr(key),
            "blocks": [[int(i) for i in b] for b in blocks],
            "decisions": (None if decisions is None else [
                None if d is None else
                {"backend": d.backend,
                 "declined": [[n, r] for n, r in d.declined]}
                for d in decisions]),
        }
        try:
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(env, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path_for(key))   # atomic publish
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            self._count("serve.store.write_error")
            return False
        self._count("cache.plan_store.write")
        return True

    # -- read ----------------------------------------------------------
    def load(self, key: Tuple):
        """The merge-cache-shaped entry ``(blocks, decisions)`` for ``key``,
        or None.  NEVER raises: every failure mode is a counted miss."""
        try:
            entry = self._load(key)
        except _Stale:
            self._count("serve.store.stale")
            entry = None
        except Exception:          # noqa: BLE001 — corruption is a miss
            self._count("serve.store.corrupt")
            entry = None
        trace.instant("cache.plan_store", hit=entry is not None)
        if entry is not None:
            self._count("cache.plan_store.hit")
        return entry

    def _load(self, key: Tuple):
        try:
            with open(self.path_for(key)) as f:
                env = json.load(f)
        except FileNotFoundError:
            self._count("cache.plan_store.miss")
            return None
        if not isinstance(env, dict):
            raise ValueError("envelope is not an object")
        if (env.get("version") != SERVE_STORE_VERSION
                or env.get("cost_registry_version") != COST_REGISTRY_VERSION
                or env.get("key_repr") != repr(key)):
            raise _Stale()
        if env.get("epoch_sensitive") \
                and env.get("calibration_epoch") != current_epoch():
            raise _Stale()
        blocks = tuple(tuple(int(i) for i in b) for b in env["blocks"])
        raw = env["decisions"]
        if raw is None:
            decisions = None
        else:
            decisions = tuple(
                None if d is None else LoweringDecision(
                    backend=str(d["backend"]),
                    declined=tuple((str(n), str(r))
                                   for n, r in d["declined"]))
                for d in raw)
        return blocks, decisions


class _Stale(Exception):
    """Internal: a well-formed envelope whose invalidation keys mismatch."""
