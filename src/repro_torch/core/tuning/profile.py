"""Measured per-block execution profiles (the port's copy of
``repro.core.tuning.profile``).

The cost models in ``core.cost`` price a block with per-dispatch overhead
and seconds per device-memory byte — analytic guesses (the ``gpu`` model's
H100 data-sheet rate and one launch price).  A :class:`Profile` is the
measured counterpart: one :class:`ProfileSample` per *warm* block
dispatch, keyed by ``(backend, signature digest)``, carrying the block's
wall time next to exactly the features the cost model prices (dispatch
count, external device-memory bytes, fabric bytes).  The calibrator
(``tuning.calibrate``) fits the coefficients from these samples.

Capture rides the executor's dispatch loop: when a :class:`Profiler` is
attached to a ``BlockExecutor``, each executable-cache *hit* is timed from
a synchronized device to a synchronized device (``torch.cuda.synchronize``
on both sides and ``time.perf_counter``: the host's wrapper call, the
launch and the kernel, the price ``launch_s`` stands for — profiling
trades the asynchronous pipeline for honest wall times) and recorded.
Cache misses are deliberately NOT recorded: a cold dispatch includes
kernel generation and compilation, which would poison a fit of
steady-state execution cost.  Run a workload at least twice to collect
samples.

Profiles persist as JSON so a warm process reuses a previous run's fit.
The file embeds the port's ``PROFILE_SCHEMA`` and
``core.cost.COST_REGISTRY_VERSION``; loading a profile written under
another schema (the JAX package's, which priced other backends on other
hardware) or another registry version raises :class:`StaleProfileError`.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

PROFILE_SCHEMA = "repro_torch_profile_v1"


class StaleProfileError(RuntimeError):
    """A persisted profile does not match this process's cost-model registry
    version — its samples priced a different feature set, so refitting from
    them would silently miscalibrate.  Delete the file and re-profile."""


def signature_digest(signature: Tuple) -> str:
    """Stable short digest of a block's canonical structural signature.

    The signature itself (``executor.block_signature``) is a nested tuple of
    renumbered uids, dtypes, shapes and strides — deterministic across
    processes — so its repr hashes to a process-independent key suitable
    for JSON persistence."""
    return hashlib.sha1(repr(signature).encode()).hexdigest()[:16]


@dataclass(frozen=True)
class ProfileSample:
    """One timed warm dispatch of one block on one backend."""

    backend: str        # lowering backend that ran the block
    sig: str            # signature_digest of the block's structural signature
    wall_s: float       # dispatch-to-materialized wall time
    dispatches: int     # executable dispatches the backend reported
    hbm_bytes: float    # external (block-boundary) bytes, the Def. 13 cost
    fabric_bytes: float  # interconnect bytes (0 until the mesh is ported)
    n_ops: int          # work ops in the block (diagnostics only)


class Profile:
    """An append-only bag of :class:`ProfileSample`\\ s with JSON persistence.

    ``grouped()`` collapses repeat dispatches of one ``(backend, sig)`` key
    to their *minimum* wall time — the least-noise estimate of steady-state
    cost (scheduling jitter and GC pauses only ever add time)."""

    def __init__(self, samples: Optional[List[ProfileSample]] = None):
        self.samples: List[ProfileSample] = list(samples or [])

    def __len__(self) -> int:
        return len(self.samples)

    def record(self, sample: ProfileSample) -> None:
        self.samples.append(sample)

    def merge(self, other: "Profile") -> "Profile":
        self.samples.extend(other.samples)
        return self

    def backends(self) -> Tuple[str, ...]:
        return tuple(sorted({s.backend for s in self.samples}))

    def grouped(self) -> Dict[Tuple[str, str], ProfileSample]:
        """Best (minimum-wall) sample per ``(backend, sig)`` key."""
        best: Dict[Tuple[str, str], ProfileSample] = {}
        for s in self.samples:
            key = (s.backend, s.sig)
            cur = best.get(key)
            if cur is None or s.wall_s < cur.wall_s:
                best[key] = s
        return best

    # -- persistence ---------------------------------------------------
    def save(self, path: str) -> None:
        from ..cost import COST_REGISTRY_VERSION
        doc = {
            "schema": PROFILE_SCHEMA,
            "registry_version": COST_REGISTRY_VERSION,
            "samples": [asdict(s) for s in self.samples],
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Profile":
        from ..cost import COST_REGISTRY_VERSION
        with open(path) as f:
            doc = json.load(f)
        if doc.get("schema") != PROFILE_SCHEMA:
            raise StaleProfileError(
                f"{path}: schema {doc.get('schema')!r} != {PROFILE_SCHEMA!r}")
        ver = doc.get("registry_version")
        if ver != COST_REGISTRY_VERSION:
            raise StaleProfileError(
                f"{path}: profile was captured under cost-model registry "
                f"version {ver!r}, this process has "
                f"{COST_REGISTRY_VERSION!r} — re-profile")
        return cls([ProfileSample(**s) for s in doc["samples"]])


class Profiler:
    """The executor-side timing hook (attach via ``BlockExecutor(profiler=)``
    or ``Runtime(profiler=)``).

    ``record`` is called by ``BlockExecutor.run_schedule`` once per timed
    warm dispatch with the measured wall seconds; the profiler derives the
    fit features from the block itself so measured and modelled quantities
    can never drift apart:

    * ``dispatches``   — the winning backend's own ``dispatches`` answer
      (the quantity ``CostModel.dispatch_price`` prices in the lower stage);
    * ``hbm_bytes``    — ``BlockInfo.ext_size("bytes")``, the Def. 13
      external-access cost the partitioner minimizes;
    * ``fabric_bytes`` — 0: no backend of the port moves bytes between
      cards yet (the reference's ``shard_map`` backend, ROADMAP A10b).
    """

    def __init__(self, profile: Optional[Profile] = None):
        self.profile = profile if profile is not None else Profile()

    def __len__(self) -> int:
        return len(self.profile)

    def record(self, backend: str, ops: Sequence, plan, ctx,
               wall_s: float) -> None:
        from ..backends import get_backend
        from ..blocks import BlockInfo
        work = [op for op in ops if not op.is_system()]
        info = BlockInfo.from_ops(ops)
        fabric = 0.0
        sample = ProfileSample(
            backend=backend,
            sig=signature_digest(plan.signature),
            wall_s=float(wall_s),
            dispatches=int(get_backend(backend).dispatches(ops, plan, ctx)),
            hbm_bytes=float(info.ext_size("bytes")),
            fabric_bytes=float(fabric),
            n_ops=len(work),
        )
        self.profile.record(sample)
        from ..obs import trace
        trace.instant("profiler.sample", backend=backend,
                      wall_s=sample.wall_s, sig=sample.sig)
