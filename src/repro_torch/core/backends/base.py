"""The lowering-backend protocol and the per-block selection rule
(DESIGN.md §14).

A :class:`LoweringBackend` is one way to turn a fusion block (a
``BlockPlan`` plus its ops) into an executable with the ``make_block_fn``
calling convention ``fn(*input_bufs, salts) -> output_bufs``.  This is the
PyTorch port's copy of ``repro.core.backends.base``.  Backends are
*peers* registered under a name — the executor is a dispatch engine over
the registry, and the scheduler's **lower** stage decides per block which
backend runs it:

1. every backend in the policy's preference-ordered candidate list is asked
   whether it *claims* the block (``claims`` returns ``None``, or a stable
   reason slug explaining why it cannot express the block);
2. the first claimant in preference order wins.  (The reference also
   prices claimants per dispatch; with one fused-block generator and the
   floor that pricing is always a tie, so it waits for loop fusion and the
   calibrated cost model.)

The decision is recorded on the ``BlockPlan`` (and in the merge cache), so
steady-state flushes skip both partitioning and backend probing, and the
executed schedule matches exactly what the cost model priced.

Everything here is pure metadata — no device access — so selection is
cheap enough to run inside the scheduler.  Backend modules import their
heavyweight dependencies (the codegen, the executor's op tables) lazily
inside methods to keep the core import graph acyclic.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class LoweringContext:
    """Executor configuration a backend may need to claim or build a block:
    the RNG seed and the device the block's buffers live on.  It carries no
    buffers: backends build functions, the executor owns the store."""

    seed: int = 0
    device: torch.device = torch.device("cpu")


@dataclass(frozen=True)
class LoweringDecision:
    """Outcome of the lower stage for one block.

    ``backend`` names the winning backend; ``declined`` records, for every
    backend the policy *preferred* over the winner, the reason slug it gave
    for not claiming the block — the executor turns these into per-backend
    fallback stats (``stats["backend_fallbacks"]``).
    """

    backend: str
    declined: Tuple[Tuple[str, str], ...] = ()

    def reason_for(self, name: str) -> Optional[str]:
        """Why ``name`` declined this block (None if it did not decline)."""
        return dict(self.declined).get(name)


@dataclass(frozen=True)
class LoweringPolicy:
    """What the executor hands the scheduler: the preference-ordered
    candidate backend names plus the context they compile under.  The name
    tuple is part of the merge-cache key — decisions made for one backend
    stack are never replayed under another."""

    backends: Tuple[str, ...]
    ctx: LoweringContext

    def key(self) -> Tuple[str, ...]:
        return self.backends


class LoweringBackend:
    """One way to lower a fusion block to an executable.

    Subclasses override :meth:`claims` and :meth:`build`.  Register
    instances with :func:`register_backend`; the built-ins (``torch``,
    ``triton``) self-register on package import.
    """

    #: registry name, also the stats key (``stats["backend_blocks"][name]``)
    name: str = "abstract"

    def claims(self, ops: Sequence, plan, ctx: LoweringContext) -> Optional[str]:
        """``None`` when this backend can lower the block, else a stable
        reason slug (feeds per-backend fallback stats).  Must be a pure
        metadata check."""
        raise NotImplementedError

    def build(self, ops: Sequence, plan, ctx: LoweringContext):
        """Build the block: returns ``fn(*input_bufs, salts) ->
        output_bufs``.  A failure here raises to the caller."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Shared analysis memo
# ---------------------------------------------------------------------------

_ANALYSIS_MEMO: "OrderedDict[Tuple, Optional[str]]" = OrderedDict()
_ANALYSIS_MEMO_CAP = 4096


def codegen_lower_reason(ops: Sequence, plan) -> Optional[str]:
    """Memoized ``codegen.block_lower_reason`` keyed on the plan's canonical
    structural signature (the analysis is purely structural, so the
    signature is its exact identity).  The ``triton`` backend's claim
    consults it for every work block the merge cache has not seen; blocks
    that recur across tapes then cost one dict lookup."""
    key = getattr(plan, "signature", None)
    if key is not None and key in _ANALYSIS_MEMO:
        _ANALYSIS_MEMO.move_to_end(key)
        return _ANALYSIS_MEMO[key]
    from ...kernels.fused_block.codegen import block_lower_reason
    reason = block_lower_reason(ops)
    if key is not None:
        _ANALYSIS_MEMO[key] = reason
        if len(_ANALYSIS_MEMO) > _ANALYSIS_MEMO_CAP:
            _ANALYSIS_MEMO.popitem(last=False)
    return reason


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, LoweringBackend] = {}


def register_backend(backend: LoweringBackend, *, replace: bool = False) -> LoweringBackend:
    """Register a backend instance under ``backend.name``.

    ``replace=True`` swaps an existing registration (tests, debug
    interposers); otherwise double registration is an error."""
    if not replace and backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_backend(name: str) -> LoweringBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown lowering backend {name!r}; have {sorted(_REGISTRY)}")


def available_backends() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


# ---------------------------------------------------------------------------
# Selection — the lower stage's per-block rule
# ---------------------------------------------------------------------------

def select_lowering(ops: Sequence, plan, backends: Sequence[str],
                    ctx: LoweringContext) -> LoweringDecision:
    """Pick the backend that runs one block: the first of the
    preference-ordered ``backends`` that claims it.  Returns a
    :class:`LoweringDecision` whose ``declined`` tuple keeps the reasons of
    every backend preferred over the winner."""
    declined = []
    for name in backends:
        reason = get_backend(name).claims(ops, plan, ctx)
        if reason is None:
            return LoweringDecision(backend=name, declined=tuple(declined))
        declined.append((name, reason))
    raise RuntimeError(
        f"no backend claims block {plan.op_indices!r} "
        f"(candidates {tuple(backends)}, reasons {declined})")
