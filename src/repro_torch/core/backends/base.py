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
2. among the claimants, each backend reports how many executable
   *dispatches* the block will cost on it (the ``torch`` floor reports 2
   for blocks the Triton generator cannot express as one kernel — the
   same DEL-insensitive analysis the ``gpu`` cost model prices);
3. the cost model converts dispatch counts into a price
   (``CostModel.dispatch_price``, amortized over a fused loop's unroll
   when a loop body is re-lowered) and the cheapest claimant wins, with
   ties broken by the policy's preference order.

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
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..device import resolve_device


@dataclass(frozen=True)
class LoweringContext:
    """Executor configuration a backend may need to claim or build a block:
    the RNG seed, the device the block's buffers live on (the CUDA card
    unless given) and, for sharded lowerings, the device mesh (``mesh``, a
    1-D ``DeviceMesh``; ``None`` on a single-device executor), its
    ``axis`` and its rank count ``n_dev``, and ``contract_fma``: whether
    B1 builds its contracting form (a runtime under the ``gpu_fma`` cost
    model; ``cost.contracts_fma``).  It carries no buffers: backends
    build functions, the executor owns the store."""

    seed: int = 0
    device: torch.device = field(default_factory=resolve_device)
    mesh: object = None
    axis: Optional[str] = None
    n_dev: int = 1
    contract_fma: bool = False


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
    #: True when executables take ``reuse=`` (the input positions a call
    #: may overwrite); the executor grants reuse only to backends that opt in
    donates: bool = False

    def claims(self, ops: Sequence, plan, ctx: LoweringContext) -> Optional[str]:
        """``None`` when this backend can lower the block, else a stable
        reason slug (feeds per-backend fallback stats).  Must be a pure
        metadata check."""
        raise NotImplementedError

    def dispatches(self, ops: Sequence, plan, ctx: LoweringContext) -> int:
        """How many executable dispatches the block costs on this backend —
        the quantity the cost model prices during selection."""
        return 1

    def build(self, ops: Sequence, plan, ctx: LoweringContext):
        """Build the block: returns ``fn(*input_bufs, salts) ->
        output_bufs``, where ``salts`` is the block's per-``random``-op
        salts or, in a fused loop body, a ``prng.KeyTable`` its draws read
        their key words from.  A failure here raises to the caller."""
        raise NotImplementedError

    def cache_token(self, ops: Sequence, plan, ctx: LoweringContext) -> Tuple:
        """Extra executable-cache key components beyond the structural
        signature (e.g. placement).  Default: none."""
        return ()

    def post_dispatch(self, ops: Sequence, plan, ctx: LoweringContext,
                      stats) -> None:
        """Per-dispatch accounting hook (e.g. the collective and
        fabric-byte counters of the ``shard_map`` backend)."""


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
                    ctx: LoweringContext,
                    cost_model=None, amortize: int = 1) -> LoweringDecision:
    """Pick the backend that runs one block.

    ``backends`` is the preference-ordered candidate list.  Each candidate
    is asked to claim the block; claimants are priced through
    ``cost_model.lowering_price(n_dispatches, ext_bytes, backend=name,
    amortize=amortize)`` (the raw dispatch count when no model is given)
    and the cheapest wins, preference order breaking ties.  For the
    analytic models the price reduces to ``dispatch_price``: external
    bytes move at one assumed bandwidth regardless of backend, so the byte
    term cancels from the comparison, and is only computed for a model
    that overrides ``lowering_price``.  ``amortize`` is the unroll factor
    when the block is re-lowered for a fused cross-flush loop body: launch
    overhead amortizes over the loop, byte traffic does not.  Returns a
    :class:`LoweringDecision` whose ``declined`` tuple keeps the reasons
    of every backend preferred over the winner."""
    order = {n: i for i, n in enumerate(backends)}
    declined = []
    claimants = []
    for name in backends:
        be = get_backend(name)
        reason = be.claims(ops, plan, ctx)
        if reason is None:
            claimants.append(be)
        else:
            declined.append((name, reason))
    if not claimants:
        raise RuntimeError(
            f"no backend claims block {plan.op_indices!r} "
            f"(candidates {tuple(backends)}, reasons {declined})")
    if len(claimants) == 1:
        best = claimants[0]
    else:
        ext_bytes = 0.0
        if cost_model is not None:
            from ..cost import CostModel
            if type(cost_model).lowering_price is not CostModel.lowering_price:
                from ..blocks import BlockInfo
                ext_bytes = float(BlockInfo.from_ops(ops).ext_size("bytes"))

        def price(be: LoweringBackend) -> float:
            n = be.dispatches(ops, plan, ctx)
            return (cost_model.lowering_price(n, ext_bytes, backend=be.name,
                                              amortize=amortize)
                    if cost_model is not None else float(n))
        best = min(claimants, key=lambda be: (price(be), order[be.name]))
    cut = order[best.name]
    return LoweringDecision(
        backend=best.name,
        declined=tuple((n, r) for n, r in declined if order[n] < cut))
