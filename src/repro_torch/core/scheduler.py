"""Staged scheduler pipeline: trace → graph → partition → schedule → lower
→ execute (the port's copy of ``repro.core.scheduler``).

1. **trace**     — ``repro_torch.core.lazy.Runtime`` records array bytecode.
2. **graph**     — ``fusion.build_graph`` builds the WSP instance.
3. **partition** — ``algorithms.partition`` contracts the graph into fusion
   blocks under a cost model.
4. **schedule**  — this module turns the block list into a ``Schedule``: a
   topologically-ordered sequence of ``BlockPlan``s carrying each block's
   external inputs/outputs, contracted temporaries and executable-cache
   signature.
5. **lower**     — each ``BlockPlan`` is annotated with a ``lowering``
   decision: which registered backend (``repro_torch.core.backends``) runs
   the block, chosen by backend expressibility and the cost model's
   per-backend dispatch price — so one flush can mix triton and torch
   blocks and the executed schedule matches what the cost model priced.
6. **execute**   — ``executor.BlockExecutor.run_schedule`` dispatches the
   plans against the buffer store.

Stages 3 and 5 are skipped on a merge-cache hit (§IV-F).  The reference's
loop planning (``plan_loop``) waits for the loop-fusion slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from .algorithms import PartitionResult, partition
from .backends import LoweringDecision, LoweringPolicy, select_lowering
from .cache import MergeCache, block_signature, tape_signature
from .executor import block_io
from .ir import Op
from .obs import trace


@dataclass(frozen=True)
class BlockPlan:
    """Everything the executor needs to dispatch one fusion block."""

    op_indices: Tuple[int, ...]    # tape positions, program order
    inputs: Tuple[int, ...]        # base uids consumed from the store
    outputs: Tuple[int, ...]       # base uids written back to the store
    contracted: Tuple[int, ...]    # new∩del temporaries (never materialized)
    signature: Tuple               # executable-cache key (structural)
    has_work: bool                 # False for DEL/SYNC-only blocks
    #: stage-5 decision (None until lowered / for DEL/SYNC-only blocks)
    lowering: Optional[LoweringDecision] = None


@dataclass
class Schedule:
    """A fully-planned flush: the tape plus its ordered block plans."""

    tape: List[Op]
    blocks: List[BlockPlan]
    result: Optional[PartitionResult] = None   # None on a merge-cache hit
    stats: Dict[str, float] = field(default_factory=dict)
    key: Optional[Tuple] = None                # merge-cache key (use_cache)


def plan_blocks(tape: Sequence[Op],
                op_blocks: Sequence[Sequence[int]]) -> List[BlockPlan]:
    """Stage 4: lower a partition's block lists into ``BlockPlan``s."""
    plans: List[BlockPlan] = []
    for block in op_blocks:
        ops = [tape[i] for i in block]
        ins, outs, contracted = block_io(ops)
        plans.append(BlockPlan(
            op_indices=tuple(block),
            inputs=tuple(ins),
            outputs=tuple(outs),
            contracted=tuple(contracted),
            signature=block_signature(ops),
            has_work=any(not op.is_system() for op in ops),
        ))
    return plans


def lower_plans(tape: Sequence[Op], plans: Sequence[BlockPlan],
                policy: LoweringPolicy
                ) -> Tuple[Optional[LoweringDecision], ...]:
    """Stage 5: decide, per work block, which backend runs it — the first
    of the policy's candidate backends that claims the block (see
    ``backends.select_lowering``).  Returns one decision per plan (``None``
    for DEL/SYNC-only blocks), aligned with ``plans``."""
    return tuple(
        select_lowering([tape[i] for i in p.op_indices], p,
                        policy.backends, policy.ctx)
        if p.has_work else None
        for p in plans)


class Scheduler:
    """Owns stages 2–5 and the merge cache; policy arrives per call so the
    Runtime can retarget algorithm/cost model/backends between flushes."""

    def __init__(self, cache: Optional[MergeCache] = None):
        self.cache = cache if cache is not None else MergeCache()

    def plan(self, tape: Sequence[Op], *, algorithm: str = "greedy",
             cost_model: str = "bohrium", node_budget: int = 100_000,
             use_cache: bool = True,
             lowering: Optional[LoweringPolicy] = None,
             partition_backend: str = "greedy") -> Schedule:
        """Stages 2–5: turn a recorded tape into an executable ``Schedule``.

        Builds the WSP graph, partitions it under ``cost_model`` with
        ``algorithm``, lowers the block lists into ordered
        :class:`BlockPlan`s, and — when the executor's ``lowering`` policy
        is given — annotates each work block with its backend decision.
        The policy's backend names are part of the merge-cache key, so
        decisions made for one backend stack never leak into another.  On
        a merge-cache hit both the partition AND the lowering decisions are
        replayed (``Schedule.result`` is ``None`` on a hit).
        ``Schedule.stats`` carries per-stage timings."""
        stats: Dict[str, float] = {}
        blocks: Optional[Tuple[Tuple[int, ...], ...]] = None
        decisions: Optional[Tuple] = None
        key: Optional[Tuple] = None
        cached = False
        if use_cache:
            key = tape_signature(tape, algorithm, cost_model,
                                 backends=lowering.key() if lowering else (),
                                 partition_backend=partition_backend)
            entry = self.cache.get(key)
            trace.instant("cache.merge", hit=entry is not None)
            if entry is not None:
                blocks, decisions = entry
                cached = True
        result = None
        if blocks is None:
            result = partition(tape, algorithm=algorithm,
                               cost_model=cost_model,
                               node_budget=node_budget,
                               partition_backend=partition_backend)
            blocks = tuple(tuple(b) for b in result.op_blocks())
            stats.update(result.stats)
        t0 = time.perf_counter()
        with trace.span("stage.schedule", n_blocks=len(blocks),
                        cached=cached):
            plans = plan_blocks(tape, blocks)
        stats["t_schedule_s"] = time.perf_counter() - t0
        if lowering is not None:
            t0 = time.perf_counter()
            with trace.span("stage.lower", cached=decisions is not None):
                if decisions is None:
                    decisions = lower_plans(tape, plans, lowering)
                plans = [replace(p, lowering=d) if d is not None else p
                         for p, d in zip(plans, decisions)]
            stats["t_lower_s"] = time.perf_counter() - t0
        if use_cache and not cached:
            self.cache.put(key, (blocks, decisions))
        return Schedule(tape=list(tape), blocks=plans, result=result,
                        stats=stats, key=key)
