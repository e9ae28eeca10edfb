"""Staged scheduler pipeline: trace → graph → partition → schedule → lower
→ execute (the port's copy of ``repro.core.scheduler``).

1. **trace**     — ``repro_torch.core.lazy.Runtime`` records array bytecode.
2. **graph**     — ``fusion.build_graph`` builds the WSP instance.
3. **partition** — ``algorithms.partition`` contracts the graph into fusion
   blocks under a cost model.
4. **schedule**  — this module turns the block list into a ``Schedule``: a
   topologically-ordered sequence of ``BlockPlan``s carrying each block's
   external inputs/outputs, contracted temporaries, executable-cache
   signature and *donatable* input positions (buffers whose base dies
   inside the block, which the block may overwrite).
5. **lower**     — each ``BlockPlan`` is annotated with a ``lowering``
   decision: which registered backend (``repro_torch.core.backends``) runs
   the block, chosen by backend expressibility and the cost model's
   per-backend dispatch price — so one flush can mix triton and torch
   blocks and the executed schedule matches what the cost model priced.
6. **execute**   — ``executor.BlockExecutor.run_schedule`` dispatches the
   plans against the buffer store.

Stages 3 and 5 are skipped on a merge-cache hit (§IV-F).  For a tape that
recurs across flushes, :meth:`Scheduler.plan_loop` plans the steady-state
loop body once (cross-flush loop fusion, ``core/loop.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from .algorithms import PartitionResult, partition
from .backends import LoweringDecision, LoweringPolicy, select_lowering
from .cache import MergeCache, block_signature, tape_signature
from .cost import make_cost_model, model_cache_token
from .executor import block_dead_bases, block_io
from .ir import Op
from .obs import trace


@dataclass(frozen=True)
class BlockPlan:
    """Everything the executor needs to dispatch one fusion block."""

    op_indices: Tuple[int, ...]    # tape positions, program order
    inputs: Tuple[int, ...]        # base uids consumed from the store
    outputs: Tuple[int, ...]       # base uids written back to the store
    contracted: Tuple[int, ...]    # new∩del temporaries (never materialized)
    donatable: Tuple[int, ...]     # positions in `inputs` whose buffer dies
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


@dataclass(frozen=True)
class LoopPlan:
    """The loop planning product for cross-flush fusion (DESIGN.md §16):
    everything the executor's ``run_loop`` needs to run ONE steady-state
    iteration as a loop body (``backends.loop_body``).

    The plan is purely *structural* — a template tape (any representative of
    the recurring structure) plus per-block plans, the tape-level io in
    canonical first-occurrence order, and the carried-state mapping saying
    where each input position reads from (``("carry", q)`` = loop state slot
    ``q``, ``("inv", j)`` = loop-invariant input ``j``).  It is cached in
    the merge cache beside the block plan (under a ``("loop",)`` prefix) and
    replayed for every structurally-equal tape, whatever its base uids."""

    tape: Tuple[Op, ...]            # template tape, program order
    plans: Tuple[BlockPlan, ...]    # per-block plans (loop-lowered)
    tape_inputs: Tuple[int, ...]    # template tape-level input uids
    tape_outputs: Tuple[int, ...]   # template tape-level output uids
    input_sources: Tuple[Tuple, ...]  # carried-state mapping per input pos
    key: Tuple                      # loop-executable cache identity


def plan_blocks(tape: Sequence[Op],
                op_blocks: Sequence[Sequence[int]]) -> List[BlockPlan]:
    """Stage 4: lower a partition's block lists into ``BlockPlan``s.

    A block input is donatable when its base is deleted (and not SYNC'd)
    inside the same block: no later block may observe it — the partition's
    dependency edges order every access before the DEL — so the block may
    overwrite its buffer."""
    plans: List[BlockPlan] = []
    for block in op_blocks:
        ops = [tape[i] for i in block]
        ins, outs, contracted = block_io(ops)
        dead = block_dead_bases(ops)
        plans.append(BlockPlan(
            op_indices=tuple(block),
            inputs=tuple(ins),
            outputs=tuple(outs),
            contracted=tuple(contracted),
            donatable=tuple(k for k, u in enumerate(ins) if u in dead),
            signature=block_signature(ops),
            has_work=any(not op.is_system() for op in ops),
        ))
    return plans


def merge_key(tape: Sequence[Op], algorithm: str, cost_model: str,
              lowering: Optional[LoweringPolicy],
              partition_backend: str = "greedy",
              topology: Tuple = ()) -> Tuple:
    """The merge-cache key of a flush, as :meth:`Scheduler.plan` builds it
    (the explain report probes the cache with the same key)."""
    return tape_signature(tape, algorithm, cost_model, topology=topology,
                          backends=lowering.key() if lowering else (),
                          cost_token=model_cache_token(cost_model),
                          partition_backend=partition_backend)


def lower_plans(tape: Sequence[Op], plans: Sequence[BlockPlan],
                policy: LoweringPolicy, cost_model=None,
                amortize: int = 1) -> Tuple[Optional[LoweringDecision], ...]:
    """Stage 5: decide, per work block, which backend runs it.

    For each plan the policy's candidate backends are asked to claim the
    block; claimants are priced via ``cost_model.dispatch_price`` over
    their dispatch counts and the cheapest wins (preference order breaking
    ties) — see ``backends.select_lowering``.  ``amortize`` > 1 re-lowers
    for a fused loop body, where launch overhead amortizes over the unroll.
    Returns one decision per plan (``None`` for DEL/SYNC-only blocks),
    aligned with ``plans``."""
    return tuple(
        select_lowering([tape[i] for i in p.op_indices], p,
                        policy.backends, policy.ctx, cost_model,
                        amortize=amortize)
        if p.has_work else None
        for p in plans)


class Scheduler:
    """Owns stages 2–5 and the merge cache; policy arrives per call so the
    Runtime can retarget algorithm/cost model/backends between flushes."""

    def __init__(self, cache: Optional[MergeCache] = None):
        self.cache = cache if cache is not None else MergeCache()
        #: optional persistent plan cache (``repro_torch.core.serve.
        #: PlanStore``, DESIGN.md §18) — probed after an in-memory
        #: merge-cache miss and written through on fresh plans, so a warm
        #: process start replays block structure + lowering decisions
        self.plan_store = None

    def plan(self, tape: Sequence[Op], *, algorithm: str = "greedy",
             cost_model: str = "bohrium", node_budget: int = 100_000,
             use_cache: bool = True, topology: Tuple = (),
             lowering: Optional[LoweringPolicy] = None,
             partition_backend: str = "greedy",
             time_budget_s: Optional[float] = None) -> Schedule:
        """Stages 2–5: turn a recorded tape into an executable ``Schedule``.

        Builds the WSP graph, partitions it under ``cost_model`` with
        ``algorithm``, lowers the block lists into ordered
        :class:`BlockPlan`s, and — when the executor's ``lowering`` policy
        is given — annotates each work block with its backend decision.
        The policy's backend names are part of the merge-cache key, so
        decisions made for one backend stack never leak into another.  On
        a merge-cache hit both the partition AND the lowering decisions are
        replayed (``Schedule.result`` is ``None`` on a hit).
        ``Schedule.stats`` carries per-stage timings.  ``topology`` is
        the executor's device/mesh key (``BlockExecutor.topology_key``),
        so cached partitions are never reused across placements.

        ``partition_backend='ilp'`` solves the partition as an anytime
        integer program warm-started from greedy (``algorithms.partition``;
        ``time_budget_s`` caps the solver wall clock).  The backend is part
        of the merge-cache key: a cache (or plan store) populated by greedy
        is a clean miss for ilp and vice versa.  With a ``plan_store``, a
        merge-cache miss probes the store, a hit there is promoted into the
        cache, and a fresh plan is written through to it."""
        stats: Dict[str, float] = {}
        blocks: Optional[Tuple[Tuple[int, ...], ...]] = None
        decisions: Optional[Tuple] = None
        key: Optional[Tuple] = None
        cached = False
        if use_cache:
            key = merge_key(tape, algorithm, cost_model, lowering,
                            partition_backend, topology)
            entry = self.cache.get(key)
            trace.instant("cache.merge", hit=entry is not None)
            if entry is None and self.plan_store is not None:
                entry = self.plan_store.load(key)
                if entry is not None:
                    # promote the disk hit so later flushes stay in memory
                    self.cache.put(key, entry)
            if entry is not None:
                blocks, decisions = entry
                cached = True
        result = None
        if blocks is None:
            result = partition(tape, algorithm=algorithm,
                               cost_model=cost_model,
                               node_budget=node_budget,
                               partition_backend=partition_backend,
                               time_budget_s=time_budget_s)
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
                    decisions = lower_plans(tape, plans, lowering,
                                            make_cost_model(cost_model))
                plans = [replace(p, lowering=d) if d is not None else p
                         for p, d in zip(plans, decisions)]
            stats["t_lower_s"] = time.perf_counter() - t0
        if use_cache and not cached:
            self.cache.put(key, (blocks, decisions))
            if self.plan_store is not None:
                self.plan_store.store(key, blocks, decisions)
        return Schedule(tape=list(tape), blocks=plans, result=result,
                        stats=stats, key=key)

    def plan_loop(self, schedule: Schedule, *, key: Tuple, io: Tuple,
                  mapping: Tuple, cost_model: str = "bohrium",
                  lowering: Optional[LoweringPolicy] = None,
                  unroll: int = 1) -> LoopPlan:
        """Plan the steady-state loop body for a recurring tape
        (DESIGN.md §16).

        ``schedule`` is the already-planned flush serving as the structural
        template, ``key`` its merge-cache key, ``io`` its tape-level
        ``cache.tape_io`` and ``mapping`` the ``cache.carried_state_mapping``
        proven stable by the recurrence detector.  Work blocks are
        *re-lowered* with the dispatch term amortized over ``unroll`` —
        inside a fused loop launch overhead is paid once per drain, so a
        backend that only lost on launch cost may win back the block.  The
        product is cached beside the block plan under ``("loop",) + key``:
        a steady-state program plans its loop exactly once."""
        loop_key = ("loop", key, tuple(mapping), unroll)
        entry = self.cache.get(loop_key)
        if entry is not None:
            return entry
        tape = schedule.tape
        plans: Sequence[BlockPlan] = schedule.blocks
        if lowering is not None:
            decisions = lower_plans(tape, plans, lowering,
                                    make_cost_model(cost_model),
                                    amortize=unroll)
            plans = [replace(p, lowering=d) if d is not None else p
                     for p, d in zip(plans, decisions)]
        lp = LoopPlan(tape=tuple(tape), plans=tuple(plans),
                      tape_inputs=tuple(io[0]), tape_outputs=tuple(io[1]),
                      input_sources=tuple(mapping),
                      key=(key, tuple(mapping), unroll))
        self.cache.put(loop_key, lp)
        return lp
