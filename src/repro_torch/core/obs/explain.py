"""Fusion-decision explain reports: *why* a flush fused,
lowered and cached the way it did, with every decision priced.

``explain(rt)`` replays the planning stages of the runtime's last executed
tape (``Runtime.last_tape``) with decision logging on — partitioning is
purely structural, so the replay needs no buffers and perturbs nothing (the
merge cache is only probed via ``in``, which touches neither the LRU order
nor the hit/miss counters).  The report covers:

* per-block composition — ops, external bytes (the Def. 13 cost), how many
  executable dispatches the winning backend reported;
* the partitioner's merge log — every candidate merge the WSP algorithm
  considered, its priced saving (``CostModel.merge_saving``), and whether
  it was taken or rejected (fuse-forbidden / dependency-cycle), for the
  ``greedy``/``greedy_reference``/``linear`` algorithms;
* every ``LoweringDecision`` — per candidate backend: claimed or the
  decline reason slug, dispatch count and the cost model's price (the
  quantities ``backends.select_lowering`` minimized);
* cache provenance — the merge-cache key digest, whether the structure is
  resident, and the cache's cumulative hit/miss/eviction counters;
* the loop-fuser state machine — the event log the ``LoopFuser`` keeps
  (observe/arm/defer/drain/break transitions).

Reports render as human-readable text (:meth:`ExplainReport.format_text`)
and machine-readable JSON (:meth:`ExplainReport.to_json`); the
``tools/explain_torch.py`` CLI fronts both.

The port's copy of ``repro.core.obs.explain``, with the same schema.  It
probes the merge cache with the key the port's scheduler builds
(``scheduler.merge_key``, with the executor's topology).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["MergeEvent", "BackendVerdict", "BlockReport", "ExplainReport",
           "explain"]


@dataclass(frozen=True)
class MergeEvent:
    """One candidate merge the partitioner considered."""

    action: str                    # "merged" | "rejected"
    saving: float                  # priced saving (the weight-edge value)
    u_ops: Tuple[int, ...]         # tape indices of one side at merge time
    v_ops: Tuple[int, ...]         # tape indices of the other side
    reason: Optional[str] = None   # rejection reason slug, None when merged


@dataclass(frozen=True)
class BackendVerdict:
    """One candidate backend's answer for one block."""

    backend: str
    claimed: bool
    reason: Optional[str]          # decline reason slug (claimed=False)
    dispatches: Optional[int]      # executable dispatches (claimed only)
    price: Optional[float]         # cost-model price (claimed only)
    winner: bool


@dataclass(frozen=True)
class BlockReport:
    """Composition + lowering story of one fusion block."""

    index: int
    op_indices: Tuple[int, ...]
    opcodes: Tuple[str, ...]       # work opcodes, program order
    n_ops: int                     # work ops
    ext_bytes: float               # Def. 13 external bytes
    n_inputs: int
    n_outputs: int
    n_contracted: int
    backend: Optional[str]         # winning backend (None: no work)
    verdicts: Tuple[BackendVerdict, ...] = ()


@dataclass
class ExplainReport:
    """The full decision story of one flush."""

    algorithm: str
    cost_model: str
    backends: Tuple[str, ...]
    n_ops: int
    n_blocks: int
    cost: float
    merges: List[MergeEvent] = field(default_factory=list)
    blocks: List[BlockReport] = field(default_factory=list)
    cache: Dict[str, Any] = field(default_factory=dict)
    loop: List[Dict[str, Any]] = field(default_factory=list)
    partition_backend: str = "greedy"
    #: ilp backend only — status (optimal/anytime/budget-hit), objective,
    #: lower bound, optimality gap, warm-start greedy cost, nodes, wall
    solver: Dict[str, Any] = field(default_factory=dict)

    # -- machine-readable ----------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": "repro_explain_v1",
            "algorithm": self.algorithm,
            "cost_model": self.cost_model,
            "partition_backend": self.partition_backend,
            "backends": list(self.backends),
            "n_ops": self.n_ops,
            "n_blocks": self.n_blocks,
            "cost": self.cost,
            "solver": self.solver,
            "merges": [asdict(m) for m in self.merges],
            "blocks": [asdict(b) for b in self.blocks],
            "cache": self.cache,
            "loop": self.loop,
        }

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)

    # -- derived views --------------------------------------------------
    def rejected_merges(self) -> List[MergeEvent]:
        return [m for m in self.merges if m.action == "rejected"]

    def taken_merges(self) -> List[MergeEvent]:
        return [m for m in self.merges if m.action == "merged"]

    # -- human-readable ------------------------------------------------
    def format_text(self) -> str:
        L: List[str] = []
        L.append(f"explain: {self.n_ops} ops -> {self.n_blocks} blocks  "
                 f"(algorithm={self.algorithm}, cost_model={self.cost_model},"
                 f" cost={self.cost:.0f})")
        L.append(f"backends: {', '.join(self.backends)}")
        if self.partition_backend != "greedy" or self.solver:
            L.append(f"partition backend: {self.partition_backend}")
        if self.solver:
            s = self.solver
            L.append(f"  solver: {s.get('status', '?')}  "
                     f"objective={s.get('objective', float('nan')):.6g}  "
                     f"bound={s.get('bound', float('nan')):.6g}  "
                     f"gap={s.get('gap', float('nan')):.2%}  "
                     f"(greedy={s.get('greedy_cost', float('nan')):.6g}, "
                     f"{s.get('nodes', 0)} nodes, "
                     f"{s.get('wall_s', 0.0):.3f}s)")

        taken, rejected = self.taken_merges(), self.rejected_merges()
        L.append("")
        L.append(f"merges: {len(taken)} taken, {len(rejected)} rejected")
        for m in taken:
            L.append(f"  + merged  ops{_rng(m.u_ops)} + ops{_rng(m.v_ops)}"
                     f"  saving={m.saving:.0f}")
        for m in rejected:
            L.append(f"  - rejected ops{_rng(m.u_ops)} + ops{_rng(m.v_ops)}"
                     f"  saving={m.saving:.0f}  ({m.reason})")

        L.append("")
        L.append("blocks:")
        for b in self.blocks:
            if b.backend is None:
                L.append(f"  [{b.index}] ops{_rng(b.op_indices)} "
                         "(system only: DEL/SYNC)")
                continue
            ops = ",".join(b.opcodes[:6]) + ("…" if len(b.opcodes) > 6
                                             else "")
            L.append(f"  [{b.index}] ops{_rng(b.op_indices)} -> {b.backend}"
                     f"  ({b.n_ops} work ops [{ops}], "
                     f"{b.ext_bytes:.0f} ext bytes, "
                     f"{b.n_inputs} in / {b.n_outputs} out / "
                     f"{b.n_contracted} contracted)")
            for v in b.verdicts:
                if v.claimed:
                    mark = "*" if v.winner else " "
                    L.append(f"      {mark} {v.backend:10s} claimed  "
                             f"dispatches={v.dispatches}  "
                             f"price={v.price:.3g}")
                else:
                    L.append(f"        {v.backend:10s} declined "
                             f"({v.reason})")

        L.append("")
        c = self.cache
        L.append(f"merge cache: key={c.get('key_digest', '?')} "
                 f"resident={c.get('resident')}  "
                 f"(session: {c.get('hits', 0)} hits / "
                 f"{c.get('misses', 0)} misses / "
                 f"{c.get('evictions', 0)} evictions, "
                 f"{c.get('entries', 0)} entries)")

        if self.loop:
            L.append("")
            L.append("loop fuser:")
            for ev in self.loop:
                kv = "  ".join(f"{k}={v}" for k, v in ev.items()
                               if k != "event")
                L.append(f"  {ev.get('event', '?'):8s} {kv}")
        return "\n".join(L)


def _rng(idx: Sequence[int]) -> str:
    """Compact tape-index set rendering: [0-3] or [0,2,5]."""
    s = sorted(idx)
    if not s:
        return "[]"
    if len(s) == s[-1] - s[0] + 1:
        return f"[{s[0]}]" if len(s) == 1 else f"[{s[0]}-{s[-1]}]"
    return "[" + ",".join(map(str, s)) + "]"


# ---------------------------------------------------------------------------

def explain(rt, tape: Optional[Sequence] = None) -> ExplainReport:
    """Build the decision report for ``tape`` (default: the runtime's last
    executed tape).  Pure analysis: re-partitions with logging on, re-probes
    every policy backend per block, and reads cache/loop state without
    mutating any of it."""
    from ..algorithms import partition
    from ..backends import get_backend
    from ..blocks import BlockInfo
    from ..cost import make_cost_model
    from ..scheduler import merge_key, plan_blocks
    from ..tuning.profile import signature_digest

    if tape is None:
        tape = getattr(rt, "last_tape", None)
    if tape is None:
        raise ValueError("nothing to explain: the runtime has not executed "
                         "a flush yet (Runtime.last_tape is unset)")
    tape = list(tape)

    raw_log: List[Dict[str, Any]] = []
    pbackend = getattr(rt, "partition_backend", "greedy")
    result = partition(tape, algorithm=rt.algorithm,
                       cost_model=rt.cost_model,
                       node_budget=rt.node_budget, merge_log=raw_log,
                       partition_backend=pbackend,
                       time_budget_s=getattr(rt, "time_budget_s", None))
    merge_log = [MergeEvent(**d) for d in raw_log]
    solver: Dict[str, Any] = {}
    if pbackend == "ilp":
        st = result.stats
        solver = {"status": st.get("ilp_status"),
                  "objective": st.get("ilp_objective"),
                  "bound": st.get("ilp_bound"),
                  "gap": st.get("ilp_gap"),
                  "greedy_cost": st.get("greedy_cost"),
                  "nodes": st.get("ilp_nodes"),
                  "edges": st.get("ilp_edges"),
                  "wall_s": st.get("ilp_wall_s")}
    blocks = result.op_blocks()
    plans = plan_blocks(tape, blocks)

    policy = rt.lowering_policy()
    cost_model = make_cost_model(rt.cost_model)
    block_reports: List[BlockReport] = []
    for i, plan in enumerate(plans):
        ops = [tape[j] for j in plan.op_indices]
        work = [op for op in ops if not op.is_system()]
        if not plan.has_work:
            block_reports.append(BlockReport(
                index=i, op_indices=plan.op_indices,
                opcodes=(), n_ops=0, ext_bytes=0.0,
                n_inputs=len(plan.inputs), n_outputs=len(plan.outputs),
                n_contracted=len(plan.contracted), backend=None))
            continue
        info = BlockInfo.from_ops(ops)
        ext_bytes = float(info.ext_size("bytes"))
        verdicts: List[BackendVerdict] = []
        best: Optional[Tuple[float, int, str]] = None
        for pref, name in enumerate(policy.backends):
            be = get_backend(name)
            reason = be.claims(ops, plan, policy.ctx)
            if reason is not None:
                verdicts.append(BackendVerdict(
                    backend=name, claimed=False, reason=reason,
                    dispatches=None, price=None, winner=False))
                continue
            n = int(be.dispatches(ops, plan, policy.ctx))
            price = float(cost_model.lowering_price(n, ext_bytes,
                                                    backend=name))
            verdicts.append(BackendVerdict(
                backend=name, claimed=True, reason=None,
                dispatches=n, price=price, winner=False))
            if best is None or (price, pref) < best[:2]:
                best = (price, pref, name)
        if best is not None:
            verdicts = [BackendVerdict(**{**asdict(v),
                                          "winner": v.backend == best[2]})
                        for v in verdicts]
        block_reports.append(BlockReport(
            index=i, op_indices=plan.op_indices,
            opcodes=tuple(op.opcode for op in work),
            n_ops=len(work), ext_bytes=ext_bytes,
            n_inputs=len(plan.inputs), n_outputs=len(plan.outputs),
            n_contracted=len(plan.contracted),
            backend=best[2] if best else None,
            verdicts=tuple(verdicts)))

    key = merge_key(tape, rt.algorithm, rt.cost_model, policy, pbackend,
                    rt.executor.topology_key())
    cache = {"key_digest": signature_digest(key),
             "resident": key in rt.cache,
             "hits": rt.cache.hits, "misses": rt.cache.misses,
             "evictions": rt.cache.evictions, "entries": len(rt.cache)}

    fus = getattr(rt, "_loop", None)
    loop_events = [dict(ev) for ev in fus.events] if fus is not None else []

    return ExplainReport(
        algorithm=rt.algorithm, cost_model=rt.cost_model,
        backends=tuple(policy.backends),
        n_ops=len(tape), n_blocks=result.n_blocks, cost=result.cost,
        merges=merge_log, blocks=block_reports, cache=cache,
        loop=loop_events, partition_backend=pbackend, solver=solver)
