"""WSP partition algorithms (paper §IV).

* ``singleton``   — ⊥ partition, no fusion (the paper's "Singleton" baseline)
* ``linear``      — §IV-E sequential sweep, O(n²), no graph representation
* ``greedy``      — Fig. 6 heaviest-weight-edge contraction, implemented as
  a lazy max-heap with stale-entry invalidation: each contraction costs
  O(degree·log E) instead of the reference's O(E) full rescan.  The merge
  sequence is bit-identical to ``greedy_reference`` (regression-tested).
* ``unintrusive`` — Fig. 5 provably-optimal preconditioning merges (Thm. 3)
* ``optimal``     — Fig. 10 branch-and-bound over weight-edge cut masks with
  the monotonicity bound; an explicit node budget replaces the paper's
  "search tree too large" cutoff and falls back to the greedy incumbent.

All algorithms are cost-model agnostic (any monotone ``CostModel``).
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .blocks import BlockInfo
from .cost import make_cost_model
from .fusion import WSPGraph, build_graph, build_graph_reference
from .ir import Op
from .obs import trace
from .partition import PartitionState, _ekey


@dataclass
class PartitionResult:
    state: PartitionState
    algorithm: str
    cost: float
    n_blocks: int
    stats: Dict[str, float] = field(default_factory=dict)

    def op_blocks(self) -> List[List[int]]:
        return self.state.op_blocks()


# ---------------------------------------------------------------------------

def _log_merge(merge_log: Optional[List[Dict]], state: PartitionState,
               action: str, u: int, v: int, saving: float,
               reason: Optional[str] = None) -> None:
    """Append one merge-decision record (obs/explain schema).  Must run
    BEFORE ``state.merge`` — the sides are the blocks' tape-index sets at
    decision time and ``merge`` folds v's into u's."""
    if merge_log is None:
        return
    merge_log.append({"action": action, "saving": float(saving),
                      "u_ops": tuple(sorted(state.members[u])),
                      "v_ops": tuple(sorted(state.members[v])),
                      "reason": reason})


def _reject_reason(state: PartitionState, u: int, v: int) -> str:
    """Why ``legal_merge(u, v)`` said no (Def. 5's two conditions)."""
    return ("fuse-forbidden" if v in state.fuse[u] else "dependency-cycle")


def singleton(state: PartitionState) -> PartitionState:
    return state


def linear(state: PartitionState,
           merge_log: Optional[List[Dict]] = None) -> PartitionState:
    """§IV-E: sweep the tape, extending the current block while legal."""
    n = state.graph.n()
    if n == 0:
        return state
    cur = state.block_of[0]
    for i in range(1, n):
        b = state.block_of[i]
        if state.legal_merge(cur, b):
            _log_merge(merge_log, state, "merged", cur, b,
                       state.weights.get(_ekey(cur, b), 0.0))
            cur = state.merge(cur, b)
        else:
            _log_merge(merge_log, state, "rejected", cur, b,
                       state.weights.get(_ekey(cur, b), 0.0),
                       reason=_reject_reason(state, cur, b))
            cur = b
    return state


def greedy(state: PartitionState,
           merge_log: Optional[List[Dict]] = None) -> PartitionState:
    """Fig. 6 via a lazy max-heap: pop the heaviest entry, skip it when
    stale (edge dropped, endpoint contracted away, or weight recomputed
    since the push), otherwise merge/drop exactly like the reference.
    After a merge only the recomputed incident edges are (re)pushed."""
    heap = [(-w, u, v) for (u, v), w in state.weights.items()]
    heapq.heapify(heap)
    while heap:
        nw, u, v = heapq.heappop(heap)
        if state.weights.get((u, v)) != -nw:
            continue                               # stale entry
        if state.legal_merge(u, v):
            _log_merge(merge_log, state, "merged", u, v, -nw)
            state.merge(u, v)
            for x in state._adj[u]:
                a, b = _ekey(u, x)
                heapq.heappush(heap, (-state.weights[(a, b)], a, b))
        else:
            _log_merge(merge_log, state, "rejected", u, v, -nw,
                       reason=_reject_reason(state, u, v))
            state.drop_weight(u, v)
    return state


def greedy_reference(state: PartitionState,
                     merge_log: Optional[List[Dict]] = None) -> PartitionState:
    """Fig. 6, reference implementation: full O(E) rescan per contraction.
    Kept as the oracle for the heap variant's merge-sequence regression."""
    while state.weights:
        (u, v), w = max(state.weights.items(), key=lambda kv: (kv[1], -kv[0][0], -kv[0][1]))
        if state.legal_merge(u, v):
            _log_merge(merge_log, state, "merged", u, v, w)
            state.merge(u, v)
        else:
            _log_merge(merge_log, state, "rejected", u, v, w,
                       reason=_reject_reason(state, u, v))
            state.drop_weight(u, v)
    return state


def _reach_sets(state: PartitionState) -> Dict[int, set]:
    """Transitive closure of the block dependency DAG (descendants)."""
    order = state.topo_blocks()
    reach: Dict[int, set] = {}
    for b in reversed(order):
        r: set = set()
        for n in state.dep_out[b]:
            r.add(n)
            r |= reach[n]
        reach[b] = r
    return reach


def _find_candidate(state: PartitionState) -> Optional[Tuple[int, int]]:
    """Sound variant of Fig. 5 FINDCANDIDATE.

    NOTE (deviation, documented in DESIGN.md §8): the paper's listing —
    weight-pendant after removing currently-illegal edges, plus θ equality —
    is NOT optimality-preserving: property testing found tapes where it
    merges a vertex pair that forecloses the optimum (the non-pendant
    endpoint loses better partners).  We therefore only merge (p, q) when q
    is provably *captive* to p:

      1. saving(p, q) > 0 and the merge is legal,
      2. q's unique transitive-reduction dependency neighbour is p
         (the paper's "merge a pendant vertex with its parent"),
      3. fuse[q] ⊆ fuse[p]  (the merged vertex adds no new fusibility
         constraint on p — Thm. 3's θ-condition, made one-sided),
      4. every other block x with saving(q, x) > 0 has p dependency-between
         q and x, so by Def. 5(2) ANY legal block containing q and x
         already contains p — q merging with p forecloses nothing.
    """
    for key in sorted(state.weights):
        if not state.legal_merge(*key):
            state.drop_weight(*key)
    if not state.weights:
        return None
    reach = _reach_sets(state)

    def between(p: int, a: int, b: int) -> bool:
        return ((p in reach.get(a, ()) and b in reach.get(p, ()))
                or (p in reach.get(b, ()) and a in reach.get(p, ())))

    # transitive-reduction neighbour sets
    tr_nbrs: Dict[int, set] = {b: set() for b in state.blocks}
    for b in state.blocks:
        for n in state.dep_out[b]:
            if not any(n in reach[m] for m in state.dep_out[b] if m != n):
                tr_nbrs[b].add(n)
                tr_nbrs[n].add(b)

    for (u, v) in sorted(state.weights):
        if state.weights[(u, v)] <= 0:
            continue
        for p, q in ((u, v), (v, u)):
            if tr_nbrs[q] != {p}:
                continue                          # q not pendant on p
            if not (state.fuse[q] <= state.fuse[p]):
                continue
            bq = state.blocks[q]
            captive = True
            for x, bx in state.blocks.items():
                if x in (p, q):
                    continue
                if state.cost_model.merge_saving(bq, bx) > 0 \
                        and not between(p, q, x):
                    captive = False
                    break
            if captive:
                return (p, q)
    return None


def unintrusive(state: PartitionState) -> PartitionState:
    """Fig. 5: merge only unintrusively-fusible pairs (subset of optimal)."""
    while True:
        cand = _find_candidate(state)
        if cand is None:
            return state
        state.merge(*cand)


# -- branch and bound --------------------------------------------------------

class _MaskReplay:
    """MERGEBYMASK (Fig. 10): replay a subset of the fixed weight-edge list
    with a union-find, returning (cost, legal).  No weight maintenance — this
    is the cheap inner loop of the search."""

    def __init__(self, state: PartitionState, edges: List[Tuple[int, int]]):
        self.state = state
        self.edges = edges
        self.block_ids = sorted(state.blocks)

    def run(self, mask: int) -> Tuple[float, bool]:
        st = self.state
        parent = {b: b for b in self.block_ids}

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        infos: Dict[int, BlockInfo] = dict(st.blocks)
        fuse_ok = True
        for i, (u, v) in enumerate(self.edges):
            if not (mask >> i) & 1:
                continue
            ru, rv = find(u), find(v)
            if ru == rv:
                continue
            # Def. 5(1): fuse edge anywhere between the two merged groups?
            if fuse_ok:
                gu = [b for b in self.block_ids if find(b) == ru]
                gv = [b for b in self.block_ids if find(b) == rv]
                if any(y in st.fuse[x] for x in gu for y in gv):
                    fuse_ok = False
            parent[rv] = ru
            infos[ru] = infos[ru].merged_with(infos[rv])
            del infos[rv]
        # Def. 5(2): contracted dependency graph must stay acyclic
        roots = {find(b) for b in self.block_ids}
        adj: Dict[int, set] = {r: set() for r in roots}
        for b in self.block_ids:
            rb = find(b)
            for n in st.dep_out[b]:
                rn = find(n)
                if rn != rb:
                    adj[rb].add(rn)
        indeg = {r: 0 for r in roots}
        for r, ns in adj.items():
            for n in ns:
                indeg[n] += 1
        stack = [r for r, d in indeg.items() if d == 0]
        seen = 0
        while stack:
            x = stack.pop()
            seen += 1
            for n in adj[x]:
                indeg[n] -= 1
                if indeg[n] == 0:
                    stack.append(n)
        acyclic = seen == len(roots)
        cost = st.cost_model.partition_cost(list(infos.values()))
        return cost, (fuse_ok and acyclic)


def optimal(state: PartitionState, node_budget: int = 100_000,
            stats: Optional[Dict] = None) -> PartitionState:
    """Fig. 10 OPTIMAL: unintrusive precondition, greedy incumbent, then a
    depth-first branch-and-bound over weight-edge subsets."""
    state = unintrusive(state)
    for key in sorted(state.weights):
        if not state.legal_merge(*key):
            state.drop_weight(*key)
    incumbent = greedy(state.copy())
    best_cost = incumbent.cost()
    best_mask: Optional[int] = None
    edges = sorted(state.weights)
    E = len(edges)
    nodes = 0
    exhausted = False
    if E > 0:
        replay = _MaskReplay(state, edges)
        full = (1 << E) - 1
        stack: List[Tuple[int, int]] = [(full, 0)]
        while stack:
            if nodes >= node_budget:
                exhausted = True
                break
            mask, off = stack.pop()
            nodes += 1
            cost, legal = replay.run(mask)
            if cost < best_cost - 1e-12:
                if legal:
                    best_cost = cost
                    best_mask = mask
                # monotonicity bound: only a cheaper coarse partition is
                # worth splitting further (paper Fig. 9 grey area).
                for i in range(off, E):
                    if (mask >> i) & 1:
                        stack.append((mask & ~(1 << i), i + 1))
    if stats is not None:
        stats["bb_nodes"] = nodes
        stats["bb_edges"] = E
        stats["bb_exhausted_budget"] = exhausted
        stats["proved_optimal"] = not exhausted
    if best_mask is None:
        return incumbent
    # materialize the winning mask on a fresh copy of the preconditioned state
    out = state
    idmap = {b: b for b in out.blocks}

    def find(x: int) -> int:
        while idmap[x] != x:
            idmap[x] = idmap[idmap[x]]
            x = idmap[x]
        return x

    for i, (u, v) in enumerate(edges):
        if (best_mask >> i) & 1:
            ru, rv = find(u), find(v)
            if ru != rv:
                keep = out.merge(ru, rv)
                idmap[ru if keep == rv else rv] = keep
    return out


_ALGORITHMS = {
    "singleton": singleton,
    "linear": linear,
    "greedy": greedy,
    "greedy_reference": greedy_reference,
    "unintrusive": unintrusive,
    "optimal": optimal,
}

_BUILDERS = {"indexed": build_graph, "reference": build_graph_reference}


_LOGGING_ALGORITHMS = {"linear", "greedy", "greedy_reference"}


PARTITION_BACKENDS = ("greedy", "ilp")


def partition(ops: Sequence[Op], algorithm: str = "greedy",
              cost_model="bohrium", node_budget: int = 100_000,
              graph: Optional[WSPGraph] = None,
              builder: str = "indexed",
              dense_weights: Optional[bool] = None,
              merge_log: Optional[List[Dict]] = None,
              partition_backend: str = "greedy") -> PartitionResult:
    """Front door: the graph + partition stages of the scheduler pipeline
    (tape → WSP graph → partition under a cost model).

    ``builder='reference'`` / ``dense_weights=True`` select the seed O(V²)
    path — used by differential tests and the scaling benchmark oracle.
    ``merge_log`` (the obs/explain hook) collects one dict per merge the
    WSP sweep considered — taken or rejected, with the priced saving — for
    the algorithms that decide merge-by-merge (linear/greedy/
    greedy_reference); other algorithms leave it empty.

    ``partition_backend='ilp'`` (the reference's anytime branch-and-bound
    solver) is not ported yet and raises ``NotImplementedError``; the
    default ``'greedy'`` backend is the classic per-``algorithm`` path."""
    if isinstance(cost_model, str):
        cost_model = make_cost_model(cost_model)
    if builder not in _BUILDERS:
        raise ValueError(f"unknown builder {builder!r}; have {sorted(_BUILDERS)}")
    if partition_backend not in PARTITION_BACKENDS:
        raise ValueError(f"unknown partition_backend {partition_backend!r}; "
                         f"have {sorted(PARTITION_BACKENDS)}")
    t0 = time.perf_counter()
    with trace.span("stage.graph", n_ops=len(ops), builder=builder):
        g = graph if graph is not None else _BUILDERS[builder](list(ops))
    t_graph = time.perf_counter() - t0
    state = PartitionState(g, cost_model, dense=dense_weights)
    stats: Dict[str, float] = {}
    t1 = time.perf_counter()
    with trace.span("stage.partition", algorithm=algorithm,
                    backend=partition_backend) as sp:
        if partition_backend == "ilp":
            raise NotImplementedError(
                "partition_backend='ilp' is not ported yet (ROADMAP A7)")
        if algorithm == "optimal":
            state = optimal(state, node_budget=node_budget, stats=stats)
            if stats.get("bb_exhausted_budget"):
                # budget exhausted: the preconditioned incumbent may lose to
                # a plain greedy sweep — never return worse than greedy.
                alt = greedy(PartitionState(g, cost_model,
                                            dense=dense_weights))
                if alt.cost() < state.cost():
                    state = alt
                    stats["fell_back_to_greedy"] = True
        elif algorithm in _LOGGING_ALGORITHMS:
            state = _ALGORITHMS[algorithm](state, merge_log=merge_log)
        elif algorithm in _ALGORITHMS:
            state = _ALGORITHMS[algorithm](state)
        else:
            raise ValueError(
                f"unknown algorithm {algorithm!r}; have {sorted(_ALGORITHMS)}")
        sp.set(n_blocks=state.n_blocks())
    stats["t_graph_s"] = t_graph
    stats["t_partition_s"] = time.perf_counter() - t1
    assert state.is_legal(), f"{algorithm} produced an illegal partition"
    return PartitionResult(state=state, algorithm=algorithm,
                           cost=state.cost(), n_blocks=state.n_blocks(),
                           stats=stats)
