"""ILP/anytime partition solver (`partition_backend="ilp"`), the port's
copy of ``repro.core.partition_ilp`` (pure Python, no solver package).

The paper's OPTIMAL (Fig. 10) is an exponential search with a node budget;
this module restates the problem as a 0/1 integer program and solves it
with a pure-Python branch-and-bound whose contract is *anytime*:

* **Variables.**  One 0/1 merge variable per weight edge of the
  (unintrusively preconditioned) partition state.  An assignment
  contracts the connected components of its 1-edges (union-find closure —
  two blocks may share a component through other 1-edges even when their
  own edge is 0, exactly like Fig. 10's MERGEBYMASK).
* **Constraints.**  Def. 5(1) fuse-forbidden pairs must stay in different
  components; Def. 5(2) the contracted dependency DAG must stay acyclic.
  Neither is monotone in the *top-down* search direction (removing an
  edge can FIX both), so legality only gates incumbent updates — it never
  prunes.
* **Objective.**  `cost_model.partition_cost` over the resulting blocks —
  the calibrated model when one is fitted, the analytic gpu/Bohrium model
  otherwise.
* **Search & bound.**  Coarsest-first: the root contracts EVERY edge
  (legality ignored) and children remove one 1-edge at a time (the Fig. 10
  enumeration).  For the repo's monotone cost models (``merge_saving >=
  0``, the same Fig. 9 assumption the classic ``optimal`` search makes) a
  node's own cost lower-bounds its entire subtree — subsets of a mask only
  cost more — so a node at or above the incumbent prunes its subtree, and
  the root's cost is the global relaxation.
* **Warm start / anytime cutoff.**  The greedy solution is the initial
  incumbent, so the solver is *never worse than greedy* no matter how
  early `time_budget_s` (wall clock) or `node_budget` cuts it off.  On
  exit it reports a global lower bound — the min over the unexplored
  subtrees' bounds — and the optimality gap against the incumbent.

Returned stats (threaded into ``PartitionResult.stats`` and the explain
report): ``ilp_status`` (``optimal`` | ``anytime`` | ``budget-hit``),
``ilp_objective``, ``ilp_bound``, ``ilp_gap``, ``ilp_nodes``,
``ilp_edges``, ``ilp_wall_s``, ``greedy_cost``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from .blocks import BlockInfo
from .partition import PartitionState

_EPS = 1e-12


class _EdgeReplay:
    """Evaluate one search node: contract a set of edges with a union-find,
    tracking fuse-forbidden feasibility and the resulting block costs.

    Like Fig. 10's MERGEBYMASK this replays from scratch per node — the
    edge lists are small after unintrusive preconditioning and the replay
    keeps the search state trivially correct under DFS backtracking."""

    def __init__(self, state: PartitionState, edges: List[Tuple[int, int]]):
        self.state = state
        self.edges = edges
        self.block_ids = sorted(state.blocks)

    def run(self, mask: int):
        """Contract the 1-edges of ``mask``.  Returns
        ``(cost, fuse_ok, find)`` where ``find`` maps block id ->
        component root."""
        st = self.state
        parent = {b: b for b in self.block_ids}

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        infos: Dict[int, BlockInfo] = dict(st.blocks)
        # per-root union of the members' fuse-forbidden partner sets and of
        # the member ids themselves: a union violates Def. 5(1) iff one
        # side's members intersect the other side's forbidden partners.
        members: Dict[int, set] = {b: {b} for b in self.block_ids}
        fuse: Dict[int, set] = {b: set(st.fuse[b]) for b in self.block_ids}
        fuse_ok = True
        for i, (u, v) in enumerate(self.edges):
            if not (mask >> i) & 1:
                continue
            ru, rv = find(u), find(v)
            if ru == rv:
                continue
            if fuse_ok and (members[ru] & fuse[rv]
                            or members[rv] & fuse[ru]):
                fuse_ok = False
            # union smaller into larger to keep set merging near-linear
            if len(members[ru]) < len(members[rv]):
                ru, rv = rv, ru
            parent[rv] = ru
            members[ru] |= members.pop(rv)
            fuse[ru] |= fuse.pop(rv)
            infos[ru] = infos[ru].merged_with(infos.pop(rv))
        cost = st.cost_model.partition_cost(list(infos.values()))
        return cost, fuse_ok, find

    def acyclic(self, find) -> bool:
        """Def. 5(2) on the contracted dependency graph (Kahn)."""
        st = self.state
        roots = {find(b) for b in self.block_ids}
        adj: Dict[int, set] = {r: set() for r in roots}
        for b in self.block_ids:
            rb = find(b)
            for n in st.dep_out[b]:
                rn = find(n)
                if rn != rb:
                    adj[rb].add(rn)
        indeg = {r: 0 for r in roots}
        for ns in adj.values():
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
        return seen == len(roots)


def ilp_partition(state: PartitionState, *,
                  time_budget_s: Optional[float] = None,
                  node_budget: int = 1_000_000,
                  stats: Optional[Dict] = None,
                  merge_log: Optional[List[Dict]] = None) -> PartitionState:
    """Solve the partition ILP anytime; never worse than greedy.

    ``state`` must be a fresh (singleton) partition state.  ``merge_log``
    receives the *warm start's* merge decisions (the explain layer shows
    those plus the solver verdict — the ILP itself does not decide
    merge-by-merge)."""
    from .algorithms import greedy, unintrusive   # circular-at-import-time

    t0 = time.perf_counter()
    # plain greedy on the raw state: the never-worse-than-greedy baseline
    plain = greedy(state.copy(), merge_log=merge_log)
    greedy_cost = plain.cost()

    # unintrusive preconditioning (Thm. 3: optimality-preserving) shrinks
    # the variable count; drop now-illegal weight edges before branching.
    pre = unintrusive(state)
    for key in sorted(pre.weights):
        if not pre.legal_merge(*key):
            pre.drop_weight(*key)

    incumbent = plain
    best_cost = greedy_cost
    # greedy over the preconditioned state sometimes differs — keep the
    # cheaper of the two as the initial incumbent.
    warm = greedy(pre.copy())
    if warm.cost() < best_cost - _EPS:
        incumbent, best_cost = warm, warm.cost()

    edges = sorted(pre.weights,
                   key=lambda e: (-pre.weights[e], e))
    E = len(edges)
    replay = _EdgeReplay(pre, edges)
    nodes = 0
    best_mask: Optional[int] = None
    cut_time = cut_nodes = False
    # coarsest-first DFS over (mask, off, inherited_bound): children remove
    # one 1-edge at a position >= off (each subset enumerated once); the
    # inherited bound is the parent's own cost — a valid subtree bound
    # under monotonicity, and the honest global bound on cutoff.
    open_nodes: List[Tuple[int, int, float]] = []
    root_relax = best_cost
    if E > 0:
        full = (1 << E) - 1
        root_relax, _, _ = replay.run(full)   # the global LP-style relaxation
        open_nodes.append((full, 0, root_relax))
    global_bound = best_cost
    while open_nodes:
        if time_budget_s is not None \
                and time.perf_counter() - t0 >= time_budget_s:
            cut_time = True
            break
        if nodes >= node_budget:
            cut_nodes = True
            break
        mask, off, inherited = open_nodes.pop()
        if inherited >= best_cost - _EPS:
            continue                      # incumbent improved since push
        nodes += 1
        cost, fuse_ok, find = replay.run(mask)
        if cost >= best_cost - _EPS:
            continue   # monotone: every subset of `mask` costs at least this
        if fuse_ok and replay.acyclic(find):
            best_cost = cost
            best_mask = mask
        for i in range(off, E):
            if (mask >> i) & 1:
                open_nodes.append((mask & ~(1 << i), i + 1, cost))
    if cut_time or cut_nodes:
        # optimum >= min over every unexplored subtree's inherited bound
        global_bound = min([best_cost] + [b for (_, _, b) in open_nodes])
        status = "anytime" if (best_mask is not None
                               or best_cost < greedy_cost - _EPS) \
            else "budget-hit"
    else:
        global_bound = best_cost
        status = "optimal"

    if best_mask is not None:
        # materialise the winning assignment on the preconditioned state
        out = pre
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
        incumbent = out

    wall = time.perf_counter() - t0
    obj = incumbent.cost()
    gap = max(0.0, obj - global_bound) / max(abs(obj), _EPS)
    if stats is not None:
        stats.update({
            "ilp_status": status,
            "ilp_objective": obj,
            "ilp_bound": global_bound,
            "ilp_gap": gap,
            "ilp_nodes": nodes,
            "ilp_edges": E,
            "ilp_wall_s": wall,
            "greedy_cost": greedy_cost,
        })
    assert obj <= greedy_cost + _EPS, \
        "ilp returned a plan costlier than greedy"
    return incumbent
