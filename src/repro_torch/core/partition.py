"""Partition graphs and the WSP state (paper Defs. 14–17, Lemma 1).

``PartitionState`` is the mutable structure all partition algorithms operate
on: the partition graph (blocks + contracted dependency/fuse edges) plus the
weight graph ``E_w`` whose edge weights are ``merge_saving`` values.

Weight-graph scaling (DESIGN.md §5): for *sparse* cost models (models whose
``merge_saving`` can only be positive when two blocks structurally interact
— shared identical views, creator/reader, writer/deleter, creator/deleter
pairs) the weight graph is built from those support candidates plus
dependency adjacency instead of all V² pairs, and Def. 17's MERGE recomputes
only the edges incident to the contracted vertex's support neighbourhood —
O(degree) savings computations per merge.  Dense models (whose saving is
positive for any pair, e.g. per-block launch overheads) keep the exact
all-pairs behaviour.  Both paths produce bit-identical weight graphs for the
models they serve (differentially tested).
"""

from __future__ import annotations

import heapq
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from .blocks import BlockInfo, view_key
from .cost import CostModel
from .fusion import WSPGraph


def _ekey(u: int, v: int) -> Tuple[int, int]:
    return (u, v) if u < v else (v, u)


def _support_pairs(graph: WSPGraph) -> Set[Tuple[int, int]]:
    """Structural saving-support pairs of a tape: every (i, j) whose
    ``merge_saving`` can be non-zero under a sparse cost model, plus all
    dependency-adjacent pairs (which keep zero-saving legality chains alive,
    exactly as the dense initializer does).

    Sources (see ``cost.closed_form_saving`` / Prop. 1):
      * identical view keys shared between two ops (ext∩ext dedup),
      * an op reading a base another op creates  (new[B1] ∩ in[B2]),
      * an op writing a base another op deletes  (out[B1] ∩ del[B2]),
      * creator/deleter pairs (array contraction, Def. 19 models).
    """
    ops = graph.ops
    pairs: Set[Tuple[int, int]] = set()
    for i, outs in graph.dep_out.items():
        for j in outs:
            pairs.add(_ekey(i, j))
    by_key: Dict[Tuple, List[int]] = {}
    creators: Dict[int, List[int]] = {}
    deleters: Dict[int, List[int]] = {}
    readers: Dict[int, Set[int]] = {}
    writers: Dict[int, Set[int]] = {}
    for idx, op in enumerate(ops):
        for v in op.in_views():
            by_key.setdefault(view_key(v), []).append(idx)
            readers.setdefault(v.base.uid, set()).add(idx)
        for v in op.out_views():
            by_key.setdefault(view_key(v), []).append(idx)
            writers.setdefault(v.base.uid, set()).add(idx)
        for b in op.new_bases:
            creators.setdefault(b.uid, []).append(idx)
        for b in op.del_bases:
            deleters.setdefault(b.uid, []).append(idx)
    for lst in by_key.values():
        uniq = sorted(set(lst))
        for a in range(len(uniq)):
            for b in range(a + 1, len(uniq)):
                pairs.add((uniq[a], uniq[b]))
    for uid, cs in creators.items():
        partners = readers.get(uid, set()) | set(deleters.get(uid, ()))
        for c in cs:
            for p in partners:
                if p != c:
                    pairs.add(_ekey(c, p))
    for uid, ds in deleters.items():
        for d in ds:
            for w in writers.get(uid, ()):
                if w != d:
                    pairs.add(_ekey(d, w))
    return pairs


class PartitionState:
    """A legal partition of a WSP graph + its weight graph (Def. 15)."""

    def __init__(self, graph: WSPGraph, cost_model: CostModel,
                 _skip_init: bool = False, dense: Optional[bool] = None):
        self.graph = graph
        self.cost_model = cost_model
        if _skip_init:
            return
        cost_model.prepare(graph.ops)
        n = graph.n()
        self.blocks: Dict[int, BlockInfo] = {
            i: BlockInfo.from_op(graph.ops[i]) for i in range(n)}
        self.members: Dict[int, Set[int]] = {i: {i} for i in range(n)}
        self.block_of: Dict[int, int] = {i: i for i in range(n)}
        self.dep_out: Dict[int, Set[int]] = {i: set(graph.dep_out[i]) for i in range(n)}
        self.dep_in: Dict[int, Set[int]] = {i: set(graph.dep_in[i]) for i in range(n)}
        self.fuse: Dict[int, Set[int]] = {i: set(graph.fuse_forbidden[i]) for i in range(n)}
        # E_w (Def. 15): formally the complete weighted graph.  We keep the
        # edges that can matter: positive-saving pairs, plus dependency-
        # adjacent zero-saving pairs (cost-neutral merges that legality
        # chains — e.g. a create→…→DEL contraction chain — must pass
        # through; dropping them would make such chains unreachable).
        self._dense = (not getattr(cost_model, "sparse_weights", False)
                       if dense is None else dense)
        self.weights: Dict[Tuple[int, int], float] = {}
        self._adj: Dict[int, Set[int]] = {i: set() for i in range(n)}
        # support adjacency (sparse path only): pairs whose saving can ever
        # be non-zero, kept across drop_weight so a merge can resurrect a
        # previously-discarded edge exactly like the dense recompute does.
        self._support: Dict[int, Set[int]] = {i: set() for i in range(n)}
        if self._dense:
            candidates: Iterable[Tuple[int, int]] = (
                (u, v) for u in range(n) for v in range(u + 1, n))
        else:
            candidates = sorted(_support_pairs(graph))
        for u, v in candidates:
            if v in self.fuse[u]:
                continue
            if not self._dense:
                self._support[u].add(v)
                self._support[v].add(u)
            s = cost_model.merge_saving(self.blocks[u], self.blocks[v])
            if s > 0 or v in self.dep_out[u] or u in self.dep_out[v]:
                self._set_weight(u, v, s)

    # -- weight-graph bookkeeping --------------------------------------
    def _set_weight(self, u: int, v: int, s: float) -> None:
        self.weights[_ekey(u, v)] = s
        self._adj[u].add(v)
        self._adj[v].add(u)

    def drop_weight(self, u: int, v: int) -> None:
        """Remove one weight edge (e.g. found illegal by an algorithm)."""
        if self.weights.pop(_ekey(u, v), None) is not None:
            self._adj[u].discard(v)
            self._adj[v].discard(u)

    # ------------------------------------------------------------------
    def copy(self) -> "PartitionState":
        st = PartitionState(self.graph, self.cost_model, _skip_init=True)
        st.blocks = dict(self.blocks)      # BlockInfo treated immutable
        st.members = {k: set(v) for k, v in self.members.items()}
        st.block_of = dict(self.block_of)
        st.dep_out = {k: set(v) for k, v in self.dep_out.items()}
        st.dep_in = {k: set(v) for k, v in self.dep_in.items()}
        st.fuse = {k: set(v) for k, v in self.fuse.items()}
        st.weights = dict(self.weights)
        st._adj = {k: set(v) for k, v in self._adj.items()}
        st._support = {k: set(v) for k, v in self._support.items()}
        st._dense = self._dense
        return st

    # -- Lemma 1 ---------------------------------------------------------
    def _path_avoiding_direct(self, src: int, dst: int) -> bool:
        """True if a dep path src→…→dst of length >= 2 exists.

        Bidirectional BFS: expand the smaller frontier (descendants of
        ``src``'s non-direct successors vs ancestors of ``dst``'s
        non-direct predecessors) until the explored sets meet.  Exact —
        same predicate as a full forward DFS — but typically explores a
        tiny fraction of the DAG when no path exists."""
        fwd = {x for x in self.dep_out[src] if x != dst}
        if not fwd:
            return False
        bwd = {x for x in self.dep_in[dst] if x != src}
        if not bwd:
            return False
        if fwd & bwd:
            return True
        f_seen, b_seen = set(fwd), set(bwd)
        f_frontier, b_frontier = fwd, bwd
        while f_frontier and b_frontier:
            if len(f_frontier) <= len(b_frontier):
                nxt: Set[int] = set()
                for x in f_frontier:
                    for m in self.dep_out[x]:
                        if m == dst:
                            return True
                        if m not in f_seen:
                            if m in b_seen:
                                return True
                            f_seen.add(m)
                            nxt.add(m)
                f_frontier = nxt
            else:
                nxt = set()
                for x in b_frontier:
                    for m in self.dep_in[x]:
                        if m == src:
                            return True
                        if m not in b_seen:
                            if m in f_seen:
                                return True
                            b_seen.add(m)
                            nxt.add(m)
                b_frontier = nxt
        return False

    def legal_merge(self, u: int, v: int) -> bool:
        if u == v or v in self.fuse[u]:
            return False
        return not (self._path_avoiding_direct(u, v)
                    or self._path_avoiding_direct(v, u))

    # -- Def. 17 MERGE ----------------------------------------------------
    def merge(self, u: int, v: int) -> int:
        """Contract v into u (in place).  Returns surviving block id."""
        assert u != v
        self.blocks[u] = self.blocks[u].merged_with(self.blocks[v])
        self.members[u] |= self.members.pop(v)
        for i in self.members[u]:
            self.block_of[i] = u
        for n in self.dep_out.pop(v):
            self.dep_in[n].discard(v)
            if n != u:
                self.dep_out[u].add(n)
                self.dep_in[n].add(u)
        for n in self.dep_in.pop(v):
            self.dep_out[n].discard(v)
            if n != u:
                self.dep_in[u].add(n)
                self.dep_out[n].add(u)
        for n in self.fuse.pop(v):
            self.fuse[n].discard(v)
            if n != u:
                self.fuse[u].add(n)
                self.fuse[n].add(u)
        del self.blocks[v]
        # drop all weight edges touching u or v, recompute u's neighborhood
        for x in list(self._adj[u]):
            self.drop_weight(u, x)
        for x in list(self._adj[v]):
            self.drop_weight(v, x)
        del self._adj[v]
        bu = self.blocks[u]
        if self._dense:
            candidates: Iterable[int] = self.blocks
        else:
            # saving support of the union is the union of supports, so only
            # u's and v's support neighbours can carry a (re)computed edge —
            # bit-identical to the dense all-blocks sweep for sparse models.
            sup = self._support[u]
            sup |= self._support.pop(v)
            sup.discard(u)
            sup.discard(v)
            for x in sup:
                sx = self._support[x]
                sx.discard(v)
                sx.add(u)
            candidates = sup
        for x in candidates:
            if x == u or x in self.fuse[u]:
                continue
            s = self.cost_model.merge_saving(bu, self.blocks[x])
            if s > 0 or x in self.dep_out[u] or x in self.dep_in[u]:
                self._set_weight(u, x, s)
        return u

    # -- queries -----------------------------------------------------------
    def cost(self) -> float:
        return self.cost_model.partition_cost(list(self.blocks.values()))

    def n_blocks(self) -> int:
        return len(self.blocks)

    def has_cycle(self) -> bool:
        indeg = {b: len(self.dep_in[b]) for b in self.blocks}
        q = [b for b, d in indeg.items() if d == 0]
        seen = 0
        while q:
            x = q.pop()
            seen += 1
            for n in self.dep_out[x]:
                indeg[n] -= 1
                if indeg[n] == 0:
                    q.append(n)
        return seen != len(self.blocks)

    def is_legal(self) -> bool:
        """Full Def. 5 check (used by tests, not by the algorithms)."""
        for b, info in self.blocks.items():
            mem = self.members[b]
            for i in mem:
                if self.graph.fuse_forbidden[i] & mem:
                    return False
        return not self.has_cycle()

    def topo_blocks(self) -> List[int]:
        """Dependency-respecting block order, stable in program order."""
        indeg = {b: len(self.dep_in[b]) for b in self.blocks}
        heap = [(min(self.members[b]), b) for b, d in indeg.items() if d == 0]
        heapq.heapify(heap)
        order: List[int] = []
        while heap:
            _, b = heapq.heappop(heap)
            order.append(b)
            for n in sorted(self.dep_out[b]):
                indeg[n] -= 1
                if indeg[n] == 0:
                    heapq.heappush(heap, (min(self.members[n]), n))
        if len(order) != len(self.blocks):
            raise RuntimeError("partition dependency graph has a cycle")
        return order

    def op_blocks(self) -> List[List[int]]:
        """Topologically ordered blocks as lists of tape indices."""
        return [sorted(self.members[b]) for b in self.topo_blocks()]

    def tr_degrees(self) -> Dict[int, int]:
        """Total degree of each block in the transitive reduction of Ê_d
        (Thm. 3 condition 2: one endpoint must be a pendant vertex; the
        paper's Prop. 2 proof works in the transitive reduction)."""
        order = self.topo_blocks()
        reach: Dict[int, Set[int]] = {}
        for b in reversed(order):
            r: Set[int] = set()
            for n in self.dep_out[b]:
                r.add(n)
                r |= reach[n]
            reach[b] = r
        deg: Dict[int, int] = {b: 0 for b in self.blocks}
        for b in self.blocks:
            for n in self.dep_out[b]:
                # edge b->n is redundant if some other successor reaches n
                if not any(n in reach[m] for m in self.dep_out[b] if m != n):
                    deg[b] += 1
                    deg[n] += 1
        return deg

    # -- non-fusible sets θ (Def. 18) --------------------------------------
    def theta(self, b: int) -> FrozenSet[int]:
        """Def. 18: blocks connected with ``b`` in Ê_d through a path that
        contains a non-fusible edge.  We follow directed descendant paths
        (the orientation that reproduces the paper's a,e worked example);
        Thm. 3's guarantee — unintrusive merges preserve optimality — is
        validated by tests against exhaustive search."""
        out: Set[int] = set()
        seen: Set[Tuple[int, bool]] = set()
        stack: List[Tuple[int, bool]] = [(b, False)]
        while stack:
            x, nf = stack.pop()
            for n in self.dep_out[x]:
                nnf = nf or (n in self.fuse[x])
                if (n, nnf) in seen:
                    continue
                seen.add((n, nnf))
                if nnf:
                    out.add(n)
                stack.append((n, nnf))
        return frozenset(out)
