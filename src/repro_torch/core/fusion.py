"""WSP graph construction from an array-bytecode tape (paper §III).

Implements Def. 11 (data-parallelism), Def. 12 (pairwise fusibility) and the
construction of the WSP instance ``G = (V, E_d, E_f)`` from a list of array
operations (§III-3).

Two builders produce bit-identical graphs (DESIGN.md §4):

* ``build_graph``           — base-indexed construction: per-``BaseArray``
  reader/writer lists narrow both the dependency and the Def-12 candidate
  sets to same-base pairs, so the pairwise predicates run only on pairs that
  can actually conflict.  Near-linear on real tapes (bounded accessors per
  base); worst case still O(V²) when the tape genuinely has Θ(V²) edges.
* ``build_graph_reference``  — the paper's O(V²) pairwise sweep, kept as the
  oracle for differential tests and for the seed-path benchmark.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from .ir import COMM_OPS, ELEMENTWISE, REDUCTIONS, Op, View

# opcodes that are data-parallel over a regular iteration domain and may share
# a fused kernel with other such ops (reductions fuse on their sweep domain;
# gather is data-parallel over its OUTPUT domain — each output element reads
# one table element through the index operand).
FUSIBLE_OPCODES = (set(ELEMENTWISE) | REDUCTIONS
                   | {"random", "range", "gather"} | COMM_OPS)
# opcodes that never share a block with a non-system op (irregular access).
OPAQUE_OPCODES = {"matmul"}


def data_parallel(op: Op) -> bool:
    """Def. 11: overlapping input/output views must be identical."""
    outs = op.out_views()
    for i in op.in_views():
        for o in outs:
            if i.overlaps(o) and not i.identical(o):
                return False
    for a in range(len(outs)):
        for b in range(a + 1, len(outs)):
            if outs[a].overlaps(outs[b]) and not outs[a].identical(outs[b]):
                return False
    return True


def _views_compatible(xs: Tuple[View, ...], ys: Tuple[View, ...]) -> bool:
    for x in xs:
        for y in ys:
            if x.overlaps(y) and not x.identical(y):
                return False
    return True


def fusible(f: Op, g: Op) -> bool:
    """Def. 12 (+ equal iteration domain, §III-A.1).

    ``f`` precedes ``g`` in program order.  System ops (DEL/SYNC) have no
    views and fuse with everything.
    """
    if f.is_system() or g.is_system():
        return True
    if f.opcode in OPAQUE_OPCODES or g.opcode in OPAQUE_OPCODES:
        return False
    # gather legality: the fused kernel keeps the gather's TABLE (its data
    # input, inputs[0]) whole-array resident per grid step — it cannot be
    # tiled by the output domain, so a value written to the table inside
    # the block would race the gather's random reads.  A gather therefore
    # never fuses with an op that writes any view overlapping its table
    # (even an identical view, which Def. 12 alone would allow); readers
    # of the table and gather×gather pairs stay fusible.
    for a, b in ((f, g), (g, f)):
        if a.opcode == "gather" and isinstance(a.inputs[0], View):
            tv = a.inputs[0]
            for o in b.out_views():
                if tv.overlaps(o):
                    return False
    # COMM boundary (core/dist): a collective never shares a kernel with
    # compute — it marks a placement change the executor must realize at a
    # block edge.  COMM ops DO fuse with each other (identical reshards of
    # one base merge into a single collective — communication elision).
    if (f.opcode in COMM_OPS) != (g.opcode in COMM_OPS):
        return False
    # Bohrium: equal length and dimensionality of the iteration domain.
    if f.domain != g.domain:
        return False
    if not _views_compatible(g.in_views(), f.out_views()):    # Def 12(1)
        return False
    if not _views_compatible(g.out_views(), f.out_views()):   # Def 12(2)
        return False
    if not _views_compatible(g.out_views(), f.in_views()):    # Def 12(3)
        return False
    return True


def _dep_reads(op: Op) -> Tuple[View, ...]:
    """Views whose contents this op observes (for dependency edges).  DEL and
    SYNC have no cost views but do order against accesses of their bases."""
    if op.is_system():
        return tuple(View.contiguous(b, (b.size,)) for b in
                     (*op.del_bases, *op.sync_bases))
    return op.in_views()


def _dep_writes(op: Op) -> Tuple[View, ...]:
    if op.opcode == "del":
        # destroying a base conflicts with ANY later access
        return tuple(View.contiguous(b, (b.size,)) for b in op.del_bases)
    return op.out_views()


def depends(f: Op, g: Op) -> bool:
    """True iff ``g`` must execute after ``f`` (f precedes g in program
    order): RAW / WAR / WAW conflicts on overlapping views."""
    fr, fw = _dep_reads(f), _dep_writes(f)
    gr, gw = _dep_reads(g), _dep_writes(g)
    for o in fw:                    # RAW + WAW
        for v in (*gr, *gw):
            if o.overlaps(v):
                return True
    for i in fr:                    # WAR
        for o in gw:
            if i.overlaps(o):
                return True
    return False


_EMPTY: frozenset = frozenset()


@dataclass
class WSPGraph:
    """The WSP instance: vertices are tape indices into ``ops``."""

    ops: List[Op]
    dep_out: Dict[int, Set[int]] = field(default_factory=dict)   # E_d (i -> j)
    dep_in: Dict[int, Set[int]] = field(default_factory=dict)
    fuse_forbidden: Dict[int, Set[int]] = field(default_factory=dict)  # E_f

    def n(self) -> int:
        return len(self.ops)


def build_graph_reference(ops: List[Op]) -> WSPGraph:
    """O(V²) pairwise construction (§III-3), with transitive reduction of
    E_d left implicit (partition legality only needs reachability).  Kept as
    the reference oracle for the base-indexed builder below."""
    n = len(ops)
    g = WSPGraph(ops=ops,
                 dep_out={i: set() for i in range(n)},
                 dep_in={i: set() for i in range(n)},
                 fuse_forbidden={i: set() for i in range(n)})
    for j in range(n):
        for i in range(j):
            if depends(ops[i], ops[j]):
                g.dep_out[i].add(j)
                g.dep_in[j].add(i)
            if not fusible(ops[i], ops[j]):
                g.fuse_forbidden[i].add(j)
                g.fuse_forbidden[j].add(i)
        if not data_parallel(ops[j]):
            raise ValueError(f"operation is not data-parallel (Def 11): {ops[j]}")
    return g


def build_graph(ops: List[Op]) -> WSPGraph:
    """Base-indexed WSP construction — bit-identical to
    ``build_graph_reference`` (differentially tested), near-linear on tapes
    whose bases have bounded accessor counts.

    Dependency edges need a shared base (views of different bases never
    overlap), so candidates for ``depends`` come from per-base reader/writer
    lists keyed on the ``_dep_reads``/``_dep_writes`` views.  Fuse-forbidden
    edges decompose into (a) opaque × non-system pairs, (b) different
    iteration domains, (c) same-domain Def-12 view conflicts — and (c) also
    needs a shared base, so it is driven by per-base in/out-view indexes
    with ``View.overlaps`` run only on those same-base candidates.
    """
    n = len(ops)
    g = WSPGraph(ops=ops,
                 dep_out={i: set() for i in range(n)},
                 dep_in={i: set() for i in range(n)},
                 fuse_forbidden={i: set() for i in range(n)})
    # dependency indexes: base uid -> op indices whose dep-views touch it
    dep_readers: Dict[int, Set[int]] = {}
    dep_writers: Dict[int, Set[int]] = {}
    # fusibility indexes (non-system ops only; system ops fuse with all)
    in_ops: Dict[int, Set[int]] = {}       # base uid -> ops with an in-view
    out_ops: Dict[int, Set[int]] = {}      # base uid -> ops with an out-view
    opaque_ops: List[int] = []
    comm_ops: List[int] = []
    # per-class domain buckets: COMM ops never fuse with compute, so their
    # same-domain candidate sets are tracked separately from compute ops.
    domain_ops: Dict[Tuple[int, ...], List[int]] = {}        # compute
    comm_domain_ops: Dict[Tuple[int, ...], List[int]] = {}   # comm
    n_compute = 0

    for j in range(n):
        opj = ops[j]
        # -- E_d: same predicate as the reference, on same-base candidates
        jr, jw = _dep_reads(opj), _dep_writes(opj)
        cand: Set[int] = set()
        for v in jw:                       # WAW + WAR against j's writes
            u = v.base.uid
            cand |= dep_writers.get(u, _EMPTY)
            cand |= dep_readers.get(u, _EMPTY)
        for v in jr:                       # RAW against j's reads
            cand |= dep_writers.get(v.base.uid, _EMPTY)
        for i in cand:
            if depends(ops[i], opj):
                g.dep_out[i].add(j)
                g.dep_in[j].add(i)

        # -- E_f
        if not opj.is_system():
            forb = g.fuse_forbidden[j]
            if opj.opcode in OPAQUE_OPCODES:
                # (a) opaque: forbidden with every earlier non-system op
                for bucket in (domain_ops, comm_domain_ops):
                    for d_ops in bucket.values():
                        for i in d_ops:
                            forb.add(i)
                            g.fuse_forbidden[i].add(j)
                for i in opaque_ops:
                    forb.add(i)
                    g.fuse_forbidden[i].add(j)
                opaque_ops.append(j)
            else:
                for i in opaque_ops:                   # (a) mirrored
                    forb.add(i)
                    g.fuse_forbidden[i].add(j)
                is_comm = opj.opcode in COMM_OPS
                if is_comm:
                    # (a') COMM boundary: forbidden with every compute op
                    for d_ops in domain_ops.values():
                        for i in d_ops:
                            forb.add(i)
                            g.fuse_forbidden[i].add(j)
                    my_domains, n_same_class = comm_domain_ops, len(comm_ops)
                else:
                    for i in comm_ops:                 # (a') mirrored
                        forb.add(i)
                        g.fuse_forbidden[i].add(j)
                    my_domains, n_same_class = domain_ops, n_compute
                dom = opj.domain
                same = my_domains.get(dom)
                if len(same or ()) < n_same_class:
                    for d, d_ops in my_domains.items():  # (b) domain mismatch
                        if d != dom:
                            for i in d_ops:
                                forb.add(i)
                                g.fuse_forbidden[i].add(j)
                # (c) Def-12 conflicts require a shared base
                vcand: Set[int] = set()
                for v in opj.in_views():               # g.in  vs f.out
                    vcand |= out_ops.get(v.base.uid, _EMPTY)
                for v in opj.out_views():              # g.out vs f.{in,out}
                    u = v.base.uid
                    vcand |= out_ops.get(u, _EMPTY)
                    vcand |= in_ops.get(u, _EMPTY)
                for i in vcand:
                    if i not in forb and not fusible(ops[i], opj):
                        forb.add(i)
                        g.fuse_forbidden[i].add(j)
                if same is None:
                    my_domains[dom] = [j]
                else:
                    same.append(j)
                for v in opj.in_views():
                    in_ops.setdefault(v.base.uid, set()).add(j)
                for v in opj.out_views():
                    out_ops.setdefault(v.base.uid, set()).add(j)
                if is_comm:
                    comm_ops.append(j)
                else:
                    n_compute += 1

        for v in jr:
            dep_readers.setdefault(v.base.uid, set()).add(j)
        for v in jw:
            dep_writers.setdefault(v.base.uid, set()).add(j)

        if not data_parallel(opj):
            raise ValueError(f"operation is not data-parallel (Def 11): {opj}")
    return g
