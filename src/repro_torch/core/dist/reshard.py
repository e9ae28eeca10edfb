"""Resharding insertion — make communication visible to the partitioner
(the port's copy of ``repro.core.dist.reshard``).

The pass walks a recorded tape and, wherever consecutive operations disagree
on placement, injects an explicit COMM op (``comm_allgather`` /
``comm_reduce_scatter`` / ``comm_ppermute``, see ``ir.COMM_OPS``) that copies
the data into a fresh base carrying the required ``ShardSpec``, then rewrites
the consumer's input view onto that base.  COMM ops are ordinary graph
nodes: they carry views, participate in dependency edges, and are priced by
the ``comm`` cost model — so WSP trades interconnect bytes exactly like HBM
bytes.

Placement rules (dim-0 block sharding, the layout whose shards are
contiguous in the flat base):

* a **replicated** base serves any consumer shard-locally — never reshard;
* an **aligned** whole-base view of a sharded base serves consumers that
  compute under the *same* placement;
* a **misaligned** view (partial / shifted / strided / broadcast window of
  sharded data — e.g. a stencil's halo reads) forces ``comm_allgather``;
* an aligned view under a **different** sharding forces ``comm_ppermute``
  (the all-to-all reshard);
* a **reduction over the sharded dimension** is cross-shard: its input is
  allgathered first (``comm_reduce_scatter`` is reserved for explicit
  replicated→sharded placement casts via ``dist.reshard``; automatic rules
  never need it because replication serves every placement).

Crucially the pass inserts one COMM per *consuming read site* and never
memoizes across ops: deduplicating identical reshards is the partitioner's
job.  Identical COMM ops are mutually fusible, and ``CommCost`` prices a
merged COMM block by its *unique* collectives — so fusion literally elides
communication (``chip_smoke.py``'s ``MESH`` phase counts it on ranks).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..blocks import view_key
from ..ir import COMM_OPS, REDUCTIONS, BaseArray, Op, View, _op_counter
from .spec import ShardSpec, spec_of, view_aligned

OPAQUE = {"matmul", "gather"}


# ---------------------------------------------------------------------------
# Interconnect byte model (priced per COMM op; CommCost and the executor's
# accounting both call these, so "measured" and "modelled" bytes agree).
# ---------------------------------------------------------------------------

def comm_op_bytes(op: Op) -> float:
    """Fabric bytes one COMM op moves (ring-collective totals)."""
    if op.opcode not in COMM_OPS:
        return 0.0
    src = op.in_views()[0]
    if op.opcode == "comm_allgather":
        spec = spec_of(src.base)
        n = spec.n_shards if spec is not None else 1
        # ring allgather: every device forwards each of the other n-1 shards
        return float((n - 1) * src.nbytes)
    if op.opcode == "comm_ppermute":
        spec = spec_of(op.out.base)
        n = spec.n_shards if spec is not None else 1
        # all-to-all reshard: each device keeps 1/n of its shard locally
        return float(src.nbytes) * (n - 1) / max(1, n)
    # comm_reduce_scatter: a replicated source already holds every element
    # locally — the placement cast is a shard-local slice, zero fabric bytes.
    return 0.0


def _comm_key(op: Op) -> Tuple:
    """Identity of the collective a COMM op performs: ops agreeing on this
    key inside one block execute (and are priced) as ONE collective."""
    src = op.in_views()[0]
    spec = spec_of(op.out.base)
    return (op.opcode, view_key(src),
            spec.placement_key() if spec is not None else None)


def block_comm_bytes(ops: Sequence[Op]) -> float:
    """Fabric bytes of a block = sum over its *unique* collectives."""
    seen: Dict[Tuple, float] = {}
    for op in ops:
        if op.opcode in COMM_OPS:
            seen.setdefault(_comm_key(op), comm_op_bytes(op))
    return sum(seen.values())


# ---------------------------------------------------------------------------
# The insertion pass
# ---------------------------------------------------------------------------

def _canonical_view(base: BaseArray) -> View:
    spec = spec_of(base)
    shape = spec.shape if spec is not None else (base.size,)
    return View.contiguous(base, shape)


def _make_comm(kind: str, src: BaseArray,
               dst_spec: Optional[ShardSpec]) -> Tuple[Op, BaseArray]:
    dst = BaseArray(src.size, src.dtype, name=f"{src.name}'")
    dst.shard_spec = dst_spec
    src_view = _canonical_view(src)
    out_view = View.contiguous(dst, src_view.shape)
    op = Op(kind, out_view, (src_view,), new_bases=frozenset({dst}))
    return op, dst


def _elementwise_target(op: Op) -> Optional[ShardSpec]:
    """Placement an op computes under: a pre-existing output keeps its own
    placement; a fresh output adopts the first input placement that tiles
    the iteration domain (so fusion-friendly chains stay sharded)."""
    out = op.out
    if out is not None and out.base not in op.new_bases:
        return spec_of(out.base)
    for v in op.in_views():
        s = spec_of(v.base)
        if s is not None and view_aligned(v, s) and v.shape == s.shape \
                and op.out is not None and v.shape == op.out.shape:
            return s
    return None


def insert_resharding(tape: Sequence[Op], renumber: bool = True) -> List[Op]:
    """Return a new tape with COMM ops injected and consumer views rewritten.

    The input ops are mutated in place (their ``inputs`` tuples are
    redirected onto COMM output bases); inserted COMM bases receive a DEL
    immediately after their consumer so they stay single-use temporaries.
    With ``renumber`` (default) every op's uid is reassigned in tape order,
    preserving the "uid == program order" invariant that block summaries
    rely on.
    """
    out: List[Op] = []
    any_comm = False
    for op in tape:
        if op.is_system() or op.opcode in COMM_OPS or op.out is None:
            out.append(op)
            continue

        if op.opcode in REDUCTIONS:
            target = None          # cross-shard sweeps compute replicated...
            v = op.in_views()[0]
            s = spec_of(v.base)
            if s is not None and view_aligned(v, s) and v.shape == s.shape \
                    and op.axis is not None and op.axis != 0:
                target = s         # ...unless the swept dim is unsharded
        elif op.opcode in OPAQUE or op.opcode in ("random", "range"):
            target = None          # irregular access computes replicated
        else:
            target = _elementwise_target(op)

        site_memo: Dict[Tuple, BaseArray] = {}
        new_inputs = []
        comms: List[Op] = []
        dels: List[Op] = []
        for v in op.inputs:
            if not isinstance(v, View):
                new_inputs.append(v)
                continue
            s = spec_of(v.base)
            needs_gather = False
            kind = None
            if s is not None:
                if not view_aligned(v, s):
                    needs_gather = True                  # halo / window read
                elif op.opcode in REDUCTIONS and (target is None
                                                  or v.shape != s.shape):
                    needs_gather = True                  # cross-shard sweep
                elif target is None:
                    needs_gather = True                  # replicated consumer
                elif s.placement_key() != target.placement_key():
                    kind = "comm_ppermute"               # sharded → resharded
            if needs_gather:
                kind = "comm_allgather"
            if kind is None:
                new_inputs.append(v)
                continue
            dst_spec = None if kind == "comm_allgather" else target
            memo_key = (v.base.uid, kind,
                        dst_spec.placement_key() if dst_spec else None)
            dst = site_memo.get(memo_key)
            if dst is None:
                comm, dst = _make_comm(kind, v.base, dst_spec)
                comms.append(comm)
                dels.append(Op("del", None, del_bases=frozenset({dst})))
                site_memo[memo_key] = dst
            new_inputs.append(View(dst, v.offset, v.shape, v.strides))

        if comms:
            any_comm = True
            op.inputs = tuple(new_inputs)
            out.extend(comms)
        out.append(op)
        out.extend(dels)

        # propagate placement onto freshly-created output bases
        ob = op.out.base
        if ob in op.new_bases and spec_of(ob) is None:
            if target is not None and op.opcode in REDUCTIONS:
                ob.shard_spec = target.drop_dim(op.axis)
            elif target is not None and op.out.shape == target.shape:
                ob.shard_spec = target

    if renumber and any_comm:
        for op in out:
            op.uid = next(_op_counter)
    return out


def tape_has_sharding(tape: Sequence[Op]) -> bool:
    """Cheap scan: does any base on the tape carry a real ShardSpec?"""
    for op in tape:
        for v in (*op.in_views(), *op.out_views()):
            if spec_of(v.base) is not None:
                return True
    return False
