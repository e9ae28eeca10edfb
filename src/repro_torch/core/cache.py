"""Merge cache (paper §IV-F) and the canonical structural tape signature.

The cache key is a canonical tape signature with base uids renumbered by
first occurrence — two loop iterations that allocate fresh bases but perform
the same operations hash identically (exactly Bohrium's behaviour).  Each op
carries a memoized, renumber-independent *structural template* plus the
ordered base uids it references, so re-hashing a structurally-identical tape
on the warm path (once for the tape-level merge-cache key, then again per
block for the executable-cache signatures) substitutes uids into cached
templates instead of rebuilding every geometry tuple.

The port's copy of ``repro.core.cache``, with the cross-flush loop
fusion helpers (``tapes_structurally_equal``, ``tape_io``,
``carried_state_mapping``, ``TapeMatcher``; ``core/loop.py`` uses them)
and the mesh's topology and placement digest in the key.
"""

from __future__ import annotations

import operator
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

from .ir import Op, View

_BY_UID = operator.attrgetter("uid")

# np.dtype -> str is surprisingly hot on large tapes; builtin dtypes are
# singletons, so a tiny id-keyed memo removes the conversions entirely.
_DTYPE_STR: dict = {}


def _dt(dtype) -> str:
    s = _DTYPE_STR.get(id(dtype))
    if s is None:
        s = str(dtype)
        _DTYPE_STR[id(dtype)] = s
        if len(_DTYPE_STR) > 1024:       # paranoia bound; never hit in practice
            _DTYPE_STR.clear()
    return s


def op_struct(op: Op) -> Tuple[Tuple, Tuple[int, ...]]:
    """Memoized per-op structural hashing: the op's renumber-independent
    ``(template, base_uids)`` pair.

    ``template`` captures everything structural about the op — opcode, axis,
    per-view geometry (size/dtype/offset/shape/strides), literal operands,
    and *local* indices into ``base_uids`` wherever a base is referenced —
    while ``base_uids`` is the ordered tuple of base uids those indices
    name (views in program order first, then any new/del/sync-only bases in
    ascending uid order).
    """
    cached = op.__dict__.get("_sig_struct")
    if cached is not None:
        return cached
    local: dict = {}

    def li(uid: int) -> int:
        return local.setdefault(uid, len(local))

    def vk(v: View) -> Tuple:
        return (li(v.base.uid), v.base.size, _dt(v.base.dtype), v.offset,
                v.shape, v.strides)

    # the literal's Python type is structural: an int literal keeps integer
    # arithmetic where a float literal promotes (executor.op_dtypes)
    ins = tuple(vk(v) if isinstance(v, View)
                else ("lit", type(v).__name__, float(v))
                for v in op.inputs)
    out = vk(op.out) if op.out is not None else None
    # Set-carried bases (new/del/sync) get deterministic local indices by
    # ascending uid — frozenset iteration order must never leak into the
    # signature.  Size/dtype ride along for del/sync (the executor's
    # DEL/SYNC bookkeeping is part of a block's observable behaviour).
    new = tuple(li(b.uid) for b in sorted(op.new_bases, key=lambda b: b.uid))
    dels = tuple(li(b.uid) for b in sorted(op.del_bases, key=lambda b: b.uid))
    delsync = tuple((li(b.uid), b.size, _dt(b.dtype)) for b in
                    sorted((*op.del_bases, *op.sync_bases),
                           key=lambda b: b.uid))
    template = (op.opcode, out, ins, op.axis, new, dels, delsync)
    struct = (template, tuple(local))      # dict preserves insertion order
    op.__dict__["_sig_struct"] = struct
    return struct


def block_signature(ops: Sequence[Op]) -> Tuple:
    """Canonical structural key for an op sequence (compiled-executable and
    merge-cache identity): each op's memoized template plus its base uids
    renumbered by first occurrence across the sequence, so loop iterations
    with fresh bases share executables."""
    remap: dict = {}
    sig: List[Tuple] = []
    for op in ops:
        template, bases = op_struct(op)
        sig.append((template,
                    tuple(remap.setdefault(u, len(remap)) for u in bases)))
    return tuple(sig)


def _shard_digest(tape: Sequence[Op]) -> Tuple:
    """Placement of every base on the tape (``dist.spec.placement_digest``).
    Distributed plans are placement-dependent: the comm cost model prices
    shard counts and the resharding pass shapes the tape around them, so two
    structurally-equal tapes with different ShardSpecs must never share a
    cache entry."""
    from .dist.spec import placement_digest   # local: cache loads pre-dist
    return placement_digest(tape)


def tape_signature(tape: Sequence[Op], algorithm: str, cost_model: str,
                   topology: Tuple = (), backends: Tuple = (),
                   cost_token: Tuple = (),
                   partition_backend: str = "greedy") -> Tuple:
    """Canonical merge-cache key.  ``topology`` is the executor's device/mesh
    identity (``dist.mesh.topology_key``): a partition computed under one
    rank count must never be replayed under another once plans become
    placement-dependent.  ``backends`` is the lowering policy's candidate
    list (``LoweringPolicy.key()``): cached entries carry per-block backend
    decisions, which are only valid for the stack that made them.
    ``cost_token`` is the cost model's extra identity beyond its name
    (``cost.model_cache_token``) — the ``calibrated`` model's prices move
    with each installed fit, so its calibration epoch keys the cache too.
    It sits at ``key[2]``, where the plan store's envelope reads it by
    position, so new key components never shift the prefix;
    ``partition_backend`` (greedy vs ilp solver) comes last."""
    return (algorithm, cost_model, tuple(cost_token), tuple(topology),
            tuple(backends), _shard_digest(tape), block_signature(tape),
            partition_backend)


def tapes_structurally_equal(a: Sequence[Op], b: Sequence[Op]) -> bool:
    """Lockstep structural comparison of two tapes modulo base identity —
    equivalent to ``block_signature(a) == block_signature(b)`` but without
    building either signature: the cross-flush recurrence detector calls
    this once per flush, so it compares memoized templates (identity-fast
    for interned tuples, early exit on the first mismatch) and checks that
    the base-uid vectors induce the same first-occurrence renumbering."""
    if len(a) != len(b):
        return False
    fwd: dict = {}
    rev: dict = {}
    for oa, ob in zip(a, b):
        ta, ua = op_struct(oa)
        tb, ub = op_struct(ob)
        if ta is not tb and ta != tb:
            return False
        if len(ua) != len(ub):
            return False
        for x, y in zip(ua, ub):
            if fwd.setdefault(x, y) != y or rev.setdefault(y, x) != x:
                return False
    return True


def tape_io(tape: Sequence[Op]) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                                         Tuple[int, ...]]:
    """Tape-level (inputs, outputs, pre-existing deletes) in canonical
    first-occurrence order — the whole flush viewed as ONE block.

    ``inputs`` are base uids the flush consumes from the store (including
    read-modify-write partial writes), ``outputs`` are bases written here
    that outlive the flush, and ``dels_store`` are pre-existing store bases
    the flush destroys (created-and-deleted temporaries are contracted and
    never touch the store).  This is the *base-identity* half of the
    recurrence split: structure lives in ``block_signature``, carried state
    lives in how consecutive flushes' io uid vectors line up
    (:func:`carried_state_mapping`)."""
    from .executor import block_io            # local: avoid import cycle
    ins, outs, _contracted = block_io(tape)
    new = {b.uid for op in tape for b in op.new_bases}
    dels_store = []
    for op in tape:
        for b in op.del_bases:
            if b.uid not in new:
                dels_store.append(b.uid)
    return tuple(ins), tuple(outs), tuple(dels_store)


def carried_state_mapping(prev_io: Tuple, cur_io: Tuple) -> Optional[Tuple]:
    """The carried-state mapping between two structurally-equal consecutive
    flushes, or ``None`` when no loop-safe mapping exists.

    For each input position ``j`` of the current flush the source is either
    ``("carry", q)`` — the uid equals the previous flush's output at
    canonical position ``q`` (in-place updates map a uid to itself; carried
    chains map a fresh uid to last iteration's) — or ``("inv", j)`` — the
    same untouched store base as last time (a loop-invariant parameter).

    Loop safety additionally requires every previous output to be
    *superseded*: overwritten (same uid among current outputs) or destroyed
    (among the current flush's pre-existing deletes).  Otherwise an
    intermediate iteration's value would have to survive the fused loop,
    which only materializes the final state."""
    p_ins, p_outs, _p_dels = prev_io
    c_ins, c_outs, c_dels = cur_io
    out_pos = {u: q for q, u in enumerate(p_outs)}
    mapping: List[Tuple] = []
    for j, u in enumerate(c_ins):
        q = out_pos.get(u)
        if q is not None:
            mapping.append(("carry", q))
        elif j < len(p_ins) and p_ins[j] == u:
            mapping.append(("inv", j))
        else:
            return None
    superseded = set(c_outs) | set(c_dels)
    for u in p_outs:
        if u not in superseded:
            return None
    return tuple(mapping)


class TapeMatcher:
    """Steady-state fast path for the cross-flush recurrence detector
    (DESIGN.md §16): a matcher compiled once from the armed loop's template
    tape.

    ``match`` decides structural equality against a fresh tape and returns
    its ``tape_io`` uid vectors, several times cheaper than a signature
    pass — which is what makes a deferred flush cost tens of microseconds.
    The walk compares fields directly with two fast exits: ``v is tv``
    (iterative programs reuse the *same* ``View`` objects for loop-invariant
    inputs, so identity certifies geometry for free) and early return on the
    first mismatch.  Base-identity bookkeeping is hoisted OUT of the walk:
    the walk only appends each reference's uid (canonical order per op —
    input views in program order, output, sorted new, sorted del, sorted
    del∪sync), then the first-occurrence renumbering is verified wholesale:
    the template's first-occurrence positions gather the candidate's locals
    table (``map(U.__getitem__, first_pos)``), one ``set`` sizing proves the
    locals distinct, and one list compare pins every repeat position to its
    local's first uid.  A uid sequence passes iff its first-occurrence
    renumbering equals the template's — a finer constraint than
    ``op_struct``'s deduped per-op locals, so a successful match certifies
    ``block_signature`` equality."""

    def __init__(self, tape: Sequence[Op], io: Tuple):
        self.ops: Tuple[Op, ...] = tuple(tape)
        remap: dict = {}
        first_pos: List[int] = []   # walk positions of first occurrences
        rep_pos: List[int] = []     # walk positions of repeats ...
        rep_loc: List[int] = []     # ... and the local each must resolve to
        pos = 0
        by_uid = _BY_UID

        def ref(u: int) -> None:
            nonlocal pos
            got = remap.get(u)
            if got is None:
                remap[u] = len(remap)
                first_pos.append(pos)
            else:
                rep_pos.append(pos)
                rep_loc.append(got)
            pos += 1

        for op in self.ops:
            for v in op.inputs:
                if v.__class__ is View:
                    ref(v.base.uid)
            if op.out is not None:
                ref(op.out.base.uid)
            for b in sorted(op.new_bases, key=by_uid):
                ref(b.uid)
            for b in sorted(op.del_bases, key=by_uid):
                ref(b.uid)
            for b in sorted((*op.del_bases, *op.sync_bases), key=by_uid):
                ref(b.uid)
        self.n_refs = pos
        self.n_locals = len(remap)
        self.first_pos = tuple(first_pos)
        self.rep_pos = tuple(rep_pos)
        self.rep_loc = tuple(rep_loc)
        # template fields pre-pulled into one tuple per op: the match loop
        # unpacks instead of re-reading seven attributes per op
        self.op_info = tuple(
            (op.opcode, op.axis, op.inputs, op.out, op.new_bases,
             op.del_bases, op.sync_bases)
            for op in self.ops)
        ins, outs, dels = io
        self.in_locals = tuple(remap[u] for u in ins)
        self.out_locals = tuple(remap[u] for u in outs)
        self.del_locals = tuple(remap[u] for u in dels)

    def match(self, tape: Sequence[Op]) -> Optional[Tuple]:
        """``tape_io(tape)`` if ``tape`` is structurally equal to the
        template, else ``None``."""
        info = self.op_info
        if len(tape) != len(info):
            return None
        uids: List[int] = []
        uapp = uids.append
        view_cls = View
        by_uid = _BY_UID
        for op, (opcode, axis, tins, tout, tnew, tdel, tsync) in zip(
                tape, info):
            if op.opcode != opcode or op.axis != axis:
                return None
            if len(op.inputs) != len(tins):
                return None
            for v, tv in zip(op.inputs, tins):
                if v is tv:                      # invariant view or literal
                    if v.__class__ is view_cls:
                        uapp(v.base.uid)
                elif v.__class__ is view_cls:
                    if tv.__class__ is not view_cls:
                        return None
                    b = v.base
                    tb = tv.base
                    if (v.offset != tv.offset or v.shape != tv.shape
                            or v.strides != tv.strides or b.size != tb.size
                            or b.dtype != tb.dtype):
                        return None
                    uapp(b.uid)
                elif tv.__class__ is view_cls or v != tv:
                    return None
            v = op.out
            if v is not None:
                if tout is None:
                    return None
                b = v.base
                tb = tout.base
                if (v.offset != tout.offset or v.shape != tout.shape
                        or v.strides != tout.strides or b.size != tb.size
                        or b.dtype != tb.dtype):
                    return None
                uapp(b.uid)
            elif tout is not None:
                return None
            if op.new_bases or tnew:
                if len(op.new_bases) != len(tnew):
                    return None
                if len(op.new_bases) == 1:
                    (b,) = op.new_bases
                    uapp(b.uid)
                else:
                    for b in sorted(op.new_bases, key=by_uid):
                        uapp(b.uid)
            if op.del_bases or tdel or op.sync_bases or tsync:
                if (len(op.del_bases) != len(tdel)
                        or len(op.sync_bases) != len(tsync)):
                    return None
                if len(op.del_bases) == 1 and not op.sync_bases:
                    # singleton DEL fast path: the base is emitted twice
                    # (del walk, then del∪sync walk), no sorts needed
                    (b,) = op.del_bases
                    (tb,) = tdel
                    if b.size != tb.size or b.dtype != tb.dtype:
                        return None
                    u = b.uid
                    uapp(u)
                    uapp(u)
                else:
                    dels = sorted(op.del_bases, key=by_uid)
                    tdels = sorted(tdel, key=by_uid)
                    for b, tb in zip(dels, tdels):
                        if b.size != tb.size or b.dtype != tb.dtype:
                            return None
                        uapp(b.uid)
                    if op.sync_bases:
                        for b, tb in zip(
                                sorted((*op.del_bases, *op.sync_bases),
                                       key=by_uid),
                                sorted((*tdel, *tsync), key=by_uid)):
                            if b.size != tb.size or b.dtype != tb.dtype:
                                return None
                            uapp(b.uid)
                    else:
                        for b in dels:
                            uapp(b.uid)
        if len(uids) != self.n_refs:
            return None
        uget = uids.__getitem__
        uid_of = list(map(uget, self.first_pos))
        if len(set(uid_of)) != self.n_locals:
            return None
        if list(map(uget, self.rep_pos)) != list(
                map(uid_of.__getitem__, self.rep_loc)):
            return None
        lget = uid_of.__getitem__
        return (tuple(map(lget, self.in_locals)),
                tuple(map(lget, self.out_locals)),
                tuple(map(lget, self.del_locals)))


class MergeCache:
    """LRU: a steady mix of hot tapes (training step + eval step + logging
    flush) stays resident even when one-off tapes churn past capacity.

    Values are opaque to the cache; the scheduler stores ``(op_blocks,
    lowering_decisions)`` tuples (immutable nested tuples) so a hit skips
    both the partitioner and backend probing, and loop plans live beside
    them under a ``("loop",) + key`` prefix.  One re-entrant lock
    serializes lookups, insertions and the LRU reorder."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._store: "OrderedDict[Tuple, object]" = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def __contains__(self, key: Tuple) -> bool:
        with self._lock:
            return key in self._store  # no LRU touch, no hit/miss count

    def get(self, key: Tuple):
        with self._lock:
            got = self._store.get(key)
            if got is None:
                self.misses += 1
            else:
                self.hits += 1
                self._store.move_to_end(key)
            return got

    def put(self, key: Tuple, value) -> None:
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
            elif len(self._store) >= self.capacity:
                self._store.popitem(last=False)  # evict least-recently-used
                self.evictions += 1
            self._store[key] = value

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.hits = self.misses = self.evictions = 0
