"""Merge cache (paper §IV-F) and the canonical structural tape signature.

The cache key is a canonical tape signature with base uids renumbered by
first occurrence — two loop iterations that allocate fresh bases but perform
the same operations hash identically (exactly Bohrium's behaviour).  Each op
carries a memoized, renumber-independent *structural template* plus the
ordered base uids it references, so re-hashing a structurally-identical tape
on the warm path (once for the tape-level merge-cache key, then again per
block for the executable-cache signatures) substitutes uids into cached
templates instead of rebuilding every geometry tuple.

The port's copy of ``repro.core.cache`` without the pieces that serve
distributed placement and cross-flush loop fusion, which are not ported
yet: the key has no placement digest, and the loop matcher is absent.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Sequence, Tuple

from .ir import Op, View

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


def tape_signature(tape: Sequence[Op], algorithm: str, cost_model: str,
                   backends: Tuple = (),
                   partition_backend: str = "greedy") -> Tuple:
    """Canonical merge-cache key.  ``backends`` is the lowering policy's
    candidate list (``LoweringPolicy.key()``): cached entries carry
    per-block backend decisions, which are only valid for the stack that
    made them."""
    return (algorithm, cost_model, tuple(backends), block_signature(tape),
            partition_backend)


class MergeCache:
    """LRU: a steady mix of hot tapes (training step + eval step + logging
    flush) stays resident even when one-off tapes churn past capacity.

    Values are opaque to the cache; the scheduler stores ``(op_blocks,
    lowering_decisions)`` tuples (immutable nested tuples) so a hit skips
    both the partitioner and backend probing.  One re-entrant lock
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
