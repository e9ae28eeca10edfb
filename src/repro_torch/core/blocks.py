"""Block summaries — the Def. 10 accessors lifted to sets of operations.

A ``BlockInfo`` carries exactly the quantities the paper's cost models need:
``in[B]``, ``out[B]`` (sets of views, deduplicated under *identical*),
``new[B]``, ``del[B]`` (sets of base arrays), and the derived ``ext[B]``
(Def. 10).  Merging two summaries is O(|views|), which is what makes the
incremental ``saving`` computation (Prop. 1) cheap inside the partition
algorithms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

from .ir import Op, View

ViewKey = Tuple[int, int, Tuple[int, ...], Tuple[int, ...]]


def view_key(v: View) -> ViewKey:
    return (v.base.uid, v.offset, v.shape, v.strides)


@dataclass
class BlockInfo:
    """Summary of one partition block (Def. 10 quantities)."""

    ops: List[Op]
    in_map: Dict[ViewKey, View]
    out_map: Dict[ViewKey, View]
    new_bases: FrozenSet[int]          # base uids
    del_bases: FrozenSet[int]
    base_bytes: Dict[int, int]         # base uid -> itemsize (for unit="bytes")
    domain: Optional[Tuple[int, ...]]  # common iteration domain or None (mixed)
    sync_bases: FrozenSet[int] = frozenset()   # bases SYNC forces external

    # ------------------------------------------------------------------
    @staticmethod
    def from_op(op: Op) -> "BlockInfo":
        in_map = {view_key(v): v for v in op.in_views()}
        out_map = {view_key(v): v for v in op.out_views()}
        bb = {v.base.uid: v.base.dtype.itemsize
              for v in (*op.in_views(), *op.out_views())}
        dom = op.domain if not op.is_system() else None
        return BlockInfo(
            ops=[op],
            in_map=in_map,
            out_map=out_map,
            new_bases=frozenset(b.uid for b in op.new_bases),
            del_bases=frozenset(b.uid for b in op.del_bases),
            base_bytes=bb,
            domain=dom,
            sync_bases=frozenset(b.uid for b in op.sync_bases),
        )

    @staticmethod
    def from_ops(ops) -> "BlockInfo":
        """Summary of a whole op sequence (fold of ``from_op``/``merged_with``
        — the shape the lower stage and the tuning profiler both need)."""
        info: Optional[BlockInfo] = None
        for op in ops:
            bi = BlockInfo.from_op(op)
            info = bi if info is None else info.merged_with(bi)
        if info is None:
            raise ValueError("from_ops needs at least one op")
        return info

    def merged_with(self, other: "BlockInfo") -> "BlockInfo":
        """Union of two block summaries (``self`` need not precede ``other``;
        op order is restored by sorting on op uid = program order)."""
        ops = sorted(self.ops + other.ops, key=lambda o: o.uid)
        in_map = dict(self.in_map)
        in_map.update(other.in_map)
        out_map = dict(self.out_map)
        out_map.update(other.out_map)
        bb = dict(self.base_bytes)
        bb.update(other.base_bytes)
        if self.domain is None:
            dom = other.domain
        elif other.domain is None:
            dom = self.domain
        else:
            dom = self.domain if self.domain == other.domain else ()
            # () marks "mixed domains" (never equal to a real domain: real
            # domains of system-free ops are non-empty tuples or scalars).
        return BlockInfo(ops, in_map, out_map,
                         self.new_bases | other.new_bases,
                         self.del_bases | other.del_bases,
                         bb, dom,
                         self.sync_bases | other.sync_bases)

    # -- Def. 10 derived quantities ------------------------------------
    def ext_views(self) -> Tuple[List[View], List[View]]:
        """(read-part, write-part) of ``ext[B]`` — the disjoint union keeps
        the two parts separate so read+write of one view counts twice.
        A SYNC'd base is host-visible and can never become block-internal,
        so its writes always count (Bohrium copies to host before DEL)."""
        dead = self.del_bases - self.sync_bases
        reads = [v for k, v in self.in_map.items() if v.base.uid not in self.new_bases]
        writes = [v for k, v in self.out_map.items() if v.base.uid not in dead]
        return reads, writes

    def ext_size(self, unit: str = "elements") -> int:
        reads, writes = self.ext_views()
        if unit == "elements":
            return sum(v.size for v in reads) + sum(v.size for v in writes)
        return sum(v.nbytes for v in reads) + sum(v.nbytes for v in writes)

    def n_contractions(self) -> int:
        """|new[B] ∩ del[B]| — arrays both allocated and destroyed inside
        (a SYNC'd base is observable and cannot be contracted)."""
        return len((self.new_bases & self.del_bases) - self.sync_bases)

    def accessed_bases(self) -> FrozenSet[int]:
        out = set()
        for v in self.in_map.values():
            out.add(v.base.uid)
        for v in self.out_map.values():
            out.add(v.base.uid)
        return frozenset(out)

    @property
    def op_uids(self) -> FrozenSet[int]:
        return frozenset(o.uid for o in self.ops)
