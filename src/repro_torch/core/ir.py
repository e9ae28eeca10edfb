"""Array-bytecode IR — the Bohrium-style instruction stream (paper §III-A).

A *base* array is a contiguous 1-D buffer; a *view* observes part of a base
with (offset, shape, strides) in elements.  Array operations read/write views;
``DEL`` destroys a base, ``SYNC`` materializes it to the host language.  This
module defines the IR only — recording happens in ``repro_torch.core.lazy``
and partitioning in ``repro_torch.core.fusion``.  It is the PyTorch port's
own copy of ``repro.core.ir`` (same classes, same opcode sets), so tapes
translate one to one between the two packages.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from math import gcd
from typing import Optional, Sequence, Tuple

import numpy as np

_base_counter = itertools.count()
_op_counter = itertools.count()


@dataclass(eq=False)
class BaseArray:
    """A contiguous 1-D backing buffer (paper: "base array")."""

    size: int                      # number of elements
    dtype: np.dtype
    name: str = ""

    def __post_init__(self):
        self.uid: int = next(_base_counter)
        self.dtype = np.dtype(self.dtype)
        if not self.name:
            self.name = f"b{self.uid}"
        # Optional distributed placement (``core.dist.ShardSpec``).  None
        # means replicated / single-device; the resharding pass and the
        # ``comm`` cost model read it, the ``shard_map`` backend lowers
        # against it.
        self.shard_spec = None

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def __repr__(self) -> str:
        return f"Base({self.name},{self.size},{self.dtype})"

    def __hash__(self) -> int:
        return self.uid


@dataclass(frozen=True)
class View:
    """A strided window onto a ``BaseArray`` (paper: "array view")."""

    base: BaseArray
    offset: int                    # elements from base[0]
    shape: Tuple[int, ...]
    strides: Tuple[int, ...]       # elements, may be 0 (broadcast) or negative

    # -- constructors -------------------------------------------------
    @staticmethod
    def contiguous(base: BaseArray, shape: Tuple[int, ...], offset: int = 0) -> "View":
        strides, acc = [], 1
        for s in reversed(shape):
            strides.append(acc)
            acc *= s
        return View(base, offset, tuple(shape), tuple(reversed(strides)))

    # -- geometry ------------------------------------------------------
    @property
    def size(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out

    @property
    def nbytes(self) -> int:
        return self.size * self.base.dtype.itemsize

    @property
    def dtype(self) -> np.dtype:
        return self.base.dtype

    @property
    def shard_spec(self):
        """Placement of the observed data (inherited from the base)."""
        return self.base.shard_spec

    def span(self) -> Tuple[int, int]:
        """Smallest/largest element index touched (inclusive/exclusive hi)."""
        lo = hi = self.offset
        for s, st in zip(self.shape, self.strides):
            if s == 0:
                return (self.offset, self.offset)  # empty
            ext = (s - 1) * st
            if ext >= 0:
                hi += ext
            else:
                lo += ext
        return lo, hi + 1

    def is_contiguous(self) -> bool:
        acc = 1
        for s, st in zip(reversed(self.shape), reversed(self.strides)):
            if s != 1 and st != acc:
                return False
            acc *= s
        return True

    # -- the three overlap relations the paper's fusibility needs -----
    def identical(self, other: "View") -> bool:
        return (self.base is other.base and self.offset == other.offset
                and self.shape == other.shape and self.strides == other.strides)

    def disjoint(self, other: "View") -> bool:
        """Conservatively true only when we can PROVE no element is shared."""
        if self.base is not other.base:
            return True
        lo1, hi1 = self.span()
        lo2, hi2 = other.span()
        if hi1 <= lo2 or hi2 <= lo1:
            return True
        # same-stride lattice test: offsets differing by a non-multiple of the
        # common stride gcd can still be disjoint (e.g. A[0::2] vs A[1::2]).
        g = 0
        for st in (*self.strides, *other.strides):
            g = gcd(g, abs(st))
        if g > 1 and (self.offset - other.offset) % g != 0:
            return True
        return False

    def overlaps(self, other: "View") -> bool:
        return not self.disjoint(other)

    def __repr__(self) -> str:
        return f"{self.base.name}[off={self.offset},shape={self.shape}]"


# opcode → arity (excluding output); "reduce_*" sweep an axis.
ELEMENTWISE = {
    "copy": 1, "add": 2, "sub": 2, "mul": 2, "div": 2, "pow": 2,
    "maximum": 2, "minimum": 2, "sqrt": 1, "exp": 1, "log": 1, "abs": 1,
    "neg": 1, "sin": 1, "cos": 1, "erf": 1, "sign": 1, "rsqrt": 1,
    "greater": 2, "less": 2, "where": 3, "tanh": 1, "square": 1,
    "reciprocal": 1, "mod": 2, "floor": 1, "sigmoid": 1,
}
REDUCTIONS = {"reduce_sum", "reduce_max", "reduce_min", "reduce_prod"}
SPECIAL = {"random", "range", "matmul", "gather", "del", "sync", "free"}
# Explicit communication ops (distributed fusion, ``core/dist``).  Value
# semantics: identity copy into a fresh base with a different ShardSpec —
# only the *placement* changes.  The resharding pass injects them wherever
# consecutive ops disagree on placement, so the partitioner prices
# interconnect traffic as ordinary graph nodes; the ``shard_map`` backend
# lowers them to real collectives over a ``DeviceMesh``.
COMM_OPS = {"comm_allgather", "comm_reduce_scatter", "comm_ppermute"}


@dataclass(eq=False)
class Op:
    """One array-bytecode instruction (paper Fig. 2b)."""

    opcode: str
    out: Optional[View]                       # None for DEL/SYNC
    inputs: Tuple = ()                        # Views or python scalars
    axis: Optional[int] = None                # for reductions
    new_bases: frozenset = frozenset()        # bases first-touched here
    del_bases: frozenset = frozenset()        # bases destroyed here
    sync_bases: frozenset = frozenset()
    tag: str = ""                             # debugging label

    def __post_init__(self):
        self.uid: int = next(_op_counter)

    # Def. 10 accessors ------------------------------------------------
    def in_views(self) -> Tuple[View, ...]:
        return tuple(v for v in self.inputs if isinstance(v, View))

    def out_views(self) -> Tuple[View, ...]:
        return (self.out,) if self.out is not None else ()

    @property
    def domain(self) -> Tuple[int, ...]:
        """Iteration domain: Bohrium requires equal length+dimensionality
        for fusion; elementwise ops iterate over their output shape, while a
        reduction iterates over its *input* shape (it sweeps an axis)."""
        if self.opcode in REDUCTIONS:
            return self.in_views()[0].shape
        if self.out is not None:
            return self.out.shape
        return ()

    def is_system(self) -> bool:
        return self.opcode in ("del", "sync", "free")

    def __repr__(self) -> str:
        ins = ",".join(repr(i) for i in self.inputs)
        return f"{self.opcode.upper()}#{self.uid} {self.out!r} <- [{ins}]"


def views_identical_set(views: Sequence[View]) -> list:
    """Deduplicate a sequence of views under ``identical`` (paper counts the
    set of arrays, where "identical arrays" = identical views of one base)."""
    out: list = []
    for v in views:
        if not any(v.identical(u) for u in out):
            out.append(v)
    return out
