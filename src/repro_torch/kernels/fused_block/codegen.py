"""Triton kernel generator for WSP partition blocks (the Hopper port of
``repro/kernels/fused_block/codegen.py:build_block_kernel``).

A fused block becomes ONE Triton launch over the block's common iteration
domain ``D`` (fusion legality guarantees every work op in a block shares
it), canonicalized to a 2-D ``(R, C)`` space: ``C`` is the innermost domain
axis, ``R`` the product of the leading axes; a 1-D domain is folded into
rows of :data:`ONE_D_COLS`.  Contracted arrays (``new ∩ del``) never leave
registers.  The launch draws the block's ``random`` values, computes the
block and stores every output straight into its final buffer in the base
dtype, so no torch pass touches a whole array before or after it — apart
from one copy of an output base the launch may not overwrite (below).

**What bounds it.**  Every op the generator accepts is elementwise or a
sum/max/min/prod reduction, far below the H100's operations-per-byte ratio,
so a block's least time is mostly the bytes it must move over the
device-memory rate (3.35e12 B/s): each external input read once, each
output written once.  A drawn value moves no bytes; its threefry hash
(:data:`THREEFRY_OPS` ``uint32`` operations an element) makes a block that
mostly draws bound by operations.  The design streams each external array
exactly once and keeps every intermediate in registers.

**Design.**

* *Grid and operands.*  One program per ``TR``-row slab of ``(R, C)``;
  inside it a loop over ``C`` in ``BLOCK_C`` chunks (powers of two), with
  masks on the ragged edges.  Every operand is read straight from its base
  buffer through its view's offset and strides — dense slabs, stride-0 row,
  column and scalar broadcasts (column and scalar loads hoisted out of the
  loop) and whole-table gathers — so no operand is copied or padded first.
  ``range`` is the global flat index.
* *Random values.*  ``random`` is JAX's threefry2x32 in the kernel, on
  ``tl.uint32``: the counter is the element's flat index in the domain
  (the high word is 0: domains stay inside 32-bit indexing), the key
  words of ``fold_in(PRNGKey(seed), salt)`` are launch arguments
  (:func:`repro_torch.core.prng.key_words`), and the float is assembled
  from the output words' top bits by a bit cast — the steps of
  :func:`repro_torch.core.prng.uniform_at`, so the bits are the
  reference's.  A key word is passed as an int64 at or above 2**32 and
  not specialized, so its Triton type never depends on its value: one
  compiled kernel serves every salt, and a CUDA graph captures the salt
  as a plain argument.  A fused loop body (``core/loop.py``) replays one
  captured iteration many times, so there the key words cannot be launch
  arguments: the kernel's *loop form* takes a ``prng.KeyTable`` in place
  of the salts and loads each draw's two words from ``table + ctr *
  stride`` in the kernel (``ctr`` a device counter the loop advances);
  its threefry and bits are the same.
* *Stores.*  Every write of an output base is stored in the kernel
  through its view's address into the base's output buffer, in the base
  dtype (a reduction's result is cast once from its accumulation dtype).
  A write that a later whole write of the same base covers is not stored;
  one that a later write overlaps otherwise is masked off where that write
  lands, so the result never depends on the order in which programs run.
  The output buffer is the input's own storage when the caller allows it
  (``reuse``: input positions the executor lets the block overwrite) and
  every read of that base from memory is the identical view of each
  write or disjoint from it (``_Plan.in_place``).  Otherwise a base some
  write covers whole gets ``torch.empty``, an input base one copy of
  itself, a base the block creates ``torch.zeros``.  A stencil that reads
  the base it writes at shifted views therefore takes the copy: another
  program could read elements already overwritten.  The source is the
  same either way: reuse only chooses which pointer the launch passes.
* *Reductions.*  The TPU kernel accumulated across a sequential grid; a
  GPU grid runs in no order.  Trailing-axis reductions finish inside the
  program (in-block reads of reduction outputs are refused by the
  analysis, so nothing needs them earlier).  Full and leading-axis
  reductions write per-program partials, and a second small kernel
  combines them over the programs in a fixed order into the output
  buffer: no atomics, so the result is the same on every run.
  Accumulation is in the reduction's result dtype (``jnp.sum``
  semantics).
* *Numerics.*  Launched with ``enable_fp_fusion=False`` so multiplies and
  adds are not contracted into FMAs the torch floor does not do (the
  opt-in contracting form, ``contract_fma``, writes ``tl.fma`` for the
  multiply→add pairs the ``gpu_fma`` cost model counts, and for nothing
  else: the flag stays off on its launch too); float32
  division and square root use the correctly rounded ``div_rn`` /
  ``sqrt_rn``; transcendental functions and ``fmod`` come from libdevice,
  the same routines PyTorch's CUDA kernels call — except a float ``mod``
  by a literal power of two, which is ``x − floor(x·2⁻ᵏ)·2ᵏ`` with fmod's
  result kept on the formula's edge cases (:func:`mod_pow2`): the same
  bits without libdevice's bit-serial float64 ``fmod``.  Literals reach
  the kernel through a small float64/int64 constant table and are rounded
  to the op's compute dtype in-kernel, as JAX rounds a weakly-typed
  scalar.

The analysis half (``REASONS``, ``_classify``, ``_analyze``,
``block_lower_reason``) keeps the reference's decline slugs letter for
letter, so the port claims the same blocks.  The one deliberate difference:
the reference also declines a block whose single ``(1, C)`` row exceeds its
VMEM budget (``vmem``); a program here loops over ``C`` and never holds a
whole row, so ``vmem`` remains only for domains past 32-bit indexing.

Beside the kernel sits its plain version (:func:`plain_outputs`): the same
plan evaluated with torch ops on whole ``(R_pad, C)`` tensors, its writes
applied in program order to the same output buffers, its draws keyed by
salts or, in the loop form, by the same key table.  The wrapper
(:class:`FusedBlockKernel`) takes it only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ...core import prng
from ...core.blocks import view_key
from ...core.device import resolve_device
from ...core.executor import (_BINARY, _UNARY, _read, _slice_plan, _window,
                              apply_op, apply_reduce, block_io, numpy_dtype,
                              op_dtypes, reduce_dtype, reduce_identity, take,
                              torch_dtype)
from ...core.ir import COMM_OPS, REDUCTIONS, Op, View

ONE_D_COLS = 1024             # row width when folding a 1-D domain
TILE_ELEMS = 2048             # elements of one (TR, BLOCK_C) tile, at most
MAX_BLOCK_C = 1024            # widest column chunk
NUM_WARPS = 4
#: uint32 operations of one in-kernel draw, per element: threefry2x32's
#: two key additions, 20 rounds of add, rotate (one funnel shift on the
#: card) and xor, 5 key injections of two additions, and 4 to assemble the
#: float's bits
THREEFRY_OPS = 2 + 20 * 3 + 5 * 2 + 4

#: repo-root build directory (gitignored): generated kernel sources and
#: Triton's compile cache
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"

#: launches of the fused-block kernel (one per wrapper call on a CUDA
#: tensor, whether or not its combine pass runs); reset it to 0 to count
#: the launches of one run
LAUNCHES = {"fused_block": 0}
_COUNT_LOCK = threading.Lock()
#: serializes generating, importing and first compiling a kernel: threads
#: that build the same block at once get one module and one compile
_BUILD_LOCK = threading.RLock()

#: fallback reason slugs (DESIGN.md §13 documents the semantics of each;
#: kept letter for letter from the reference)
REASONS = (
    "system_only",      # no work ops — nothing to compile
    "empty_domain",     # zero-size iteration domain
    "comm",             # COMM op: a placement change, never a compute kernel
    "opcode",           # opaque opcode (matmul, unknown)
    "mixed_domain",     # work ops disagree on the iteration domain
    "irregular_view",   # view is not whole-base / slice-plannable
    "gather_form",      # gather not in the supported 1-D axis-0 whole-table form
    "reduction_axis",   # reduction axis not full/leading/trailing
    "reduction_out",    # reduction output is not a whole contiguous base
    "view_conflict",    # in-block read overlaps a non-identical prior write
    "vmem",             # domain exceeds 32-bit indexing (or, in the
                        # row-replay generator, a row exceeds one program)
    "error",            # defensive: analysis itself failed
)


class FusedBlockUnsupported(Exception):
    """Block not expressible as ONE generated kernel.

    ``reason`` is a stable slug from :data:`REASONS`; the executor exposes
    per-reason counters as ``stats["triton_fallbacks"]``.
    """

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"{reason}: {detail}" if detail else reason)


# ---------------------------------------------------------------------------
# Analysis — pure metadata.  Everything here depends only on the work ops'
# opcodes/domains/views/axes (NOT on DEL/SYNC placement), so the
# expressibility answer is stable under merging system ops into a block —
# the property the cost-model alignment relies on for monotonicity.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Operand:
    """One kernel input stream."""

    key: Tuple
    kind: str                 # "dense" | "row" | "col" | "scalar" | "table"
    source: str               # "buffer" | "zeros"
    base_uid: int = -1
    core: Optional[View] = None      # the view's extent (plain version)
    bcast_dims: Tuple[int, ...] = ()  # broadcast axes (mixed dense case)
    view: Optional[View] = None      # domain-shaped view the kernel reads


@dataclass(frozen=True)
class _Store:
    """One in-kernel store of a node's value into an output base."""

    node: int
    view: View                # the written view (a reduction's: whole)
    masks: Tuple[View, ...] = ()     # later overlapping writes: skip their elements


@dataclass
class _Node:
    """One work op, resolved against operands/earlier nodes."""

    opcode: str
    terms: Tuple              # ("lit", x) | ("op", operand_idx) | ("val", node_idx)
    out_dtype: np.dtype
    red_kind: Optional[str] = None   # "full" | "row" | "col"
    rand_pos: int = -1               # index into the block's random ops


@dataclass
class _Plan:
    domain: Tuple[int, ...]
    N: int
    R: int
    C: int
    TR: int
    BC: int
    G: int
    one_d: bool
    operands: List[_Operand] = field(default_factory=list)
    nodes: List[_Node] = field(default_factory=list)
    rand_shapes: List[Tuple[Tuple[int, ...], np.dtype]] = field(default_factory=list)
    #: output base uid -> its stores, in program order
    stores: Dict[int, List[_Store]] = field(default_factory=dict)
    #: output bases some store covers whole (their buffer needs no contents)
    full: Set[int] = field(default_factory=set)
    #: input output bases whose own storage the kernel may write: every
    #: read of the base from memory is identical to or disjoint from every
    #: store into it, so no program reads what another has stored
    in_place: Set[int] = field(default_factory=set)
    inputs: List[int] = field(default_factory=list)
    outputs: List[int] = field(default_factory=list)
    base_meta: Dict[int, Tuple[int, np.dtype]] = field(default_factory=dict)
    #: the contracting form's pairs: an add node -> (the position of its
    #: term a mul node wrote, that mul node) — :func:`_fma_pairs`
    fma: Dict[int, Tuple[int, int]] = field(default_factory=dict)

    @property
    def R_pad(self) -> int:
        return self.G * self.TR

    def store_list(self) -> List[Tuple[int, _Store]]:
        """``(output position, store)`` of every store — the outputs in
        order, each one's stores in program order: the kernel's ``S{n}``
        pointer arguments, each its output buffer from the view's offset
        on (so no offset is a literal of the source)."""
        return [(j, st) for j, u in enumerate(self.outputs)
                for st in self.stores[u]]

    def stores_by_node(self) -> Dict[int, List[Tuple[int, int, _Store]]]:
        """node index -> ``(store number, output position, store)`` of each
        of its stores."""
        out: Dict[int, List[Tuple[int, int, _Store]]] = {}
        for n, (j, st) in enumerate(self.store_list()):
            out.setdefault(st.node, []).append((n, j, st))
        return out


def _whole(v: View) -> bool:
    return v.offset == 0 and v.size == v.base.size and v.is_contiguous()


def _plannable(v: View) -> bool:
    return _whole(v) or _slice_plan(v) is not None


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _classify(v: View, domain: Tuple[int, ...]):
    """Map a domain-shaped view to (kind, core_view, bcast_dims).

    ``core_view`` is the view's extent without its broadcast axes; ``kind``
    says how it varies over the domain.  Raises for views that would need
    a gather.
    """
    sh, st = v.shape, v.strides
    if len(domain) == 0 or v.size == 1:
        core = View(v.base, v.offset, (1,), (1,))
        return "scalar", core, ()
    bdims = tuple(j for j in range(len(sh)) if st[j] == 0 and sh[j] > 1)
    real = tuple(j for j in range(len(sh)) if sh[j] > 1)
    if not bdims:
        kind, core = "dense", v
    elif len(bdims) == len(real):
        kind, core = "scalar", View(v.base, v.offset, (1,), (1,))
    elif len(sh) >= 2 and set(bdims) == {j for j in real if j < len(sh) - 1}:
        kind, core = "row", View(v.base, v.offset, (sh[-1],), (st[-1],))
    elif len(sh) >= 2 and bdims == (len(sh) - 1,):
        kind, core = "col", View(v.base, v.offset, sh[:-1], st[:-1])
    else:   # partial broadcast over ≥3-D
        keep = tuple(j for j in range(len(sh)) if j not in bdims)
        core = View(v.base, v.offset, tuple(sh[j] for j in keep),
                    tuple(st[j] for j in keep))
        if not _plannable(core):
            raise FusedBlockUnsupported("irregular_view", repr(v))
        return "dense", core, bdims
    if not _plannable(core):
        raise FusedBlockUnsupported("irregular_view", repr(v))
    return kind, core, ()


def _analyze(ops: Sequence[Op]) -> _Plan:
    work = [op for op in ops if not op.is_system()]
    if not work:
        raise FusedBlockUnsupported("system_only")
    for op in work:
        oc = op.opcode
        if oc in COMM_OPS:
            raise FusedBlockUnsupported("comm", oc)
        if (oc not in _UNARY and oc not in _BINARY and oc not in REDUCTIONS
                and oc not in ("where", "random", "range", "gather")):
            raise FusedBlockUnsupported("opcode", oc)
    domain = work[0].domain
    for op in work:
        if op.domain != domain:
            raise FusedBlockUnsupported(
                "mixed_domain", f"{op.domain} vs {domain}")
        ivs = op.in_views()
        if op.opcode == "gather":
            # supported form: 1-D whole-base table, axis 0 (or None), output
            # shaped like the index — the table view is therefore exempt
            # from the domain-shape check
            tv = op.inputs[0] if op.inputs else None
            iv = op.inputs[1] if len(op.inputs) > 1 else None
            axis = op.axis
            if not isinstance(tv, View) or not isinstance(iv, View):
                raise FusedBlockUnsupported("gather_form", "literal operand")
            if axis not in (0, None) or len(tv.shape) != 1:
                raise FusedBlockUnsupported(
                    "gather_form", f"axis={axis} table={tv.shape}")
            if not _whole(tv):
                raise FusedBlockUnsupported(
                    "gather_form", f"partial table view {tv!r}")
            if op.out.shape != iv.shape:
                raise FusedBlockUnsupported(
                    "gather_form", f"out {op.out.shape} vs idx {iv.shape}")
            ivs = tuple(v for v in ivs if v is not tv)
        for v in ivs:
            if v.shape != domain:       # frontend broadcasts; hand tapes may not
                raise FusedBlockUnsupported(
                    "mixed_domain", f"input {v.shape} vs domain {domain}")
    N = math.prod(domain) if domain else 1
    if N == 0:
        raise FusedBlockUnsupported("empty_domain")
    if N >= 2 ** 31:
        raise FusedBlockUnsupported("vmem", "domain exceeds 32-bit indexing")

    one_d = len(domain) == 1
    if len(domain) == 0:
        R, C = 1, 1
    elif one_d:
        C = min(ONE_D_COLS, _next_pow2(N))
        R = -(-N // C)
    else:
        C = domain[-1]
        R = N // C
    inputs, outputs, _contracted = block_io(ops)
    input_set = set(inputs)
    plan = _Plan(domain=domain, N=N, R=R, C=C, TR=0, BC=0, G=0,
                 one_d=one_d, inputs=list(inputs), outputs=list(outputs))
    for op in work:
        for v in (*op.in_views(), *op.out_views()):
            plan.base_meta[v.base.uid] = (v.base.size, v.base.dtype)

    op_index: Dict[Tuple, int] = {}
    # base -> (view, node, is_reduction) of each write, program order
    writes: Dict[int, List[Tuple[View, int, bool]]] = {}

    def operand_for(v: View, source: str) -> int:
        kind, core, bdims = _classify(v, domain)
        key = (source, v.base.uid, v.offset, v.shape, v.strides)
        idx = op_index.get(key)
        if idx is None:
            idx = len(plan.operands)
            plan.operands.append(_Operand(
                key=key, kind=kind, source=source, base_uid=v.base.uid,
                core=core, bcast_dims=bdims, view=v))
            op_index[key] = idx
        return idx

    def table_operand_for(v: View) -> int:
        # the gather's table: read whole, never tiled by the domain, so it
        # bypasses _classify.  Fusion legality guarantees no in-block write
        # overlaps it.
        key = ("table", v.base.uid, v.offset, v.shape, v.strides)
        idx = op_index.get(key)
        if idx is None:
            idx = len(plan.operands)
            source = "buffer" if v.base.uid in input_set else "zeros"
            plan.operands.append(_Operand(
                key=key, kind="table", source=source, base_uid=v.base.uid,
                core=v, view=v))
            op_index[key] = idx
        return idx

    def resolve_read(v: View) -> Tuple:
        u = v.base.uid
        for wview, nidx, is_red in reversed(writes.get(u, [])):
            if wview.identical(v):
                if is_red:
                    raise FusedBlockUnsupported(
                        "view_conflict", "read of in-block reduction output")
                return ("val", nidx)
            if wview.overlaps(v):
                raise FusedBlockUnsupported(
                    "view_conflict", f"read {v!r} overlaps prior write {wview!r}")
        source = "buffer" if u in input_set else "zeros"
        return ("op", operand_for(v, source))

    for op in work:
        oc = op.opcode
        nidx = len(plan.nodes)
        ov = op.out
        node = _Node(opcode=oc, terms=(), out_dtype=ov.dtype)

        if oc == "random":
            node.rand_pos = len(plan.rand_shapes)
            plan.rand_shapes.append((ov.shape, ov.dtype))
        elif oc == "range":
            pass
        elif oc in REDUCTIONS:
            node.terms = (resolve_read(op.in_views()[0]),)
        elif oc == "gather":
            node.terms = (("op", table_operand_for(op.inputs[0])),
                          resolve_read(op.inputs[1]))
        else:
            # literals pass through unconverted: their Python type decides
            # the promotion (executor.op_dtypes), as in make_block_fn
            node.terms = tuple(
                resolve_read(t) if isinstance(t, View) else ("lit", t)
                for t in op.inputs)

        if oc in REDUCTIONS:
            axis = op.axis
            if axis is not None and axis < 0:
                axis += len(domain)
            if len(domain) == 1 and axis in (0, None):
                kind = "full"
            elif len(domain) >= 2 and axis == len(domain) - 1:
                kind = "col"
            elif len(domain) == 2 and axis == 0:
                kind = "row"
            else:
                raise FusedBlockUnsupported(
                    "reduction_axis", f"axis={axis} over domain {domain}")
            if not _whole(ov) or (kind == "col" and ov.shape != domain[:-1]) \
                    or (kind == "row" and ov.shape != domain[1:]) \
                    or (kind == "full" and ov.size != 1):
                raise FusedBlockUnsupported("reduction_out", repr(ov))
            node.red_kind = kind
        elif not _whole(ov):
            if any(s == 0 and n > 1 for n, s in zip(ov.shape, ov.strides)) \
                    or not _plannable(ov):
                raise FusedBlockUnsupported("irregular_view", repr(ov))
        writes.setdefault(ov.base.uid, []).append(
            (ov, nidx, oc in REDUCTIONS))
        plan.nodes.append(node)

    # Stores: a write covered by a later whole write of its base is dead; a
    # later write that overlaps it otherwise masks its elements off, so the
    # last write of each element wins whatever order the programs run in.
    for u in outputs:
        ws = writes[u]
        stores = []
        for i, (view, nidx, _) in enumerate(ws):
            later = [w for w, _, _ in ws[i + 1:]]
            if any(_whole(w) for w in later):
                continue
            stores.append(_Store(nidx, view, tuple(
                w for w in later
                if w.overlaps(view) and not w.identical(view))))
        plan.stores[u] = stores
        if any(_whole(st.view) for st in stores):
            plan.full.add(u)
        if u in input_set and all(
                st.view.disjoint(o.view)
                or (o.kind != "table" and st.view.identical(o.view))
                for o in plan.operands
                if o.source == "buffer" and o.base_uid == u
                for st in stores):
            plan.in_place.add(u)

    plan.fma = _fma_pairs(ops, work, plan)

    # Hopper tiling: a program owns TR rows and loops over C in BC-wide
    # chunks (powers of two, at least 2 and 16 so no tile axis degenerates).
    # Every operand, drawn value and node value is live in registers across
    # a chunk, so blocks with many of them take smaller tiles rather than
    # spill.
    live = len(plan.operands) + len(plan.rand_shapes) + len(plan.nodes)
    tile = TILE_ELEMS if live <= 8 else TILE_ELEMS // 2 if live <= 32 \
        else TILE_ELEMS // 4
    plan.BC = max(16, min(_next_pow2(C), MAX_BLOCK_C))
    plan.TR = max(2, min(_next_pow2(R), tile // plan.BC))
    plan.G = -(-R // plan.TR)
    return plan


def _term_dtype(plan: _Plan, t: Tuple):
    """What ``op_dtypes`` takes for one node term: an operand's or a
    node's dtype, a literal itself."""
    tag, x = t
    if tag == "lit":
        return x
    if tag == "op":
        return np.dtype(plan.base_meta[plan.operands[x].base_uid][1])
    return np.dtype(plan.nodes[x].out_dtype)


def _fma_pairs(ops: Sequence[Op], work: Sequence[Op],
               plan: _Plan) -> Dict[int, Tuple[int, int]]:
    """The multiply→add pairs the contracting form computes as one
    ``tl.fma``: those the ``gpu_fma`` cost model counts (``cost.
    GPUFMACost._fma_pairs``: an ``add`` and the first of its input views
    whose last writer in the block is a ``mul``, at most one an ``add``)
    where the add reads the mul's value in registers and both compute in
    one floating dtype, the mul's result kept in it.  An integer pair the
    model counts is exact either way and stays two operations."""
    writers: Dict[Tuple, str] = {}
    for op in ops:
        if op.out is not None:
            writers[view_key(op.out)] = op.opcode
    pairs: Dict[int, Tuple[int, int]] = {}
    for k, op in enumerate(work):
        if op.opcode != "add":
            continue
        pos = next((i for i, t in enumerate(op.inputs) if isinstance(t, View)
                    and writers.get(view_key(t)) == "mul"), None)
        if pos is None:
            continue
        tag, m = plan.nodes[k].terms[pos]
        if tag != "val" or plan.nodes[m].opcode != "mul":
            continue
        mul = plan.nodes[m]
        cd_m, rd_m = op_dtypes("mul", [_term_dtype(plan, t)
                                       for t in mul.terms])
        cd_a, _ = op_dtypes("add", [_term_dtype(plan, t)
                                    for t in plan.nodes[k].terms])
        if np.dtype(cd_m).kind == "f" and np.dtype(cd_m) == np.dtype(rd_m) \
                == np.dtype(mul.out_dtype) == np.dtype(cd_a):
            pairs[k] = (pos, m)
    return pairs


def block_lower_reason(ops: Sequence[Op]) -> Optional[str]:
    """``None`` when the block lowers through the generator, else the
    fallback reason slug.  Pure analysis — never raises — so cost models
    can call it while pricing candidate merges."""
    try:
        _analyze(ops)
        return None
    except FusedBlockUnsupported as e:
        return e.reason
    except Exception:               # defensive: analysis bug != crash
        return "error"


# ---------------------------------------------------------------------------
# The plain version: the plan on whole (R_pad, C) tensors, torch ops only
# ---------------------------------------------------------------------------

def _operand_dtypes(plan: _Plan) -> List[np.dtype]:
    """Dtype of every operand (by index) as the kernel loads it."""
    return [np.dtype(plan.base_meta[o.base_uid][1]) for o in plan.operands]


def _plain_operand(plan: _Plan, o: _Operand, store, device) -> torch.Tensor:
    R, C, R_pad = plan.R, plan.C, plan.R_pad
    if o.source == "zeros":
        size, dt = plan.base_meta[o.base_uid]
        core = torch.zeros(o.core.size, dtype=torch_dtype(dt),
                           device=device).reshape(o.core.shape)
    else:
        core = _read(store[o.base_uid], o.core)
    if o.kind == "table":
        return core.reshape(-1)
    if o.kind == "scalar":
        return core.reshape(1, 1)
    if o.kind == "row":
        return core.reshape(1, C)

    def pad(flat, n):
        return torch.cat([flat, flat.new_zeros(n - flat.shape[0])])

    if o.kind == "col":
        return pad(core.reshape(-1), R_pad).reshape(R_pad, 1)
    if o.bcast_dims:                        # mixed partial broadcast
        for d in o.bcast_dims:
            core = core.unsqueeze(d)
        core = core.expand(plan.domain)
    return pad(core.reshape(-1), R_pad * C).reshape(R_pad, C)


def _wide(dt: np.dtype) -> np.dtype:
    """The type float math runs in: float16 detours through float32."""
    return np.dtype(np.float32) if np.dtype(dt) == np.float16 else np.dtype(dt)


def _pow2_divisor(oc: str, raw: Sequence[Tuple]
                  ) -> Optional[Tuple[int, np.dtype]]:
    """``(k, compute dtype)`` when ``oc`` is a float ``mod`` of an array by
    a literal that the op's compute dtype holds as ``2**k``, with ``2**k``
    and ``2**-k`` both normal numbers of the type the kernel computes in;
    else ``None`` (the general ``fmod`` path).  ``raw`` holds ``(name,
    dtype)`` for an array term and ``(None, literal)`` for a literal, in
    input order."""
    if oc != "mod" or len(raw) != 2 or raw[0][0] is None \
            or raw[1][0] is not None or isinstance(raw[1][1], bool):
        return None
    cd, _ = op_dtypes("mod", [d for _, d in raw])
    if cd.kind != "f":
        return None
    val = float(np.asarray(float(raw[1][1])).astype(cd))
    if not (val > 0 and math.isfinite(val)):
        return None
    m, e = math.frexp(val)
    emax = np.finfo(_wide(cd)).maxexp - 2          # 1022, 126
    return (e - 1, cd) if m == 0.5 and -emax <= e - 1 <= emax else None


def _mod_pow2_big(dt: np.dtype, k: int) -> float:
    """The least magnitude from which every float of ``dt`` is a multiple
    of ``2**k`` (its unit in the last place reaches ``2**k``)."""
    fi = np.finfo(dt)
    return math.ldexp(1.0, fi.nmant + k) if fi.nmant + k < fi.maxexp \
        else float("inf")


def mod_pow2(x: torch.Tensor, k: int) -> torch.Tensor:
    """``jnp.mod(x, 2.0**k)`` for a float32 or float64 tensor, as the
    kernel computes it: ``x − floor(x·2⁻ᵏ)·2ᵏ`` (every step exact but the
    last subtraction, which rounds the same real number as ``fmod``'s
    ``t + 2ᵏ``), with ``fmod``'s result kept where the formula leaves it:

    * ``x = −0`` and a negative exact multiple of ``2ᵏ``: ``fmod`` gives
      −0, which ``jnp.mod`` keeps; the formula gives +0;
    * a negative subnormal ``x`` whose ``x·2⁻ᵏ`` rounds to −0: the floor
      must be −1, not −0 (so must that of a negative subnormal ``x·2⁻ᵏ``,
      which Triton's float32 ``floor`` flushes to −0: ``q < f`` catches
      it);
    * ``x·2⁻ᵏ`` overflowing (``k < 0``): every ``|x|`` past
      :func:`_mod_pow2_big` is an exact multiple, so its result is ±0.

    ``k`` must keep ``2**k`` and ``2**-k`` normal (:func:`_pow2_divisor`).
    """
    big = _mod_pow2_big(numpy_dtype(x.dtype), k)
    q = x * 2.0 ** -k
    f = torch.floor(q)
    f = torch.where((q < f) | ((x < 0) & (q == 0)), f - 1, f)
    t = x - f * 2.0 ** k
    exact = (t == 0) | ((x.abs() >= big) & (x.abs() < float("inf")))
    return torch.where(exact, x * 0.0, t)


def output_buffers(plan: _Plan, store: Dict[int, torch.Tensor],
                   reuse: FrozenSet[int], device) -> List[torch.Tensor]:
    """The flat buffer each output base is stored into: the input's own
    storage where ``reuse`` (input positions the caller lets the block
    overwrite) allows it and ``plan.in_place`` says no program could read
    what another stored; else new memory — empty when a store covers the
    whole base, one copy of an input base, zeros for a base the block
    creates."""
    pos = {u: k for k, u in enumerate(plan.inputs)}
    outs = []
    for u in plan.outputs:
        size, dt = plan.base_meta[u]
        k = pos.get(u)
        if k is not None and k in reuse and u in plan.in_place \
                and store[u].is_contiguous():
            outs.append(store[u])
        elif u in plan.full:
            outs.append(torch.empty(size, dtype=torch_dtype(dt),
                                    device=device))
        elif k is not None:
            outs.append(store[u].clone())
        else:
            outs.append(torch.zeros(size, dtype=torch_dtype(dt),
                                    device=device))
    return outs


def plain_outputs(plan: _Plan, store: Dict[int, torch.Tensor], seed: int,
                  salts, outs: Sequence[torch.Tensor], device,
                  pairs=None) -> None:
    """The kernel's work with torch ops: every node on whole ``(R_pad, C)``
    tensors (``random`` through :func:`prng.uniform_at` at each element's
    flat index, or, when ``salts`` is a ``prng.KeyTable``, through
    :func:`prng.uniform_bits` under the key words the table holds at its
    counter), then each output base's stores applied in program order to
    its buffer in ``outs`` (from :func:`output_buffers`).  ``pairs``, when
    given, is called as ``pairs(k, a, b, c)`` at each multiply→add pair of
    ``plan.fma`` (the add node ``k``, the mul's terms, the add's other
    term) before the add is evaluated as usual: what the contracting form
    fuses, for a caller that bounds its effect."""
    R, C, N, R_pad = plan.R, plan.C, plan.N, plan.R_pad
    overwritten = {u for u, b in zip(plan.outputs, outs) if store.get(u) is b}
    loaded = []
    for o in plan.operands:
        x = _plain_operand(plan, o, store, device)
        # an operand of a base stored in place keeps the values it read
        loaded.append(x.clone() if o.base_uid in overwritten else x)
    by_node = plan.stores_by_node()
    vals: Dict[int, torch.Tensor] = {}
    flat_idx = torch.arange(R_pad * C, device=device).reshape(R_pad, C)

    def resolve(term):
        tag, x = term
        if tag == "lit":
            return x
        return loaded[x] if tag == "op" else vals[x]

    for k, node in enumerate(plan.nodes):
        oc = node.opcode
        args = [resolve(t) for t in node.terms]
        if pairs is not None and k in plan.fma:
            pos, m = plan.fma[k]
            pairs(k, *(resolve(t) for t in plan.nodes[m].terms),
                  args[1 - pos])
        if node.red_kind is not None:
            if k not in by_node:
                continue                # a reduction no output keeps
            x = torch.broadcast_to(args[0], (R_pad, C))
            dt = reduce_dtype(oc, numpy_dtype(x.dtype))
            if node.red_kind == "full":
                valid = flat_idx < N
            else:
                valid = flat_idx < R * C                # rows < R
            x = torch.where(valid, x.to(torch_dtype(dt)),
                            torch.tensor(reduce_identity(oc, dt),
                                         dtype=torch_dtype(dt), device=device))
            if node.red_kind == "full":
                vals[k] = apply_reduce(oc, x, None).reshape(1)
            elif node.red_kind == "row":
                vals[k] = apply_reduce(oc, x, 0)
            else:
                vals[k] = apply_reduce(oc, x, 1)[:R]
            continue
        raw = [(None, a) if t[0] == "lit" else ("x", numpy_dtype(a.dtype))
               for t, a in zip(node.terms, args)]
        pow2 = _pow2_divisor(oc, raw)
        if oc == "range":
            val = flat_idx
        elif oc == "gather":
            val = take(args[0], torch.broadcast_to(args[1], (R_pad, C)), 0)
        elif oc == "random":
            if isinstance(salts, prng.KeyTable):
                val = prng.uniform_bits(*salts.words(node.rand_pos),
                                        flat_idx, node.out_dtype)
            else:
                val = prng.uniform_at(seed, salts[node.rand_pos], flat_idx,
                                      node.out_dtype)
        elif pow2 is not None and pow2[1] == _wide(pow2[1]):
            k2, cd = pow2
            val = mod_pow2(args[0].to(torch_dtype(cd)), k2)
        else:
            val = apply_op(oc, args)
        vals[k] = torch.broadcast_to(val, (R_pad, C)).to(
            device=device, dtype=torch_dtype(node.out_dtype))
    for u, out in zip(plan.outputs, outs):
        dt = torch_dtype(plan.base_meta[u][1])
        for st in plan.stores[u]:
            val = vals[st.node].to(dt)
            if plan.nodes[st.node].red_kind is None:
                val = val.reshape(-1)[:N]
            if _whole(st.view):
                out.copy_(val.reshape(-1))
            else:
                dims, starts, sizes = _slice_plan(st.view)
                out.view(dims)[_window((dims, starts, sizes))] = \
                    val.reshape(sizes)


# ---------------------------------------------------------------------------
# The Triton source generator
# ---------------------------------------------------------------------------

_TL = {
    "bool": "tl.int1", "int8": "tl.int8", "int16": "tl.int16",
    "int32": "tl.int32", "int64": "tl.int64", "uint8": "tl.uint8",
    "uint16": "tl.uint16", "uint32": "tl.uint32", "uint64": "tl.uint64",
    "float16": "tl.float16", "float32": "tl.float32",
    "float64": "tl.float64",
}
_LIBDEVICE_UNARY = {"exp", "log", "sin", "cos", "erf", "tanh", "rsqrt"}


def _tl(dt) -> str:
    return _TL[np.dtype(dt).name]


def _cast(expr: str, src: np.dtype, dst: np.dtype) -> str:
    return expr if np.dtype(src) == np.dtype(dst) else f"({expr}).to({_tl(dst)})"


class _Source:
    """Accumulates one generated module: the main kernel's prologue, loop
    body and tail, its constant tables and the combine kernels."""

    def __init__(self):
        self.pre: List[str] = []       # before the column loop
        self.loop: List[str] = []      # inside it
        self.post: List[str] = []      # after it
        self.kf: List[float] = []      # float64 constant table
        self.ki: List[int] = []        # int64 constant table
        self._consts: Dict[Tuple, str] = {}
        #: constant name -> the expression loading it from its table
        self.const_expr: Dict[str, str] = {}
        self._n = 0

    def name(self, stem: str) -> str:
        self._n += 1
        return f"{stem}{self._n}"

    def const(self, value, dt: np.dtype) -> str:
        """A scalar of dtype ``dt`` holding ``value`` (loaded once)."""
        dt = np.dtype(dt)
        key = (dt.name, type(value).__name__, repr(value))
        got = self._consts.get(key)
        if got is not None:
            return got
        name = self.name("k")
        if dt.kind == "f":
            self.kf.append(float(value))
            src = f"tl.load(KF + {len(self.kf) - 1})"
            expr = _cast(src, np.dtype(np.float64), dt)
        else:
            self.ki.append(int(value))
            src = f"tl.load(KI + {len(self.ki) - 1})"
            expr = _cast(src, np.dtype(np.int64), dt)
        self.pre.append(f"{name} = {expr}")
        self._consts[key] = name
        self.const_expr[name] = expr
        return name


def _elementwise(src: _Source, oc: str, args: List[str],
                 cd: np.dtype) -> str:
    """Triton expression of one elementwise op on operands already of the
    compute dtype ``cd`` (``jnp`` semantics)."""
    f = cd.kind == "f"
    wide = cd.itemsize >= 4            # float16 math detours through fp32
    a = args[0] if args else None

    def via32(expr_of):
        if not f or wide:
            return expr_of(*args)
        up = [f"({x}).to(tl.float32)" for x in args]
        return f"({expr_of(*up)}).to({_tl(cd)})"

    def div(x, y):
        return f"tl.div_rn({x}, {y})" if cd.itemsize <= 4 else f"({x} / {y})"

    if oc == "copy":
        return a
    if oc in ("add", "sub", "mul"):
        sym = {"add": "+", "sub": "-", "mul": "*"}[oc]
        return f"({args[0]} {sym} {args[1]})"
    if oc == "div":
        return via32(div)
    if oc == "reciprocal":
        return via32(lambda x: div(src.const(1.0, cd), x))
    if oc == "pow":
        if f:
            return via32(lambda x, y: f"libdevice.pow({x}, {y})")
        # integer power through float64 (exact below 2**53)
        return (f"libdevice.pow(({args[0]}).to(tl.float64), "
                f"({args[1]}).to(tl.float64)).to({_tl(cd)})")
    if oc in ("maximum", "minimum"):
        fn = "tl.maximum" if oc == "maximum" else "tl.minimum"
        nan = ", propagate_nan=tl.PropagateNan.ALL" if f else ""
        return f"{fn}({args[0]}, {args[1]}{nan})"
    if oc == "greater":
        return f"({args[0]} > {args[1]})"
    if oc == "less":
        return f"({args[0]} < {args[1]})"
    if oc == "mod":
        helper = "_fmod_jnp" if f else "_imod_jnp"
        return via32(lambda x, y: f"{helper}({x}, {y})")
    if oc == "sqrt":
        return via32(lambda x: f"tl.sqrt_rn({x})" if cd.itemsize <= 4
                     else f"libdevice.sqrt({x})")
    if oc in _LIBDEVICE_UNARY:
        return via32(lambda x: f"libdevice.{oc}({x})")
    if oc == "sigmoid":
        one = src.const(1.0, cd if wide else np.dtype(np.float32))
        return via32(lambda x: div(one, f"({one} + libdevice.exp(-{x}))"))
    if oc == "abs":
        return f"tl.abs({a})"
    if oc == "neg":
        # Triton lowers a float's unary minus to 0 - x, which gives +0 for
        # +0; a product with -1 flips the sign bit of every value, zeros
        # included, as jnp.negative does
        return f"({a} * {src.const(-1.0, cd)})" if f else f"(-{a})"
    if oc == "sign":
        return (f"tl.where({a} > 0, 1, tl.where({a} < 0, -1, {a}))"
                f".to({_tl(cd)})")
    if oc == "square":
        return f"({a} * {a})"
    if oc == "floor":
        return f"tl.floor({a})" if f else a
    raise NotImplementedError(f"opcode {oc!r}")   # _analyze admits no other


def _op_expr(src: _Source, oc: str, raw: List[Tuple]) -> Tuple[str, np.dtype]:
    """Triton expression and result dtype of one elementwise or ``where``
    node; ``raw`` holds ``(name, dtype)`` for each array term and ``(None,
    literal)`` for each literal, in the op's input order."""
    if oc == "where":
        (c, cdt), *rest = raw
        cd, rd = op_dtypes("where", [d for _, d in rest])
        branches = [src.const(d, cd) if n is None else _cast(n, d, cd)
                    for n, d in rest]
        cond = c if np.dtype(cdt) == np.dtype(np.bool_) else f"({c} != 0)"
        return f"tl.where({cond}, {branches[0]}, {branches[1]})", rd
    cd, rd = op_dtypes(oc, [d for _, d in raw])
    pow2 = _pow2_divisor(oc, raw)
    if pow2 is not None:
        # x − floor(x·2⁻ᵏ)·2ᵏ and its edge cases (mod_pow2), in float32
        # for float16 as every float16 op here
        k, w = pow2[0], _wide(cd)
        x = _cast(raw[0][0], raw[0][1], w)
        consts = ", ".join(src.const(v, w) for v in (
            2.0 ** k, 2.0 ** -k, _mod_pow2_big(w, k)))
        return _cast(f"_mod_pow2({x}, {consts})", w, cd), rd
    args = [src.const(d, cd) if n is None else _cast(n, d, cd)
            for n, d in raw]
    return _elementwise(src, oc, args, cd), rd


def _fma_expr(src: _Source, plan: _Plan, k: int,
              raws: List[List[Tuple]]) -> Tuple[str, np.dtype]:
    """``tl.fma`` of add node ``k``'s pair (``plan.fma``): the mul's two
    terms and the add's other term, each as :func:`_op_expr` would pass
    it; ``raws`` holds the mul's and the add's ``raw`` terms."""
    pos, _ = plan.fma[k]
    mul_raw, add_raw = raws
    cd, rd = op_dtypes("add", [d for _, d in add_raw])

    def arg(n, d):
        return src.const(d, cd) if n is None else _cast(n, d, cd)

    a, b = (arg(n, d) for n, d in mul_raw)
    c = arg(*add_raw[1 - pos])
    return f"tl.fma({a}, {b}, {c})", rd


_COMBINE = {"reduce_sum": "_add", "reduce_prod": "_mul"}


def _combine_fn(oc: str, dt: np.dtype) -> str:
    if oc in _COMBINE:
        return _COMBINE[oc]
    kind = "f" if dt.kind == "f" else "i"
    return f"_{kind}{'max' if oc == 'reduce_max' else 'min'}"


_HELPERS = '''
@triton.jit
def _add(a, b):
    return a + b


@triton.jit
def _mul(a, b):
    return a * b


@triton.jit
def _fmax(a, b):
    return tl.maximum(a, b, propagate_nan=tl.PropagateNan.ALL)


@triton.jit
def _fmin(a, b):
    return tl.minimum(a, b, propagate_nan=tl.PropagateNan.ALL)


@triton.jit
def _imax(a, b):
    return tl.maximum(a, b)


@triton.jit
def _imin(a, b):
    return tl.minimum(a, b)


@triton.jit
def _fmod_jnp(a, b):
    t = libdevice.fmod(a, b)
    return tl.where(((t < 0) != (b < 0)) & (t != 0), t + b, t)


@triton.jit
def _mod_pow2(a, b, rb, big):
    # jnp.mod(a, b) for b = 2**k, rb = 2**-k: codegen.mod_pow2's steps
    q = a * rb
    f = tl.floor(q)
    f = tl.where((q < f) | ((a < 0) & (q == 0)), f - 1, f)
    t = a - f * b
    exact = (t == 0) | ((tl.abs(a) >= big) & (tl.abs(a) < float("inf")))
    return tl.where(exact, a * 0.0, t)


@triton.jit
def _imod_jnp(a, b):
    b = tl.where(b == 0, 1, b)
    t = a % b
    return tl.where(((t < 0) != (b < 0)) & (t != 0), t + b, t)
'''


def _threefry_source() -> str:
    """The in-kernel draw's helpers: threefry2x32 on ``uint32`` (20 rounds,
    ``prng._ROTATIONS``; every intermediate unsigned, so ``>>`` is a
    logical shift) and, per float width, ``prng.uniform_at``'s rule from
    the two output words to a float in ``[0, 1)``."""
    ks = ("k1", "k2", "k3")
    body = ["    k3 = k1 ^ k2 ^ 0x1BD11BDA",
            "    x1 = tl.zeros_like(c) + k1",
            "    x2 = c + k2"]
    for i in range(5):
        for r in prng._ROTATIONS[i % 2]:
            body += ["    x1 = x1 + x2",
                     f"    x2 = x1 ^ ((x2 << {r}) | (x2 >> {32 - r}))"]
        body += [f"    x1 = x1 + {ks[(i + 1) % 3]}",
                 f"    x2 = x2 + {ks[(i + 2) % 3]} + {i + 1}"]
    return "\n".join([
        "@triton.jit",
        "def _threefry2x32(k1, k2, c):",
        *body,
        "    return x1, x2",
        "", "",
        "@triton.jit",
        "def _u01_float64(b1, b2):",
        "    bits = ((b1.to(tl.uint64) << 20) | (b2 >> 12).to(tl.uint64)",
        "            | 0x3FF0000000000000)",
        "    return bits.to(tl.float64, bitcast=True) - 1.0",
        "", "",
        "@triton.jit",
        "def _u01_float32(b1, b2):",
        "    bits = ((b1 ^ b2) >> 9) | 0x3F800000",
        "    return bits.to(tl.float32, bitcast=True) - 1.0",
        "", "",
        "@triton.jit",
        "def _u01_float16(b1, b2):",
        "    bits = (((b1 ^ b2) & 0xFFFF) >> 6) | 0x3C00",
        "    f = bits.to(tl.uint16).to(tl.float16, bitcast=True)",
        "    return (f.to(tl.float32) - 1.0).to(tl.float16)",
        ""])


def _address(plan: _Plan, view: View) -> Tuple[Optional[str], int]:
    """In-kernel address of a domain-shaped view as ``(row term, column
    stride)``: element ``(r, c)`` of the canonical domain lives at
    ``offset + row_term(r) + c * column_stride`` (row term ``None`` when
    the view does not vary along rows)."""
    dom = plan.domain
    if not dom:
        return None, 0
    if plan.one_d:
        s = view.strides[0]
        return (f"rows * {plan.C * s}" if s else None), s
    terms = []
    inner = 1
    for d, s in reversed(list(zip(dom[:-1], view.strides[:-1]))):
        if d > 1 and s != 0:
            terms.append(f"((rows // {inner}) % {d}) * {s}")
        inner *= d
    return (" + ".join(reversed(terms)) if terms else None), view.strides[-1]


def _store_address(plan: _Plan, view: View) -> str:
    """Where each domain element of a written view lands, from the view's
    offset, as a whole ``(TR, BC)`` tile (a store's pointer takes its
    mask's shape)."""
    if _whole(view):
        return "(rows * C + cols)"
    rterm, cs = _address(plan, view)
    addr = " + ".join([*([rterm] if rterm else []),
                       *([f"cols * {cs}"] if cs else [])]) or "0"
    return f"({addr})" if rterm and cs \
        else f"tl.broadcast_to({addr}, (TR, BC))"


def _outside(masks: Sequence[View], addr: str) -> str:
    """`` & ~(...)`` terms that keep a store off the elements of each later
    window write in ``masks``: a flat address ``a`` is in a slice-plannable
    view when each of its coordinates in the view's ``dims`` lies in the
    view's window."""
    out = ""
    for v in masks:
        dims, starts, sizes = _slice_plan(v)
        conds, stride = [], 1
        for d, a0, n in reversed(list(zip(dims, starts, sizes))):
            if n < d:
                c = f"(({addr} // {stride}) % {d})"
                conds.append(f"({c} >= {a0}) & ({c} < {a0 + n})")
            stride *= d
        out += f" & ~({' & '.join(conds)})"
    return out


def key_args(seed: int, salts: Sequence[int], n: int) -> List[int]:
    """The launch arguments of ``n`` draws' key words: each as an int64 at
    or above 2**32 (the kernel keeps its low 32 bits), so Triton types it
    the same whatever its value."""
    out = []
    for salt in salts[:n]:
        out += [k | 1 << 32 for k in prng.key_words(seed, salt)]
    return out


def triton_source(plan: _Plan, keyed: bool = False,
                  contract_fma: bool = False
                  ) -> Tuple[str, List[float], List[int], List[Tuple]]:
    """The generated module: ``(source, float constants, int constants,
    combines)`` with one ``(kernel name, node, store number, W, WB,
    accumulation dtype)`` entry per cross-program reduction.  Everything structural (shapes,
    strides, tiling) is a literal of the source, so one source serves
    exactly one block signature — view offsets excepted: every operand
    and store pointer arrives at its view's offset, so blocks that differ
    only in where their windows sit (a decode step's KV-cache write) share
    one compiled kernel.  Parameters: the operand pointers, one pointer
    per store, the reductions' partials, two key words per draw, then the
    constant tables.  ``keyed`` gives the loop form: in place of the key
    words, a pointer to the block's first draw in a key table's row, the
    row stride (``uint32`` words) and a pointer to the iteration counter
    (``prng.KeyTable``); a block without draws has one form.
    ``contract_fma`` gives the contracting form: each pair of
    ``plan.fma`` is one ``tl.fma`` of the mul's operands and the add's
    other term (one rounding where the bitwise form has two); the source
    is otherwise the same, and without pairs identical."""
    R, C, N, TR, BC, G = plan.R, plan.C, plan.N, plan.TR, plan.BC, plan.G
    src = _Source()
    params: List[str] = []
    dtypes = _operand_dtypes(plan)
    by_node = plan.stores_by_node()
    mask_full = "((rows * C + cols) < N)" if plan.one_d \
        else "(rmask & (cols < C))"

    # -- operands: pointers, hoisted loads -----------------------------
    opval: Dict[int, str] = {}
    for i, o in enumerate(plan.operands):
        dt = dtypes[i]
        if o.source == "zeros":
            if o.kind != "table":
                opval[i] = src.name("z")
                src.pre.append(f"{opval[i]} = tl.zeros((1, 1), {_tl(dt)})")
            continue
        ptr = f"A{i}"
        params.append(ptr)
        if o.kind == "table":
            continue
        # the pointer arrives at the view's offset (FusedBlockKernel.prepare)
        rterm, cs = _address(plan, o.view)
        name = src.name("x")
        opval[i] = name
        if rterm is None and cs == 0:                     # scalar
            src.pre.append(f"{name} = tl.load({ptr})")
        elif cs == 0:                                     # column
            src.pre.append(f"{name} = tl.load({ptr} + ({rterm}), "
                           f"mask=rmask, other=0)")
        elif rterm is None:                               # row
            src.loop.append(f"{name} = tl.load({ptr} + (cols * {cs})"
                            f", mask=cols < C, other=0)")
        else:                                             # dense
            src.loop.append(f"{name} = tl.load({ptr} + ({rterm} + "
                            f"cols * {cs}), mask=m, other=0)")

    # -- outputs, partials, key words ------------------------------------
    params += [f"S{n}" for n in range(len(plan.store_list()))]
    partial = [k for k, node in enumerate(plan.nodes)
               if node.red_kind in ("full", "row") and k in by_node]
    params += [f"P{k}" for k in partial]
    keys = []
    if keyed and plan.rand_shapes:
        keys = ["KT", "KS", "CTR"]
        src.pre.append("kt = KT + tl.load(CTR).to(tl.int64) * KS")
        for j in range(len(plan.rand_shapes)):
            src.pre += [f"k{j}a = tl.load(kt + {2 * j})",
                        f"k{j}b = tl.load(kt + {2 * j + 1})"]
    else:
        for j in range(len(plan.rand_shapes)):
            keys += [f"K{j}a", f"K{j}b"]
            src.pre += [f"k{j}a = (K{j}a & 0xFFFFFFFF).to(tl.uint32)",
                        f"k{j}b = (K{j}b & 0xFFFFFFFF).to(tl.uint32)"]
    if keys:
        src.loop.append("ctr = (rows * C + cols).to(tl.uint32)")
    params += keys

    # -- nodes -----------------------------------------------------------
    vals: Dict[int, Tuple[str, np.dtype]] = {}
    combines: List[Tuple] = []

    def term(t, cd: Optional[np.dtype]) -> Tuple[str, object]:
        tag, x = t
        if tag == "lit":
            return src.const(x, cd), x
        if tag == "op":
            return opval[x], dtypes[x]
        return vals[x]

    for k, node in enumerate(plan.nodes):
        oc = node.opcode
        out = node.out_dtype
        name = src.name("v")
        if node.red_kind is not None:
            x, xdt = term(node.terms[0], None)
            if k not in by_node:
                continue                # a reduction no output keeps
            (n, j, st), = by_node[k]
            base_dt = plan.base_meta[plan.outputs[j]][1]
            adt = reduce_dtype(oc, xdt)
            ident = src.const(reduce_identity(oc, adt), adt)
            fn = _combine_fn(oc, adt)
            xv = f"tl.where(m, {_cast(x, xdt, adt)}, {ident})"
            if node.red_kind == "row":
                src.loop.append(f"tl.store(P{k} + pid * C + c1, "
                                f"tl.reduce({xv}, 0, {fn}), mask=c1 < C)")
            else:
                acc = src.name("acc")
                src.pre.append(f"{acc} = tl.zeros((TR, BC), {_tl(adt)}) "
                               f"+ {ident}")
                src.loop.append(f"{acc} = {fn}({acc}, {xv})")
                if node.red_kind == "col":
                    res = _cast(f"tl.reduce({acc}, 1, {fn})", adt, base_dt)
                    src.post.append(f"tl.store(S{n} + r1, {res}, mask=r1 < R"
                                    f"{_outside(st.masks, 'r1')})")
                else:
                    src.post.append(f"tl.store(P{k} + pid, tl.reduce("
                                    f"tl.reduce({acc}, 1, {fn}), 0, {fn}))")
            if node.red_kind != "col":
                W = C if node.red_kind == "row" else 1
                WB = max(16, min(_next_pow2(W), 128))
                GB = max(2, 2048 // WB)
                res = _cast(f"tl.reduce(acc, 0, {fn})", adt, base_dt)
                combines.append((f"combine{k}", k, n, W, WB, adt, [
                    "", "",
                    "@triton.jit",
                    f"def combine{k}(P, O, KF, KI):",
                    "    pid = tl.program_id(0)",
                    f"    c1 = pid * {WB} + tl.arange(0, {WB}).to(tl.int64)",
                    f"    cm = c1 < {W}",
                    f"    {ident} = {src.const_expr[ident]}",
                    f"    acc = tl.zeros(({GB}, {WB}), {_tl(adt)}) + {ident}",
                    f"    for g0 in range(0, G, {GB}):",
                    f"        g1 = g0 + tl.arange(0, {GB}).to(tl.int64)",
                    "        msk = (g1[:, None] < G) & cm[None, :]",
                    f"        x = tl.load(P + g1[:, None] * {W} + c1[None, :], "
                    "mask=msk, other=0)",
                    f"        acc = {fn}(acc, tl.where(msk, x, {ident}))",
                    f"    tl.store(O + c1, {res}, mask=cm"
                    f"{_outside(st.masks, 'c1')})"]))
            continue
        if oc == "range":
            expr, rd = "(rows * C + cols)", np.dtype(np.int64)
        elif oc == "random":
            j = node.rand_pos
            bits = src.name("b")
            src.loop.append(f"{bits}a, {bits}b = _threefry2x32(k{j}a, k{j}b, "
                            f"ctr)")
            expr = f"_u01_{np.dtype(out).name}({bits}a, {bits}b)"
            rd = out
        elif oc == "gather":
            tbl = node.terms[0][1]
            o = plan.operands[tbl]
            tdt = dtypes[tbl]
            n_tbl = o.view.size
            idx, idt = term(node.terms[1], None)
            iv, ok = src.name("i"), src.name("ok")
            # an index computed from literals alone is a scalar, and a
            # load's mask must not be a block over a scalar pointer: the
            # select against ``m`` gives the index the domain's shape
            src.loop.append(f"{iv} = tl.where(m, ({idx}).to(tl.int32)"
                            f".to(tl.int64), 0)")
            src.loop.append(f"{iv} = tl.where({iv} < 0, {iv} + {n_tbl}, {iv})")
            src.loop.append(f"{ok} = ({iv} >= 0) & ({iv} < {n_tbl})")
            fill = (float("nan") if tdt.kind == "f" else True
                    if tdt.kind == "b" else int(np.iinfo(tdt).min))
            fill = src.const(fill, tdt)
            if o.source == "zeros":
                got = f"tl.zeros((1, 1), {_tl(tdt)})"
            else:
                got = f"tl.load(A{tbl} + {iv}, mask={ok} & m, other=0)"
            expr, rd = f"tl.where({ok}, {got}, {fill})", tdt
        elif contract_fma and k in plan.fma:
            expr, rd = _fma_expr(src, plan, k, [
                [term(t, None) if t[0] != "lit" else (None, t[1])
                 for t in plan.nodes[n].terms]
                for n in (plan.fma[k][1], k)])
        else:
            expr, rd = _op_expr(src, oc, [
                term(t, None) if t[0] != "lit" else (None, t[1])
                for t in node.terms])
        src.loop.append(f"{name} = {_cast(expr, rd, out)}")
        vals[k] = (name, out)
        for n, _, st in by_node.get(k, ()):
            addr = src.name("a")
            src.loop.append(f"{addr} = {_store_address(plan, st.view)}")
            src.loop.append(f"tl.store(S{n} + {addr}, {name}, mask=m"
                            f"{_outside(st.masks, f'({addr} + {st.view.offset})')})")

    params += ["KF", "KI"]
    body = [
        "pid = tl.program_id(0)",
        "r1 = pid * TR + tl.arange(0, TR).to(tl.int64)",
        "rows = r1[:, None]",
        "rmask = rows < R",
        *src.pre,
        "for c0 in range(0, C, BC):",
        "    c1 = c0 + tl.arange(0, BC).to(tl.int64)",
        "    cols = c1[None, :]",
        f"    m = {mask_full}",
        *("    " + line for line in src.loop),
        *src.post,
    ]
    # key words (or the key table's stride) are not specialized (on ==1 or
    # divisibility by 16): one compiled kernel serves every salt
    nospec = ["KS"] if "KS" in keys else keys
    jit = (f"@triton.jit(do_not_specialize={nospec!r})" if keys
           else "@triton.jit")
    lines = [
        "import triton",
        "import triton.language as tl",
        "from triton.language.extra import libdevice",
        "",
        *(f"{k} = tl.constexpr({v})" for k, v in
          (("R", R), ("C", C), ("N", N), ("TR", TR), ("BC", BC), ("G", G))),
        _HELPERS,
        *([_threefry_source()] if keys else []),
        jit,
        f"def block_kernel({', '.join(params)}):",
        *("    " + line for line in body),
    ]
    for *_, combine_lines in combines:
        lines += combine_lines
    return ("\n".join(lines) + "\n", src.kf, src.ki,
            [c[:6] for c in combines])


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------

_MODULES: Dict[str, object] = {}


def _load_module(source: str):
    """Import a generated source from ``build/triton_blocks/`` (Triton
    reads a kernel's source with ``inspect``, so it must live in a file),
    with Triton's compile cache under ``build/triton_cache``."""
    digest = hashlib.sha1(source.encode()).hexdigest()[:16]
    with _BUILD_LOCK:
        mod = _MODULES.get(digest)
        if mod is None:
            mod = _MODULES[digest] = _import_source(source, digest)
    return mod


def _import_source(source: str, digest: str):
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton_cache"))
    path = BUILD_DIR / "triton_blocks" / f"blk_{digest}.py"
    path.parent.mkdir(parents=True, exist_ok=True)
    if not path.exists() or path.read_text() != source:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(f"_fused_blk_{digest}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FusedBlockKernel:
    """The executable of one claimed block: ``fn(*input_bufs, salts,
    reuse=frozenset()) -> output_bufs`` with the ``make_block_fn`` calling
    convention.  ``reuse`` holds the input positions whose buffers the call
    may overwrite (the executor's grant); by default it overwrites none.
    ``salts`` may be a ``prng.KeyTable`` (a fused loop body): the call then
    runs the kernel's loop form, which reads its key words on the device.

    Input buffers on the CPU take the plain version; buffers on a CUDA
    device launch the generated kernel (each form built at its first
    launch) or raise.  With ``contract_fma`` the kernel is the
    contracting form (:func:`triton_source`); its plain version stays the
    bitwise one, so on the CPU a contracting block's result differs from
    the card's by at most one rounding a contracted pair.
    """

    def __init__(self, plan: _Plan, seed: int, device: torch.device,
                 contract_fma: bool = False):
        self.plan = plan
        self.seed = seed
        self.device = torch.device(device)
        self.contract_fma = contract_fma
        #: keyed (loop form) -> (module, consts, combines) once built
        self._gen: Dict[bool, Tuple] = {}
        #: the forms launched once (compiled by Triton)
        self._launched: Set[bool] = set()

    def _device_of(self, bufs) -> torch.device:
        devs = {b.device for b in bufs}
        if len(devs) > 1:
            raise ValueError(f"block inputs span devices {devs}")
        return devs.pop() if devs else self.device

    def __call__(self, *bufs_and_salts, reuse: FrozenSet[int] = frozenset()):
        *bufs, salts = bufs_and_salts
        device = self._device_of(bufs)
        store = dict(zip(self.plan.inputs, bufs))
        if device.type == "cpu":
            return self._plain(store, salts, device, reuse)
        if device.type == "cuda":
            return self.launch(store, salts, device, reuse)
        raise RuntimeError(f"no fused-block kernel for device {device}")

    def plain(self, *bufs_and_salts, reuse: FrozenSet[int] = frozenset(),
              pairs=None):
        """The plain version on any device — what the kernel is held
        against on the card (``pairs``: :func:`plain_outputs`')."""
        *bufs, salts = bufs_and_salts
        device = self._device_of(bufs)
        return self._plain(dict(zip(self.plan.inputs, bufs)), salts, device,
                           reuse, pairs)

    def _plain(self, store, salts, device, reuse, pairs=None) -> Tuple:
        outs = output_buffers(self.plan, store, reuse, device)
        plain_outputs(self.plan, store, self.seed, salts, outs, device,
                      pairs)
        return tuple(outs)

    def launch(self, store: Dict[int, torch.Tensor], salts,
               device: torch.device,
               reuse: FrozenSet[int] = frozenset()) -> Tuple:
        """Run the generated kernel (and its combine passes) on CUDA
        tensors; returns the output buffers."""
        run, outs = self.prepare(store, salts, device, reuse)
        keyed = isinstance(salts, prng.KeyTable) and bool(self.plan.rand_shapes)
        if keyed in self._launched:
            run()
        else:
            with _BUILD_LOCK:        # Triton compiles at the first launch
                run()
                self._launched.add(keyed)
        with _COUNT_LOCK:
            LAUNCHES["fused_block"] += 1
        return tuple(outs)

    def prepare(self, store: Dict[int, torch.Tensor], salts,
                device: torch.device, reuse: FrozenSet[int] = frozenset()):
        """Build the kernel if needed, make the output buffers
        (:func:`output_buffers`) and bind the arguments.  Returns ``(run,
        outs)``: ``run()`` launches the kernel and its combine passes
        (nothing else) and fills ``outs``."""
        p = self.plan
        keyed = isinstance(salts, prng.KeyTable) and bool(p.rand_shapes)
        gen = self._gen.get(keyed)
        if gen is None:
            with _BUILD_LOCK:
                gen = self._gen.get(keyed)
                if gen is None:
                    source, kf, ki, combines = triton_source(
                        p, keyed, self.contract_fma)
                    consts = (torch.tensor(kf or [0.0], dtype=torch.float64,
                                           device=device),
                              torch.tensor(ki or [0], dtype=torch.int64,
                                           device=device))
                    gen = self._gen[keyed] = (_load_module(source), consts,
                                              combines)
        mod, consts, combines = gen
        args = [store[o.base_uid].contiguous()[o.view.offset:]
                for o in p.operands if o.source == "buffer"]
        outs = output_buffers(p, store, reuse, device)
        ptrs = [outs[j][st.view.offset:] for j, st in p.store_list()]
        partials = [torch.empty(p.G * W, dtype=torch_dtype(adt),
                                device=device)
                    for _, _, _, W, _, adt in combines]
        if keyed:
            keys = [salts.table.view(-1)[2 * salts.off:], salts.stride,
                    salts.ctr]
        elif isinstance(salts, prng.KeyTable):
            keys = []
        else:
            keys = key_args(self.seed, salts, len(p.rand_shapes))
        passes = [(getattr(mod, cname), (-(-W // WB),), (part, ptrs[n]))
                  for (cname, _, n, W, WB, _), part in zip(combines, partials)]

        def run():
            mod.block_kernel[(p.G,)](*args, *ptrs, *partials, *keys, *consts,
                                     num_warps=NUM_WARPS,
                                     enable_fp_fusion=False)
            for fn, grid, bufs in passes:
                fn[grid](*bufs, *consts, num_warps=NUM_WARPS,
                         enable_fp_fusion=False)

        return run, outs


def build_block_kernel(ops: Sequence[Op], *, seed: int = 0, device=None,
                       contract_fma: bool = False):
    """Compile a WSP block into one generated Triton kernel.

    Returns ``(fn, input_uids, output_uids)`` where
    ``fn(*flat_input_bufs, salts, reuse=frozenset()) ->
    tuple(flat_output_bufs)`` mirrors the
    :func:`repro_torch.core.executor.make_block_fn` calling convention
    (``salts`` feeds any ``random`` ops; ``reuse`` names the input
    positions the call may overwrite).  ``device`` is the CUDA card unless
    given.  ``contract_fma`` builds the contracting form, each pair of
    ``plan.fma`` one fused multiply-add on the card (the ``gpu_fma`` cost
    model's form; off, the kernel is bitwise with the torch floor).
    Raises :class:`FusedBlockUnsupported` (with a
    ``reason`` slug) for blocks the generator cannot express."""
    device = resolve_device(device)
    plan = _analyze(ops)
    return FusedBlockKernel(plan, seed, device, contract_fma), \
        list(plan.inputs), list(plan.outputs)


def block_bytes(plan: _Plan) -> int:
    """Bytes one kernel launch must move at least: each external input
    view's elements read once (at most its whole base) and each output
    base's stored elements written once (at most the whole base) — the
    numerator of the kernel's bound.  Drawn values are computed in
    registers and move none."""
    reads: Dict[int, Dict[Tuple, int]] = {}
    for o in plan.operands:
        if o.source == "buffer":
            size, dt = plan.base_meta[o.base_uid]
            reads.setdefault(o.base_uid, {})[o.key[2:]] = \
                o.core.size * np.dtype(dt).itemsize
    total = 0
    for u, views in reads.items():
        size, dt = plan.base_meta[u]
        total += min(size * np.dtype(dt).itemsize, sum(views.values()))
    for u, stores in plan.stores.items():
        size, dt = plan.base_meta[u]
        n = sum(size if _whole(v) else v.size for v in
                {st.view for st in stores})
        total += min(size, n) * np.dtype(dt).itemsize
    return total


#: nodes that only move data: no arithmetic to count
_LOAD_ONLY = {"copy", "gather"}


def block_ops(plan: _Plan) -> Dict[str, int]:
    """Arithmetic operations of one launch by compute type: a ``random``
    node is :data:`THREEFRY_OPS` ``uint32`` operations per domain element;
    every other node that computes (not a load-only ``copy`` or
    ``gather``) is one operation per domain element, in the widest type
    among its operands and result (a transcendental function counts as
    one, so this is a floor)."""
    dts = _operand_dtypes(plan)
    out: Dict[str, int] = {}
    for node in plan.nodes:
        if node.opcode in _LOAD_ONLY:
            continue
        if node.opcode == "random":
            out["uint32"] = out.get("uint32", 0) + THREEFRY_OPS * plan.N
            continue
        types = [np.dtype(node.out_dtype)]
        for kind, x in node.terms:
            if kind == "op":
                types.append(dts[x])
            elif kind == "val":
                types.append(np.dtype(plan.nodes[x].out_dtype))
        name = np.result_type(*types).name
        out[name] = out.get(name, 0) + plan.N
    return out
