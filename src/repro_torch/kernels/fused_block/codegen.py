"""Triton kernel generator for WSP partition blocks (the Hopper port of
``repro/kernels/fused_block/codegen.py:build_block_kernel``).

A fused block becomes ONE Triton kernel over the block's common iteration
domain ``D`` (fusion legality guarantees every work op in a block shares
it), canonicalized to a 2-D ``(R, C)`` space: ``C`` is the innermost domain
axis, ``R`` the product of the leading axes; a 1-D domain is folded into
rows of :data:`ONE_D_COLS`.  Contracted arrays (``new ∩ del``) never leave
registers.

**What bounds it.**  Every op the generator accepts is elementwise or a
sum/max/min/prod reduction, far below the H100's operations-per-byte ratio,
so a block's least time is the bytes it must move over the device-memory
rate (3.35e12 B/s): each external input read once, each output written
once.  The design streams each external array exactly once and keeps every
intermediate in registers.

**Design.**

* *Grid and operands.*  One program per ``TR``-row slab of ``(R, C)``;
  inside it a loop over ``C`` in ``BLOCK_C`` chunks (powers of two), with
  masks on the ragged edges.  Every operand is read straight from its base
  buffer through its view's offset and strides — dense slabs, stride-0 row,
  column and scalar broadcasts (column and scalar loads hoisted out of the
  loop) and whole-table gathers — so no operand is copied or padded first.
  ``range`` is the global flat index; ``random`` values are drawn in a
  torch prologue by :mod:`repro_torch.core.prng`, bit-identical to the
  reference's XLA draw.  Window (partial) writes and output dtype casts
  stay in a torch epilogue, as in the reference.
* *Reductions.*  The TPU kernel accumulated across a sequential grid; a
  GPU grid runs in no order.  Trailing-axis reductions finish inside the
  program (in-block reads of reduction outputs are refused by the
  analysis, so nothing needs them earlier).  Full and leading-axis
  reductions write per-program partials, and a second small kernel
  combines them over the programs in a fixed order: no atomics, so the
  result is the same on every run.  Accumulation is in the reduction's
  result dtype (``jnp.sum`` semantics).
* *Numerics.*  Launched with ``enable_fp_fusion=False`` so multiplies and
  adds are not contracted into FMAs the torch floor does not do; float32
  division and square root use the correctly rounded ``div_rn`` /
  ``sqrt_rn``; transcendental functions and ``fmod`` come from libdevice,
  the same routines PyTorch's CUDA kernels call.  Literals reach the kernel
  through a small float64/int64 constant table and are rounded to the
  op's compute dtype in-kernel, as JAX rounds a weakly-typed scalar.

The analysis half (``REASONS``, ``_classify``, ``_analyze``,
``block_lower_reason``) keeps the reference's decline slugs letter for
letter, so the port claims the same blocks.  The one deliberate difference:
the reference also declines a block whose single ``(1, C)`` row exceeds its
VMEM budget (``vmem``); a program here loops over ``C`` and never holds a
whole row, so ``vmem`` remains only for domains past 32-bit indexing.

Beside the kernel sits its plain version (:func:`plain_slots`): the same
plan evaluated with torch ops on whole ``(R_pad, C)`` tensors.  The
wrapper (:class:`FusedBlockKernel`) takes it only for tensors on the CPU;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core import prng
from ...core.executor import (_BINARY, _UNARY, _read, _slice_plan, _write,
                              apply_op, apply_reduce, block_io, numpy_dtype,
                              op_dtypes, reduce_dtype, reduce_identity, take,
                              torch_dtype)
from ...core.ir import COMM_OPS, REDUCTIONS, Op, View

ONE_D_COLS = 1024             # row width when folding a 1-D domain
TILE_ELEMS = 2048             # elements of one (TR, BLOCK_C) tile, at most
MAX_BLOCK_C = 1024            # widest column chunk
NUM_WARPS = 4

#: repo-root build directory (gitignored): generated kernel sources and
#: Triton's compile cache
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"

#: launches of the fused-block kernel (one per wrapper call on a CUDA
#: tensor, whether or not its combine pass runs); reset it to 0 to count
#: the launches of one run
LAUNCHES = {"fused_block": 0}

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
    source: str               # "buffer" | "zeros" | "random"
    base_uid: int = -1
    core: Optional[View] = None      # the view's extent (plain version)
    bcast_dims: Tuple[int, ...] = ()  # broadcast axes (mixed dense case)
    rand_pos: int = -1               # index into the block's random ops
    view: Optional[View] = None      # domain-shaped view the kernel reads


@dataclass(frozen=True)
class _Slot:
    """One kernel output stream."""

    kind: str                 # "dense" | "window" | "red_full" | "red_row" | "red_col"
    dtype: np.dtype
    base_uid: int
    view: Optional[View] = None      # window scatter target


@dataclass
class _Node:
    """One work op, resolved against operands/earlier nodes."""

    opcode: str
    terms: Tuple              # ("lit", x) | ("op", operand_idx) | ("val", node_idx)
    out_dtype: np.dtype
    red_kind: Optional[str] = None   # "full" | "row" | "col"
    out_slot: Optional[int] = None


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
    slots: List[_Slot] = field(default_factory=list)
    nodes: List[_Node] = field(default_factory=list)
    rand_shapes: List[Tuple[Tuple[int, ...], np.dtype]] = field(default_factory=list)
    # output base uid -> ordered write list: ("whole"|"window", slot, view)
    epilogue: Dict[int, List[Tuple[str, int, Optional[View]]]] = field(default_factory=dict)
    inputs: List[int] = field(default_factory=list)
    outputs: List[int] = field(default_factory=list)
    base_meta: Dict[int, Tuple[int, np.dtype]] = field(default_factory=dict)

    @property
    def R_pad(self) -> int:
        return self.G * self.TR

    def live_slots(self) -> List[int]:
        """Slots some output reads (a window of a contracted base is
        computed by the analysis but never stored)."""
        return sorted({s for ws in self.epilogue.values() for _, s, _ in ws})


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
    input_set, output_set = set(inputs), set(outputs)
    plan = _Plan(domain=domain, N=N, R=R, C=C, TR=0, BC=0, G=0,
                 one_d=one_d, inputs=list(inputs), outputs=list(outputs))
    for op in work:
        for v in (*op.in_views(), *op.out_views()):
            plan.base_meta[v.base.uid] = (v.base.size, v.base.dtype)

    op_index: Dict[Tuple, int] = {}
    dense_slot: Dict[int, int] = {}             # output base -> shared slot
    writes: Dict[int, List[Tuple[View, int, bool]]] = {}

    def operand_for(v: View, source: str, rand_pos: int = -1) -> int:
        kind, core, bdims = _classify(v, domain)
        key = (source, v.base.uid if source != "random" else rand_pos,
               v.offset, v.shape, v.strides)
        idx = op_index.get(key)
        if idx is None:
            idx = len(plan.operands)
            plan.operands.append(_Operand(
                key=key, kind=kind, source=source, base_uid=v.base.uid,
                core=core, bcast_dims=bdims, rand_pos=rand_pos, view=v))
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

        if oc == "random":
            rand_pos = len(plan.rand_shapes)
            plan.rand_shapes.append((ov.shape, ov.dtype))
            terms = (("op", operand_for(ov, "random", rand_pos)),)
        elif oc == "range":
            terms = ()
        elif oc in REDUCTIONS:
            terms = (resolve_read(op.in_views()[0]),)
        elif oc == "gather":
            terms = (("op", table_operand_for(op.inputs[0])),
                     resolve_read(op.inputs[1]))
        else:
            # literals pass through unconverted: their Python type decides
            # the promotion (executor.op_dtypes), as in make_block_fn
            terms = tuple(
                resolve_read(t) if isinstance(t, View) else ("lit", t)
                for t in op.inputs)

        node = _Node(opcode=oc, terms=terms, out_dtype=ov.dtype)
        u = ov.base.uid

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
            if u in output_set:
                node.out_slot = len(plan.slots)
                # accumulate in the reduction's result dtype; the epilogue
                # casts once to the output base dtype, like reduce-then-write
                plan.slots.append(_Slot(
                    kind=f"red_{kind}",
                    dtype=reduce_dtype(oc, op.in_views()[0].dtype),
                    base_uid=u))
                plan.epilogue.setdefault(u, []).append(
                    ("whole", node.out_slot, None))
            writes.setdefault(u, []).append((ov, nidx, True))
        else:
            if _whole(ov):
                if u in output_set:
                    slot = dense_slot.get(u)
                    if slot is None:
                        slot = len(plan.slots)
                        plan.slots.append(_Slot(kind="dense", dtype=ov.dtype,
                                                base_uid=u))
                        dense_slot[u] = slot
                    node.out_slot = slot
                    plan.epilogue.setdefault(u, []).append(("whole", slot, None))
            else:
                if any(s == 0 and n > 1 for n, s in zip(ov.shape, ov.strides)) \
                        or not _plannable(ov):
                    raise FusedBlockUnsupported("irregular_view", repr(ov))
                # window write: computed in-kernel, scattered by the epilogue.
                # Slot created even for contracted bases so expressibility
                # stays DEL-insensitive; only live slots are stored.
                node.out_slot = len(plan.slots)
                plan.slots.append(_Slot(kind="window", dtype=ov.dtype,
                                        base_uid=u, view=ov))
                if u in output_set:
                    plan.epilogue.setdefault(u, []).append(
                        ("window", node.out_slot, ov))
            writes.setdefault(u, []).append((ov, nidx, False))
        plan.nodes.append(node)

    # Hopper tiling: a program owns TR rows and loops over C in BC-wide
    # chunks (powers of two, at least 2 and 16 so no tile axis degenerates).
    # Every operand and node value is live in registers across a chunk, so
    # blocks with many of them take smaller tiles rather than spill.
    live = len(plan.operands) + len(plan.nodes)
    tile = TILE_ELEMS if live <= 8 else TILE_ELEMS // 2 if live <= 32 \
        else TILE_ELEMS // 4
    plan.BC = max(16, min(_next_pow2(C), MAX_BLOCK_C))
    plan.TR = max(2, min(_next_pow2(R), tile // plan.BC))
    plan.G = -(-R // plan.TR)
    return plan


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
    out = []
    for o in plan.operands:
        if o.source == "random":
            out.append(np.dtype(plan.rand_shapes[o.rand_pos][1]))
        else:
            out.append(np.dtype(plan.base_meta[o.base_uid][1]))
    return out


def _plain_operand(plan: _Plan, o: _Operand, store, rvals,
                   device) -> torch.Tensor:
    R, C, R_pad = plan.R, plan.C, plan.R_pad
    if o.source == "random":
        core = rvals[o.rand_pos].reshape(-1)[:o.core.size].reshape(o.core.shape)
    elif o.source == "zeros":
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


def plain_slots(plan: _Plan, store: Dict[int, torch.Tensor], rvals,
                device) -> List[Optional[torch.Tensor]]:
    """The kernel's outputs computed with torch ops: one tensor per live
    slot — flat ``(N,)`` for dense/window slots, ``(1,)``, ``(C,)`` or
    ``(R,)`` for full, leading-axis and trailing-axis reductions."""
    R, C, N, R_pad = plan.R, plan.C, plan.N, plan.R_pad
    loaded = [_plain_operand(plan, o, store, rvals, device)
              for o in plan.operands]
    live = set(plan.live_slots())
    slots: List[Optional[torch.Tensor]] = [None] * len(plan.slots)
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
        if node.red_kind is not None:
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
                part = apply_reduce(oc, x, None).reshape(1)
            elif node.red_kind == "row":
                part = apply_reduce(oc, x, 0)
            else:
                part = apply_reduce(oc, x, 1)[:R]
            if node.out_slot in live:
                slots[node.out_slot] = part
            continue
        if oc == "range":
            val = flat_idx
        elif oc == "gather":
            val = take(args[0], torch.broadcast_to(args[1], (R_pad, C)), 0)
        elif oc == "random":
            val = args[0]
        else:
            val = apply_op(oc, args)
        val = torch.broadcast_to(val, (R_pad, C)).to(
            device=device, dtype=torch_dtype(node.out_dtype))
        vals[k] = val
        if node.out_slot in live:
            slots[node.out_slot] = val.reshape(-1)[:N]
    return slots


def epilogue(plan: _Plan, store: Dict[int, torch.Tensor],
             slots: Sequence[Optional[torch.Tensor]], device) -> Tuple:
    """Assemble the block's output buffers from its slots: whole writes and
    reductions cast once to the base dtype, window writes scattered into a
    copy of the base (or of zeros, for a base the block creates)."""
    final = []
    input_set = set(plan.inputs)
    for u in plan.outputs:
        size, dt = plan.base_meta[u]
        cur = (store[u] if u in input_set
               else torch.zeros(size, dtype=torch_dtype(dt), device=device))
        for wkind, slot, view in plan.epilogue.get(u, []):
            raw = slots[slot]
            if wkind == "whole":
                cur = raw[:size].to(torch_dtype(dt))
            else:
                cur = _write(cur, view, raw[:plan.N].reshape(plan.domain))
        final.append(cur)
    return tuple(final)


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
        return f"(-{a})"
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
    args = [src.const(d, cd) if n is None else _cast(n, d, cd)
            for n, d in raw]
    return _elementwise(src, oc, args, cd), rd


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
def _imod_jnp(a, b):
    b = tl.where(b == 0, 1, b)
    t = a % b
    return tl.where(((t < 0) != (b < 0)) & (t != 0), t + b, t)
'''


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


def triton_source(plan: _Plan) -> Tuple[str, List[float], List[int],
                                       List[Tuple]]:
    """The generated module: ``(source, float constants, int constants,
    combines)`` with one ``(kernel name, slot, W, WB, ...)`` entry per
    cross-program reduction.  Everything structural (shapes, strides,
    tiling) is a literal of the source, so one source serves exactly one
    block signature."""
    R, C, N, TR, BC, G = plan.R, plan.C, plan.N, plan.TR, plan.BC, plan.G
    src = _Source()
    params: List[str] = []
    live = set(plan.live_slots())
    dtypes = _operand_dtypes(plan)
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
        # random values arrive compact in the domain's own layout
        view = (o.view if o.source == "buffer"
                else View.contiguous(o.view.base, plan.domain))
        off = view.offset if o.source == "buffer" else 0
        rterm, cs = _address(plan, view)
        name = src.name("x")
        opval[i] = name
        if rterm is None and cs == 0:                     # scalar
            src.pre.append(f"{name} = tl.load({ptr} + {off})")
        elif cs == 0:                                     # column
            src.pre.append(f"{name} = tl.load({ptr} + ({off} + {rterm}), "
                           f"mask=rmask, other=0)")
        elif rterm is None:                               # row
            src.loop.append(f"{name} = tl.load({ptr} + ({off} + cols * {cs})"
                            f", mask=cols < C, other=0)")
        else:                                             # dense
            src.loop.append(f"{name} = tl.load({ptr} + ({off} + {rterm} + "
                            f"cols * {cs}), mask=m, other=0)")

    # -- output slots ----------------------------------------------------
    slot_ptr: Dict[int, str] = {}
    combines: List[Tuple] = []
    for j, s in enumerate(plan.slots):
        if j in live:
            slot_ptr[j] = f"S{j}"
            params.append(slot_ptr[j])

    # -- nodes -----------------------------------------------------------
    vals: Dict[int, Tuple[str, np.dtype]] = {}

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
            if node.out_slot not in live:
                continue                # a dead reduction needs no work
            adt = reduce_dtype(oc, xdt)
            ident = src.const(reduce_identity(oc, adt), adt)
            fn = _combine_fn(oc, adt)
            xv = f"tl.where(m, {_cast(x, xdt, adt)}, {ident})"
            ptr = slot_ptr[node.out_slot]
            if node.red_kind == "row":
                src.loop.append(f"tl.store({ptr} + pid * C + c1, "
                                f"tl.reduce({xv}, 0, {fn}), mask=c1 < C)")
            else:
                acc = src.name("acc")
                src.pre.append(f"{acc} = tl.zeros((TR, BC), {_tl(adt)}) "
                               f"+ {ident}")
                src.loop.append(f"{acc} = {fn}({acc}, {xv})")
                if node.red_kind == "col":
                    src.post.append(f"tl.store({ptr} + r1, tl.reduce({acc}, "
                                    f"1, {fn}), mask=r1 < R)")
                else:
                    src.post.append(f"tl.store({ptr} + pid, tl.reduce("
                                    f"tl.reduce({acc}, 1, {fn}), 0, {fn}))")
            if node.red_kind != "col":
                W = C if node.red_kind == "row" else 1
                combines.append((f"combine{node.out_slot}", node.out_slot,
                                 W, max(16, min(_next_pow2(W), 128)), oc, adt,
                                 ident))
            continue
        if oc == "range":
            expr, rd = "(rows * C + cols)", np.dtype(np.int64)
        elif oc == "random":
            expr, rd = term(node.terms[0], None)
        elif oc == "gather":
            tbl = node.terms[0][1]
            o = plan.operands[tbl]
            tdt = dtypes[tbl]
            n_tbl = o.view.size
            idx, idt = term(node.terms[1], None)
            iv, ok = src.name("i"), src.name("ok")
            src.loop.append(f"{iv} = ({idx}).to(tl.int32).to(tl.int64)")
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
        else:
            expr, rd = _op_expr(src, oc, [
                term(t, None) if t[0] != "lit" else (None, t[1])
                for t in node.terms])
        src.loop.append(f"{name} = {_cast(expr, rd, out)}")
        vals[k] = (name, out)
        if node.out_slot in live:
            src.loop.append(f"tl.store({slot_ptr[node.out_slot]} + "
                            f"(rows * C + cols), {name}, mask=m)")

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
    lines = [
        "import triton",
        "import triton.language as tl",
        "from triton.language.extra import libdevice",
        "",
        *(f"{k} = tl.constexpr({v})" for k, v in
          (("R", R), ("C", C), ("N", N), ("TR", TR), ("BC", BC), ("G", G))),
        _HELPERS,
        "@triton.jit",
        f"def block_kernel({', '.join(params)}):",
        *("    " + line for line in body),
    ]
    for cname, slot, W, WB, oc, adt, _ in combines:
        GB = max(2, 2048 // WB)
        fn = _combine_fn(oc, adt)
        ident = src.const(reduce_identity(oc, adt), adt)
        lines += [
            "", "",
            "@triton.jit",
            f"def {cname}(P, O, KF, KI):",
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
            f"    tl.store(O + c1, tl.reduce(acc, 0, {fn}), mask=cm)",
        ]
    return "\n".join(lines) + "\n", src.kf, src.ki, combines


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------

_MODULES: Dict[str, object] = {}


def _load_module(source: str):
    """Import a generated source from ``build/triton_blocks/`` (Triton
    reads a kernel's source with ``inspect``, so it must live in a file),
    with Triton's compile cache under ``build/triton_cache``."""
    digest = hashlib.sha1(source.encode()).hexdigest()[:16]
    mod = _MODULES.get(digest)
    if mod is not None:
        return mod
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
    _MODULES[digest] = mod
    return mod


class FusedBlockKernel:
    """The executable of one claimed block: ``fn(*input_bufs, salts) ->
    output_bufs`` with the ``make_block_fn`` calling convention.

    Input buffers on the CPU take the plain version; buffers on a CUDA
    device launch the generated kernel (built at first launch) or raise.
    """

    def __init__(self, plan: _Plan, seed: int, device: torch.device):
        self.plan = plan
        self.seed = seed
        self.device = torch.device(device)
        self._gen = None            # (module, consts, combines) once built

    def draw_random(self, salts, device) -> List[torch.Tensor]:
        """The block's ``random`` values (the torch prologue)."""
        return [prng.uniform(self.seed, salts[j], shape, dt, device)
                for j, (shape, dt) in enumerate(self.plan.rand_shapes)]

    def _device_of(self, bufs) -> torch.device:
        devs = {b.device for b in bufs}
        if len(devs) > 1:
            raise ValueError(f"block inputs span devices {devs}")
        return devs.pop() if devs else self.device

    def __call__(self, *bufs_and_salts):
        *bufs, salts = bufs_and_salts
        device = self._device_of(bufs)
        store = dict(zip(self.plan.inputs, bufs))
        rvals = self.draw_random(salts, device)
        if device.type == "cpu":
            slots = plain_slots(self.plan, store, rvals, device)
        elif device.type == "cuda":
            slots = self.launch(store, rvals, device)
        else:
            raise RuntimeError(f"no fused-block kernel for device {device}")
        return epilogue(self.plan, store, slots, device)

    def plain(self, *bufs_and_salts):
        """The plain version on any device — what the kernel is held
        against on the card."""
        *bufs, salts = bufs_and_salts
        device = self._device_of(bufs)
        store = dict(zip(self.plan.inputs, bufs))
        slots = plain_slots(self.plan, store, self.draw_random(salts, device),
                            device)
        return epilogue(self.plan, store, slots, device)

    def launch(self, store: Dict[int, torch.Tensor], rvals,
               device: torch.device) -> List[Optional[torch.Tensor]]:
        """Run the generated kernel (and its combine passes) on CUDA
        tensors; returns the live slots."""
        run, slots = self.prepare(store, rvals, device)
        run()
        LAUNCHES["fused_block"] += 1
        return slots

    def prepare(self, store: Dict[int, torch.Tensor], rvals,
                device: torch.device):
        """Build the kernel if needed, allocate the output slots and bind
        the arguments.  Returns ``(run, slots)``: ``run()`` launches the
        kernel and its combine passes (nothing else) and fills ``slots``."""
        p = self.plan
        if self._gen is None:
            source, kf, ki, combines = triton_source(p)
            consts = (torch.tensor(kf or [0.0], dtype=torch.float64,
                                   device=device),
                      torch.tensor(ki or [0], dtype=torch.int64,
                                   device=device))
            self._gen = (_load_module(source), consts, combines)
        mod, consts, combines = self._gen
        args = []
        for o in p.operands:
            if o.source == "zeros":
                continue
            if o.source == "random":
                args.append(rvals[o.rand_pos].reshape(-1))
            else:
                args.append(store[o.base_uid].contiguous())
        slots: List[Optional[torch.Tensor]] = [None] * len(p.slots)
        partial: Dict[int, torch.Tensor] = {}
        for j in p.live_slots():
            s = p.slots[j]
            dt = torch_dtype(s.dtype)
            if s.kind in ("dense", "window"):
                slots[j] = torch.empty(p.N, dtype=dt, device=device)
            elif s.kind == "red_col":
                slots[j] = torch.empty(p.R, dtype=dt, device=device)
            else:
                W = p.C if s.kind == "red_row" else 1
                partial[j] = torch.empty(p.G * W, dtype=dt, device=device)
                slots[j] = torch.empty(W, dtype=dt, device=device)
            args.append(partial.get(j, slots[j]))
        passes = [(getattr(mod, cname), (-(-W // WB),),
                   (partial[slot], slots[slot]))
                  for cname, slot, W, WB, *_ in combines]

        def run():
            mod.block_kernel[(p.G,)](*args, *consts, num_warps=NUM_WARPS,
                                     enable_fp_fusion=False)
            for fn, grid, bufs in passes:
                fn[grid](*bufs, *consts, num_warps=NUM_WARPS,
                         enable_fp_fusion=False)

        return run, slots


def build_block_kernel(ops: Sequence[Op], *, seed: int = 0,
                       device=torch.device("cpu")):
    """Compile a WSP block into one generated Triton kernel.

    Returns ``(fn, input_uids, output_uids)`` where
    ``fn(*flat_input_bufs, salts) -> tuple(flat_output_bufs)`` mirrors the
    :func:`repro_torch.core.executor.make_block_fn` calling convention
    (``salts`` feeds any ``random`` ops).  Raises
    :class:`FusedBlockUnsupported` (with a ``reason`` slug) for blocks the
    generator cannot express."""
    plan = _analyze(ops)
    return FusedBlockKernel(plan, seed, device), list(plan.inputs), \
        list(plan.outputs)


def block_bytes(plan: _Plan) -> int:
    """Bytes one kernel launch must move at least: each external input
    view's elements read once (at most its whole base), each ``random``
    operand (drawn by the torch prologue into device memory) read once, and
    each live output written once — the numerator of the kernel's bound."""
    reads: Dict[int, Dict[Tuple, int]] = {}
    total = 0
    for o in plan.operands:
        if o.source == "random":
            shape, dt = plan.rand_shapes[o.rand_pos]
            total += math.prod(shape) * np.dtype(dt).itemsize
        elif o.source == "buffer":
            size, dt = plan.base_meta[o.base_uid]
            reads.setdefault(o.base_uid, {})[o.key[2:]] = \
                o.core.size * np.dtype(dt).itemsize
    for u, views in reads.items():
        size, dt = plan.base_meta[u]
        total += min(size * np.dtype(dt).itemsize, sum(views.values()))
    for u, writes in plan.epilogue.items():
        size, dt = plan.base_meta[u]
        n = sum(size if kind == "whole" else view.size
                for kind, _, view in {(k, s, v) for k, s, v in writes})
        total += min(size, n) * np.dtype(dt).itemsize
    return total


#: nodes that only move data: no arithmetic to count
_LOAD_ONLY = {"copy", "random", "gather"}


def block_ops(plan: _Plan) -> Dict[str, int]:
    """Arithmetic operations of one launch by compute type: every node that
    computes (not a load-only ``copy``, ``random`` or ``gather``) is one
    operation per domain element, in the widest type among its operands and
    result (a transcendental function counts as one, so this is a floor)."""
    dts = _operand_dtypes(plan)
    out: Dict[str, int] = {}
    for node in plan.nodes:
        if node.opcode in _LOAD_ONLY:
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
