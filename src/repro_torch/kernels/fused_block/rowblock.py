"""Triton generator for row-replay blocks — kernel B2, the Hopper port of
``repro/kernels/fused_block/rowblock.py:build_rowblock_kernel``.

The fused-block generator (``codegen.py``, kernel B1) refuses a block that
READS an in-block reduction output (``view_conflict``).  The LM blocks the
hand-written-kernel claimants exist for — masked softmax, rmsnorm,
exponential scans — are trailing-axis reductions whose results other ops of
the same block consume (``exp(x - max)``, ``x * rsqrt(mean)``).  This
generator expresses exactly that shape: a **trailing-axis** reduction over
a 2-D+ domain, consumed at domain shape through a stride-0 broadcast of the
reduced value (the ``r.reshape(..., 1).broadcast_to(domain)`` form the lazy
front-end records).  It backs all three LM claimants
(``core/backends/lm.py``).

**What bounds it.**  Every op is elementwise or a row reduction, far below
the H100's operations-per-byte ratio, so a block's least time is its bytes
over the device-memory rate (3.35e12 B/s): each external input read once,
each output written once.  The design reads each input once and keeps
every intermediate, the reduced row values included, in registers.

**Design.**

* *Whole rows per program.*  The domain is canonicalized to ``(R, C)``
  with ``C`` its innermost axis.  One program owns ``TR`` rows and holds
  each of them whole in one ``(TR, BC)`` tile, ``BC = next_pow2(C)``, so
  every reduction finishes inside its program: no combine pass, no
  atomics, and the same bits on every run by construction.  A reduced
  value is the ``(TR, 1)`` column the tile's later ops broadcast against.
* *Padding.*  Padded columns enter a reduction as its identity (``-inf``
  for max, ``0`` for sum, ``+inf`` for min, ``1`` for prod); padded rows
  compute garbage that the masked stores drop.
* *Operands* are read straight from their base buffers through each view's
  offset and strides — dense tiles, stride-0 rows, columns (the broadcast
  variance of an rmsnorm) and scalars, and the ``(1, 1, s, t)`` causal
  mask broadcast over batch and heads — so nothing is copied or padded
  first (the TPU kernel materialized and padded every operand).  A
  ``bool`` operand is passed as its bytes (``uint8``) and tested ``!= 0``.
* *Column cap.*  A row wider than :data:`MAX_ROW` columns would not fit one
  program's registers; such a block declines with ``vmem``, as the TPU
  kernel declines past its VMEM budget.  The LM rows (2560 model columns,
  at most ``max_seq`` score columns) are far below it.
* *Numerics* are B1's: ``enable_fp_fusion=False``, ``div_rn``/``sqrt_rn``
  and libdevice, the same expressions (``codegen._op_expr``).  Elementwise
  results match the torch floor bit for bit; a ``reduce_sum`` is a Triton
  tree sum, so it matches the floor's ``sum(-1)`` only where the row sums
  are exact.

The analysis (:func:`_analyze`, :func:`rowblock_lower_reason`) keeps the
reference's decline slugs letter for letter, so the port claims the same
blocks.  Beside the kernel sits its plain version (:func:`plain_slots`): the
plan evaluated with the torch floor's own ops at domain shape.  The wrapper
(:class:`RowBlockKernel`) takes it only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.executor import (_BINARY, _UNARY, _read, apply_op, apply_reduce,
                              block_io, reduce_dtype, reduce_identity,
                              torch_dtype)
from ...core.ir import COMM_OPS, REDUCTIONS, Op, View
from .codegen import (_HELPERS, FusedBlockUnsupported, _address, _cast,
                      _classify, _combine_fn, _load_module, _next_pow2,
                      _Operand, _op_expr, _Source, _tl, _whole)

MAX_ROW = 16384               # widest padded row one program holds
TILE_ELEMS = 4096             # target elements of one (TR, BC) tile

#: launches of the row-replay kernel (one per wrapper call on a CUDA
#: tensor); reset it to 0 to count the launches of one run
LAUNCHES = {"rowblock": 0}


@dataclass
class _Node:
    """One work op, resolved against operands / earlier nodes."""

    opcode: str
    # ("lit", x) | ("op", operand_idx) | ("val", node_idx) | ("red", node_idx)
    terms: Tuple
    out_dtype: np.dtype
    is_red: bool = False
    out_slot: Optional[int] = None


@dataclass
class _RowPlan:
    domain: Tuple[int, ...]
    N: int
    R: int
    C: int
    TR: int = 1
    BC: int = 1
    G: int = 1
    num_warps: int = 4
    operands: List[_Operand] = field(default_factory=list)
    # (kind, dtype, base_uid): kind "dense" (N values) or "red" (R values)
    slots: List[Tuple[str, np.dtype, int]] = field(default_factory=list)
    nodes: List[_Node] = field(default_factory=list)
    inputs: List[int] = field(default_factory=list)
    outputs: List[int] = field(default_factory=list)
    base_meta: Dict[int, Tuple[int, np.dtype]] = field(default_factory=dict)
    one_d = False                 # codegen._address reads it: never 1-D here


def _analyze(ops: Sequence[Op]) -> _RowPlan:
    work = [op for op in ops if not op.is_system()]
    if not work:
        raise FusedBlockUnsupported("system_only")
    for op in work:
        oc = op.opcode
        if oc in COMM_OPS:
            raise FusedBlockUnsupported("comm", oc)
        if (oc not in _UNARY and oc not in _BINARY
                and oc not in REDUCTIONS and oc != "where"):
            raise FusedBlockUnsupported("opcode", oc)
    domain = work[0].domain
    if len(domain) < 2:
        raise FusedBlockUnsupported(
            "reduction_axis", f"row codegen needs a 2-D+ domain, got {domain}")
    for op in work:
        if op.domain != domain:
            raise FusedBlockUnsupported(
                "mixed_domain", f"{op.domain} vs {domain}")
        for v in op.in_views():
            if v.shape != domain:
                raise FusedBlockUnsupported(
                    "mixed_domain", f"input {v.shape} vs domain {domain}")
    N = math.prod(domain)
    if N == 0:
        raise FusedBlockUnsupported("empty_domain")
    if N >= 2 ** 31:
        raise FusedBlockUnsupported("vmem", "domain exceeds 32-bit indexing")
    C = domain[-1]
    R = N // C

    inputs, outputs, _ = block_io(ops)
    input_set, output_set = set(inputs), set(outputs)
    plan = _RowPlan(domain=domain, N=N, R=R, C=C,
                    inputs=list(inputs), outputs=list(outputs))
    for op in work:
        for v in (*op.in_views(), *op.out_views()):
            plan.base_meta[v.base.uid] = (v.base.size, v.base.dtype)

    op_index: Dict[Tuple, int] = {}
    dense_slot: Dict[int, int] = {}
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

    def resolve_read(v: View) -> Tuple:
        u = v.base.uid
        for wview, nidx, is_red in reversed(writes.get(u, [])):
            if is_red:
                # the ONE consumption form this generator exists for: the
                # reduced (TR, 1) value broadcast back over the reduced axis
                stripped = View(v.base, v.offset, v.shape[:-1], v.strides[:-1])
                if (v.shape == domain and v.strides[-1] == 0
                        and stripped.identical(wview)):
                    return ("red", nidx)
                raise FusedBlockUnsupported(
                    "view_conflict",
                    f"read {v!r} of in-block reduction output {wview!r} "
                    "is not a trailing-axis broadcast of it")
            if wview.identical(v):
                return ("val", nidx)
            if wview.overlaps(v):
                raise FusedBlockUnsupported(
                    "view_conflict",
                    f"read {v!r} overlaps prior write {wview!r}")
        source = "buffer" if u in input_set else "zeros"
        return ("op", operand_for(v, source))

    for op in work:
        oc = op.opcode
        nidx = len(plan.nodes)
        ov = op.out
        u = ov.base.uid

        if oc in REDUCTIONS:
            axis = op.axis
            if axis is not None and axis < 0:
                axis += len(domain)
            if axis != len(domain) - 1:
                raise FusedBlockUnsupported(
                    "reduction_axis",
                    f"axis={op.axis} over domain {domain} (trailing only)")
            if not _whole(ov) or ov.shape != domain[:-1]:
                raise FusedBlockUnsupported("reduction_out", repr(ov))
            node = _Node(opcode=oc, terms=(resolve_read(op.in_views()[0]),),
                         out_dtype=ov.dtype, is_red=True)
            if u in output_set:
                node.out_slot = len(plan.slots)
                plan.slots.append(("red", ov.dtype, u))
            writes.setdefault(u, []).append((ov, nidx, True))
        else:
            terms = tuple(
                resolve_read(t) if isinstance(t, View) else ("lit", t)
                for t in op.inputs)
            node = _Node(opcode=oc, terms=terms, out_dtype=ov.dtype)
            if not _whole(ov):
                raise FusedBlockUnsupported("irregular_view", repr(ov))
            if u in output_set:
                slot = dense_slot.get(u)
                if slot is None:
                    slot = len(plan.slots)
                    plan.slots.append(("dense", ov.dtype, u))
                    dense_slot[u] = slot
                node.out_slot = slot
            writes.setdefault(u, []).append((ov, nidx, False))
        plan.nodes.append(node)

    # -- tiling: whole rows per program (at least 2 x 16, so no tile axis
    # degenerates), wider tiles get more warps --
    plan.BC = max(16, _next_pow2(C))
    if plan.BC > MAX_ROW:
        raise FusedBlockUnsupported(
            "vmem", f"row of {C} columns exceeds {MAX_ROW} per program")
    plan.TR = max(2, min(_next_pow2(R), TILE_ELEMS // plan.BC))
    plan.G = -(-R // plan.TR)
    plan.num_warps = min(16, max(4, plan.TR * plan.BC // 512))
    return plan


def rowblock_lower_reason(ops: Sequence[Op]) -> Optional[str]:
    """``None`` when the block lowers through the row-replay generator,
    else the reason slug.  Pure analysis — never raises."""
    try:
        _analyze(ops)
        return None
    except FusedBlockUnsupported as e:
        return e.reason
    except Exception:               # defensive: analysis bug != crash
        return "error"


# ---------------------------------------------------------------------------
# The plain version: the plan at domain shape, with the floor's torch ops
# ---------------------------------------------------------------------------

def plain_slots(plan: _RowPlan, store: Dict[int, torch.Tensor], rvals,
                device) -> List[torch.Tensor]:
    """The kernel's slots computed with the torch floor's ops
    (``apply_op`` / ``apply_reduce``) on domain-shaped tensors: flat ``(N,)``
    for a dense slot, ``(R,)`` for a reduction slot.  ``rvals`` is unused
    (no ``random`` ops are claimed); it keeps ``codegen.plain_slots``'s
    signature."""
    dom = plan.domain
    loaded = []
    for o in plan.operands:
        if o.source == "zeros":
            dt = plan.base_meta[o.base_uid][1]
            loaded.append(torch.zeros(dom, dtype=torch_dtype(dt),
                                      device=device))
        else:
            loaded.append(_read(store[o.base_uid], o.view))
    vals: Dict[int, torch.Tensor] = {}
    slots: List[Optional[torch.Tensor]] = [None] * len(plan.slots)

    def resolve(term):
        tag, x = term
        if tag == "lit":
            return x
        if tag == "op":
            return loaded[x]
        if tag == "red":
            return vals[x].unsqueeze(-1).expand(dom)
        return vals[x]

    for k, node in enumerate(plan.nodes):
        args = [resolve(t) for t in node.terms]
        dt = torch_dtype(node.out_dtype)
        if node.is_red:
            x = torch.broadcast_to(args[0], dom).contiguous()
            val = apply_reduce(node.opcode, x, len(dom) - 1).to(dt)
        else:
            val = torch.broadcast_to(apply_op(node.opcode, args), dom) \
                .to(dtype=dt).contiguous()
        vals[k] = val
        if node.out_slot is not None:
            slots[node.out_slot] = val.reshape(-1)
    return slots


def epilogue(plan: _RowPlan, slots: Sequence[torch.Tensor]) -> Tuple:
    """The block's output buffers: each output base takes the last slot
    written for it, cast once to the base dtype."""
    final: Dict[int, torch.Tensor] = {}
    for (_, _, u), raw in zip(plan.slots, slots):
        final[u] = raw.to(torch_dtype(plan.base_meta[u][1]))
    return tuple(final[u] for u in plan.outputs)


# ---------------------------------------------------------------------------
# The Triton source generator
# ---------------------------------------------------------------------------

def _operand_dtypes(plan: _RowPlan) -> List[np.dtype]:
    return [np.dtype(plan.base_meta[o.base_uid][1]) for o in plan.operands]


def triton_source(plan: _RowPlan) -> Tuple[str, List[float], List[int]]:
    """The generated module ``(source, float constants, int constants)``.
    Shapes, strides and tiling are literals of the source, so one source
    serves exactly one block signature."""
    src = _Source()
    body = src.pre
    params: List[str] = []
    dtypes = _operand_dtypes(plan)
    is_bool = [dt == np.dtype(np.bool_) for dt in dtypes]

    opval: Dict[int, str] = {}
    for i, o in enumerate(plan.operands):
        if o.source == "zeros":
            opval[i] = src.name("z")
            body.append(f"{opval[i]} = tl.zeros((1, 1), {_tl(dtypes[i])})")
            continue
        ptr = f"A{i}"
        params.append(ptr)
        rterm, cs = _address(plan, o.view)
        off = o.view.offset
        if rterm is None and cs == 0:                     # scalar
            expr = f"tl.load({ptr} + {off})"
        elif cs == 0:                                     # column
            expr = f"tl.load({ptr} + ({off} + {rterm}), mask=rmask, other=0)"
        elif rterm is None:                               # row
            expr = (f"tl.load({ptr} + ({off} + cols * {cs}), mask=cmask, "
                    f"other=0)")
        else:                                             # dense
            expr = (f"tl.load({ptr} + ({off} + {rterm} + cols * {cs}), "
                    f"mask=m, other=0)")
        opval[i] = src.name("x")
        body.append(f"{opval[i]} = {expr}" + (" != 0" if is_bool[i] else ""))

    slot_ptr = [f"S{j}" for j in range(len(plan.slots))]
    params += slot_ptr

    vals: Dict[int, Tuple[str, np.dtype]] = {}

    def term(t) -> Tuple[Optional[str], object]:
        tag, x = t
        if tag == "lit":
            return None, x
        if tag == "op":
            return opval[x], dtypes[x]
        return vals[x]                                # "val" and "red"

    for k, node in enumerate(plan.nodes):
        oc, out = node.opcode, np.dtype(node.out_dtype)
        name = src.name("v")
        if node.is_red:
            x, xdt = term(node.terms[0])
            adt = reduce_dtype(oc, np.dtype(xdt))
            ident = src.const(reduce_identity(oc, adt), adt)
            # padded columns enter as the identity: a whole-row (TR, BC)
            # tile reduced along its columns into a (TR, 1) column
            red = (f"tl.reduce(tl.where(cfull, {_cast(x, xdt, adt)}, "
                   f"{ident}), 1, {_combine_fn(oc, adt)})[:, None]")
            body.append(f"{name} = {_cast(red, adt, out)}")
        else:
            expr, rd = _op_expr(src, oc, [term(t) for t in node.terms])
            body.append(f"{name} = {_cast(expr, rd, out)}")
        vals[k] = (name, out)
        if node.out_slot is not None:
            if node.is_red:
                body.append(f"tl.store({slot_ptr[node.out_slot]} + rows, "
                            f"{name}, mask=rmask)")
            else:
                body.append(f"tl.store({slot_ptr[node.out_slot]} + "
                            f"(rows * C + cols), {name}, mask=m)")

    params += ["KF", "KI"]
    head = [
        "pid = tl.program_id(0)",
        "rows = (pid * TR + tl.arange(0, TR).to(tl.int64))[:, None]",
        "cols = tl.arange(0, BC).to(tl.int64)[None, :]",
        "rmask = rows < R",
        "cmask = cols < C",
        "m = rmask & cmask",
        "cfull = tl.broadcast_to(cmask, (TR, BC))",
    ]
    lines = [
        "import triton",
        "import triton.language as tl",
        "from triton.language.extra import libdevice",
        "",
        *(f"{k} = tl.constexpr({v})" for k, v in
          (("R", plan.R), ("C", plan.C), ("TR", plan.TR), ("BC", plan.BC))),
        _HELPERS,
        "@triton.jit",
        f"def row_kernel({', '.join(params)}):",
        *("    " + line for line in head + body),
    ]
    return "\n".join(lines) + "\n", src.kf, src.ki


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

class RowBlockKernel:
    """The executable of one claimed block: ``fn(*input_bufs, salts) ->
    output_bufs`` with the ``make_block_fn`` calling convention (``salts``
    is accepted for uniformity and ignored: ``random`` ops are not
    claimed).

    Input buffers on the CPU take the plain version; buffers on a CUDA
    device launch the generated kernel (built at first launch) or raise.
    The interface is :class:`codegen.FusedBlockKernel`'s, so one harness
    records and times both kernels.
    """

    def __init__(self, plan: _RowPlan, device: torch.device):
        self.plan = plan
        self.device = torch.device(device)
        self._gen = None            # (module, consts) once built

    def draw_random(self, salts, device) -> List[torch.Tensor]:
        return []

    def _device_of(self, bufs) -> torch.device:
        devs = {b.device for b in bufs}
        if len(devs) > 1:
            raise ValueError(f"block inputs span devices {devs}")
        return devs.pop() if devs else self.device

    def __call__(self, *bufs_and_salts):
        *bufs, _salts = bufs_and_salts
        device = self._device_of(bufs)
        store = dict(zip(self.plan.inputs, bufs))
        if device.type == "cpu":
            slots = plain_slots(self.plan, store, [], device)
        elif device.type == "cuda":
            slots = self.launch(store, [], device)
        else:
            raise RuntimeError(f"no row-replay kernel for device {device}")
        return epilogue(self.plan, slots)

    def plain(self, *bufs_and_salts):
        """The plain version on any device — what the kernel is held
        against on the card."""
        *bufs, _salts = bufs_and_salts
        device = self._device_of(bufs)
        store = dict(zip(self.plan.inputs, bufs))
        return epilogue(self.plan, plain_slots(self.plan, store, [], device))

    def launch(self, store: Dict[int, torch.Tensor], rvals,
               device: torch.device) -> List[torch.Tensor]:
        run, slots = self.prepare(store, rvals, device)
        run()
        LAUNCHES["rowblock"] += 1
        return slots

    def prepare(self, store: Dict[int, torch.Tensor], rvals,
                device: torch.device):
        """Build the kernel if needed, allocate the slots and bind the
        arguments.  Returns ``(run, slots)``: ``run()`` launches the kernel
        (nothing else) and fills ``slots``."""
        p = self.plan
        if self._gen is None:
            source, kf, ki = triton_source(p)
            consts = (torch.tensor(kf or [0.0], dtype=torch.float64,
                                   device=device),
                      torch.tensor(ki or [0], dtype=torch.int64,
                                   device=device))
            self._gen = (_load_module(source), consts)
        mod, consts = self._gen
        args = []
        for o in p.operands:
            if o.source == "zeros":
                continue
            buf = store[o.base_uid].contiguous()
            args.append(buf.view(torch.uint8) if buf.dtype == torch.bool
                        else buf)
        slots = [torch.empty(p.N if kind == "dense" else p.R,
                             dtype=torch_dtype(dt), device=device)
                 for kind, dt, _ in p.slots]

        def run():
            mod.row_kernel[(p.G,)](*args, *slots, *consts,
                                   num_warps=p.num_warps,
                                   enable_fp_fusion=False)

        return run, slots


def build_rowblock_kernel(ops: Sequence[Op], *, seed: int = 0,
                          device=torch.device("cpu")):
    """Compile a reduction-consuming block into one row-tiled Triton kernel.

    Returns ``(fn, input_uids, output_uids)`` with the ``make_block_fn``
    calling convention ``fn(*flat_input_bufs, salts) -> output_bufs``.
    Raises :class:`FusedBlockUnsupported` for blocks the row tiler cannot
    express."""
    del seed  # no random ops — uniform signature with build_block_kernel
    plan = _analyze(ops)
    return RowBlockKernel(plan, device), list(plan.inputs), list(plan.outputs)


def block_bytes(plan: _RowPlan) -> int:
    """Bytes one launch must move at least: each external input view's
    elements read once (at most its whole base) and each output base
    written once — the numerator of the kernel's bound."""
    reads: Dict[int, Dict[Tuple, int]] = {}
    for o in plan.operands:
        if o.source == "buffer":
            dt = plan.base_meta[o.base_uid][1]
            reads.setdefault(o.base_uid, {})[o.key[2:]] = \
                o.core.size * np.dtype(dt).itemsize
    total = 0
    for u, views in reads.items():
        size, dt = plan.base_meta[u]
        total += min(size * np.dtype(dt).itemsize, sum(views.values()))
    for u in plan.outputs:
        size, dt = plan.base_meta[u]
        total += size * np.dtype(dt).itemsize
    return total


def block_ops(plan: _RowPlan) -> Dict[str, int]:
    """Arithmetic operations of one launch by compute type: every node but
    a ``copy`` is one operation per domain element, in the widest type
    among its operands and result."""
    dts = _operand_dtypes(plan)
    out: Dict[str, int] = {}
    for node in plan.nodes:
        if node.opcode == "copy":
            continue
        types = [np.dtype(node.out_dtype)]
        for kind, x in node.terms:
            if kind == "op":
                types.append(dts[x])
            elif kind in ("val", "red"):
                types.append(np.dtype(plan.nodes[x].out_dtype))
        name = np.result_type(*types).name
        out[name] = out.get(name, 0) + plan.N
    return out
