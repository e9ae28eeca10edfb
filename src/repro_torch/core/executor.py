"""Per-block execution — the Bohrium backend analogue (paper §III final
phase: "the hardware specific backend JIT-compiles each block of array
operations and executes them"), on PyTorch.

Each partition block becomes ONE executable: ``ext`` arrays cross the block
boundary as function inputs/outputs (exactly the paper's cost), while
contracted arrays (``new∩del``) are local temporaries.  *Which* executable a
block becomes is a per-block lowering decision over the backend registry
(``repro_torch.core.backends``): ``torch`` (the :func:`make_block_fn` floor
below, one PyTorch call per op) or ``triton`` (the fused-block Triton
generator).  ``BlockExecutor`` is the thin dispatch engine over that
registry.

Buffers are flat 1-D tensors on the executor's device.  They are never
written in place: a partial write clones its base first, so a tensor once
stored (in the buffer store or a SYNC snapshot) never changes.  In-place
reuse of dying buffers is later work.

The op tables follow the reference's ``jnp`` semantics with 64-bit types
enabled, including its type promotion (:func:`op_dtypes`), ``jnp.mod``'s
sign rule and ``jnp.take``'s fill mode, so a block computes the same values
here as in ``repro.core.executor``.
"""

from __future__ import annotations

import threading
from collections.abc import Mapping
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import prng
from .ir import COMM_OPS, REDUCTIONS, Op, View
from .obs import trace
from .obs.metrics import MetricsRegistry, StatsView

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16, np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_NP_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}


def numpy_dtype(dt: torch.dtype) -> np.dtype:
    return _NP_DTYPES[dt]


def torch_dtype(dt) -> torch.dtype:
    try:
        return _TORCH_DTYPES[np.dtype(dt)]
    except KeyError:
        raise TypeError(f"dtype {dt} has no supported torch counterpart")


# ---------------------------------------------------------------------------
# Type promotion: jnp with jax_enable_x64, operands given as np.dtype (an
# array) or a Python scalar (a weakly-typed literal)
# ---------------------------------------------------------------------------

_FLOAT_UNARY = {"sqrt", "exp", "log", "sin", "cos", "erf", "rsqrt", "tanh",
                "sigmoid"}


def _is_literal(t) -> bool:
    return not isinstance(t, np.dtype)


def _to_inexact(dt: np.dtype) -> np.dtype:
    """``dtypes.to_inexact_dtype``: 64-bit integers become float64, every
    narrower integer (and bool) float32, floats stay."""
    if dt.kind == "f":
        return dt
    return np.dtype(np.float64 if dt.itemsize == 8 else np.float32)


def promote(terms: Sequence) -> np.dtype:
    """``jnp.result_type`` of arrays (np.dtype) and weak Python scalars."""
    arrays = [t for t in terms if not _is_literal(t)]
    lits = [t for t in terms if _is_literal(t)]
    if arrays:
        dt = arrays[0]
        for a in arrays[1:]:
            dt = _NP_DTYPES[torch.promote_types(torch_dtype(dt),
                                                torch_dtype(a))]
    elif any(isinstance(x, float) for x in lits):
        return np.dtype(np.float64)
    elif any(not isinstance(x, bool) for x in lits):
        return np.dtype(np.int64)
    else:
        return np.dtype(np.bool_)
    for x in lits:
        if isinstance(x, bool):
            continue
        if isinstance(x, float) and dt.kind != "f":
            dt = np.dtype(np.float64)
        elif dt.kind == "b":
            dt = np.dtype(np.int64)
    return dt


def reduce_dtype(opcode: str, dt: np.dtype) -> np.dtype:
    """Result dtype of ``jnp.sum/prod`` (small integers and bool widen to
    64 bits) and ``jnp.max/min`` (unchanged)."""
    if opcode in ("reduce_sum", "reduce_prod") and dt.kind in "biu":
        return np.dtype(np.uint64 if dt.kind == "u" else np.int64)
    return dt


def op_dtypes(opcode: str, terms: Sequence) -> Tuple[np.dtype, np.dtype]:
    """``(compute, result)`` dtypes of one elementwise op: array operands
    are cast to ``compute`` before the op, which yields ``result``.  For
    ``where`` the terms are the two value branches (the condition is only
    tested against zero)."""
    if opcode == "reciprocal":                   # jnp: 1.0 / x
        terms = (1.0, *terms)
    cd = promote(terms)
    if opcode in _FLOAT_UNARY or opcode in ("div", "reciprocal"):
        cd = _to_inexact(cd)
    if opcode in ("greater", "less"):
        return cd, np.dtype(np.bool_)
    return cd, cd


# ---------------------------------------------------------------------------
# Op tables (operands already cast to the compute dtype; literals are 0-dim
# tensors of it on the operands' device)
# ---------------------------------------------------------------------------

def _sign(x):
    # lax.sign: zeros and NaN map to themselves
    return torch.where(x > 0, 1, torch.where(x < 0, -1, x)).to(x.dtype)


def _mod(x1, x2):
    """``jnp.mod``: truncated remainder, then the sign correction toward the
    divisor (``jax._src.numpy.ufuncs.remainder``)."""
    if not x2.dtype.is_floating_point:
        x2 = torch.where(x2 == 0, torch.ones_like(x2), x2)
    trunc = torch.fmod(x1, x2)
    do_plus = ((trunc < 0) != (x2 < 0)) & (trunc != 0)
    return torch.where(do_plus, trunc + x2, trunc)


_UNARY = {
    "copy": lambda x: x, "sqrt": torch.sqrt, "exp": torch.exp,
    "log": torch.log, "abs": torch.abs, "neg": torch.neg, "sin": torch.sin,
    "cos": torch.cos, "erf": torch.special.erf, "sign": _sign,
    "rsqrt": torch.rsqrt, "tanh": torch.tanh, "square": lambda x: x * x,
    "reciprocal": lambda x: 1 / x,
    "floor": lambda x: torch.floor(x) if x.dtype.is_floating_point else x,
    "sigmoid": torch.sigmoid,
}
_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "pow": torch.pow, "maximum": torch.maximum, "minimum": torch.minimum,
    "greater": torch.gt, "less": torch.lt, "mod": _mod,
}


def reduce_identity(opcode: str, dt: np.dtype):
    """Identity of a reduction's combine in dtype ``dt``."""
    if opcode == "reduce_sum":
        return 0
    if opcode == "reduce_prod":
        return 1
    big = (float("inf") if dt.kind == "f"
           else int(np.iinfo(dt).max) if dt.kind in "iu" else True)
    small = (float("-inf") if dt.kind == "f"
             else int(np.iinfo(dt).min) if dt.kind in "iu" else False)
    return small if opcode == "reduce_max" else big


def apply_reduce(opcode: str, x: torch.Tensor, axis) -> torch.Tensor:
    """``jnp.sum/max/min/prod`` over ``axis`` (``None`` = every axis)."""
    dims = tuple(range(x.dim())) if axis is None else (axis,)
    acc = torch_dtype(reduce_dtype(opcode, _NP_DTYPES[x.dtype]))
    if opcode == "reduce_sum":
        return torch.sum(x, dim=dims, dtype=acc)
    if opcode == "reduce_max":
        return torch.amax(x, dim=dims)
    if opcode == "reduce_min":
        return torch.amin(x, dim=dims)
    if x.dim() == 0 or axis is None:
        return torch.prod(x.reshape(-1), dim=0, dtype=acc)
    return torch.prod(x, dim=axis, dtype=acc)


def take(table: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.take(table, idx.astype(int32), axis)`` in its default ``fill``
    mode: negative indices wrap once, indices still out of range read NaN
    (floats), the most negative value (signed ints) or True (bool)."""
    i = idx.to(torch.int32).to(torch.int64)
    n = table.shape[axis]
    i = torch.where(i < 0, i + n, i)
    valid = (i >= 0) & (i < n)
    got = torch.index_select(table, axis, torch.where(valid, i, 0).reshape(-1))
    out_shape = table.shape[:axis] + idx.shape + table.shape[axis + 1:]
    got = got.reshape(out_shape)
    dt = table.dtype
    fill = (float("nan") if dt.is_floating_point else True if dt == torch.bool
            else torch.iinfo(dt).min)
    mask = valid.reshape((1,) * axis + idx.shape
                         + (1,) * (table.dim() - axis - 1))
    return torch.where(mask, got, torch.tensor(fill, dtype=dt,
                                               device=table.device))


_LITERALS: Dict[Tuple, torch.Tensor] = {}


def _lit(x, dt: np.dtype, device) -> torch.Tensor:
    """A literal as a 0-dim tensor of ``dt`` on ``device`` (cached: programs
    reuse a handful of constants).  A device tensor, not a CPU scalar:
    PyTorch's CUDA division by a CPU scalar multiplies by its reciprocal,
    which is not the correctly rounded quotient ``jnp.divide`` gives."""
    key = (type(x), x, np.dtype(dt).name, str(device))
    t = _LITERALS.get(key)
    if t is None:
        if len(_LITERALS) >= 4096:
            _LITERALS.clear()
        t = torch.tensor(x, dtype=torch_dtype(dt), device=device)
        _LITERALS[key] = t
    return t


def apply_op(opcode: str, args: Sequence) -> torch.Tensor:
    """One elementwise op with the reference's semantics.  ``args`` are
    tensors or Python scalars; the result has ``op_dtypes``' result type."""
    terms = [(_NP_DTYPES[a.dtype] if isinstance(a, torch.Tensor) else a)
             for a in args]
    if opcode == "where":
        cond, *vals = args
        cd, _ = op_dtypes("where", terms[1:])
        vals = [v.to(torch_dtype(cd)) if isinstance(v, torch.Tensor)
                else _lit(v, cd, cond.device) for v in vals]
        if cond.dtype != torch.bool:
            cond = cond != 0
        return torch.where(cond, *vals)
    cd, _ = op_dtypes(opcode, terms)
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  torch.device("cpu"))
    xs = [a.to(torch_dtype(cd)) if isinstance(a, torch.Tensor)
          else _lit(a, cd, device) for a in args]
    if opcode in _UNARY:
        return _UNARY[opcode](*xs)
    return _BINARY[opcode](*xs)


# ---------------------------------------------------------------------------
# Views: static reshape/slice plans, strided reads, functional writes
# ---------------------------------------------------------------------------

def _is_whole(v: View) -> bool:
    return v.offset == 0 and v.size == v.base.size and v.is_contiguous()


def _view_index(v: View) -> Optional[np.ndarray]:
    """Static flat element indices of a view into its base, or None when the
    view is the whole contiguous base (fast path: pure reshape)."""
    if _is_whole(v):
        return None
    idx = np.full((), v.offset, dtype=np.int64)
    for s, st in zip(v.shape, v.strides):
        idx = idx[..., None] + np.arange(s, dtype=np.int64) * st
    return idx.reshape(-1)


def _slice_plan(v: View) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...],
                                           Tuple[int, ...]]]:
    """Lower a regularly-strided view to one static slice: returns
    ``(dims, starts, sizes)`` such that reshaping the flat base to ``dims``
    and slicing ``starts:starts+sizes`` yields the view's elements (in view
    order), or None when the strides are not a nested row-major pattern.
    (A copy of ``repro.core.executor._slice_plan``: the codegen's analysis
    uses it to decide which views a kernel claims.)"""
    if v.size == 0:
        return None
    sh = [s for s, st in zip(v.shape, v.strides) if s != 1]
    st = [st for s, st in zip(v.shape, v.strides) if s != 1]
    if any(s <= 0 for s in st):
        return None                       # broadcast / reversed: gather path
    if st and st[-1] != 1:                # strided innermost dim: view the
        sh.append(1)                      # base as (..., step) and take one
        st.append(1)                      # column of it
    dims: List[int] = []
    for i in range(len(st) - 1, 0, -1):
        if st[i - 1] % st[i]:
            return None
        d = st[i - 1] // st[i]
        if d < sh[i]:
            return None                   # rows would overlap/wrap
        dims.append(d)
    if not st:
        sh, st = [1], [1]
        dims.append(v.base.size)
    else:
        if v.base.size % st[0]:
            return None
        dims.append(v.base.size // st[0])
    dims.reverse()
    starts, rem = [], v.offset
    for d, s in zip(dims, st):            # st are the row-major strides of
        starts.append(rem // s)           # dims by construction
        rem -= starts[-1] * s
    if rem:
        return None
    if any(a + n > d for a, d, n in zip(starts, dims, sh)):
        return None
    return tuple(dims), tuple(starts), tuple(sh)


def _window(plan) -> Tuple[slice, ...]:
    _dims, starts, sizes = plan
    return tuple(slice(a, a + n) for a, n in zip(starts, sizes))


def _read(buf: torch.Tensor, v: View) -> torch.Tensor:
    """The elements of ``v`` as a tensor of ``v.shape`` (a view of ``buf``
    where possible; callers never write through it)."""
    if _is_whole(v):
        return buf.reshape(v.shape)
    plan = _slice_plan(v)
    if plan is not None:
        return buf.reshape(plan[0])[_window(plan)].reshape(v.shape)
    if all(st >= 0 for st in v.strides):
        # stride-0 broadcasts and other non-negative patterns: one strided
        # view selects the same elements as the index gather below
        buf = buf.contiguous()
        return buf.as_strided(v.shape, v.strides, buf.storage_offset()
                              + v.offset)
    idx = torch.from_numpy(_view_index(v)).to(buf.device)
    return buf[idx].reshape(v.shape)


def _write(buf: torch.Tensor, v: View, val) -> torch.Tensor:
    """``buf`` with ``v`` set to ``val`` (cast to the base dtype), as a new
    flat tensor; ``buf`` itself is never modified."""
    if not isinstance(val, torch.Tensor):
        val = torch.tensor(val)
    val = torch.broadcast_to(val.to(device=buf.device, dtype=buf.dtype),
                             v.shape)
    if _is_whole(v):
        return val.reshape(-1).contiguous()
    out = buf.clone()
    plan = _slice_plan(v)
    if plan is not None:
        out.view(plan[0])[_window(plan)] = val.reshape(plan[2])
        return out
    idx = torch.from_numpy(_view_index(v)).to(buf.device)
    out[idx] = val.reshape(-1)
    return out


def block_dead_bases(ops: Sequence[Op]) -> set:
    """Bases destroyed inside a block and not SYNC'd: no later block (or the
    host) may observe them.  The single definition of the del−sync rule."""
    deleted, synced = set(), set()
    for op in ops:
        for b in op.del_bases:
            deleted.add(b.uid)
        for b in op.sync_bases:
            synced.add(b.uid)
    return deleted - synced


def block_io(ops: Sequence[Op]) -> Tuple[List[int], List[int], List[int]]:
    """(input base uids, output base uids, contracted base uids) of a block.

    inputs  = bases observed before being fully defined inside the block,
    outputs = bases written here that outlive the block,
    contracted = new∩del — never materialized outside the block (the paper's
    array contraction; these stay in registers inside a fused kernel).
    """
    new, read, written = set(), set(), set()
    inputs: List[int] = []
    order: List[int] = []
    for op in ops:
        for b in (*op.new_bases,):
            new.add(b.uid)
        for v in op.in_views():
            u = v.base.uid
            if u not in new and u not in written and u not in inputs:
                inputs.append(u)
            read.add(u)
            if u not in order:
                order.append(u)
        for v in op.out_views():
            u = v.base.uid
            # partial write of a pre-existing base is a read-modify-write
            if (u not in new and u not in written and u not in inputs
                    and not (v.offset == 0 and v.size == v.base.size)):
                inputs.append(u)
            written.add(u)
            if u not in order:
                order.append(u)
    dead = block_dead_bases(ops)     # SYNC'd bases stay observable
    contracted = [u for u in order if u in new and u in dead]
    outputs = [u for u in order if u in written and u not in dead]
    return inputs, outputs, contracted


def _base_meta(ops: Sequence[Op]) -> Dict[int, Tuple[int, np.dtype]]:
    meta: Dict[int, Tuple[int, np.dtype]] = {}
    for op in ops:
        for v in (*op.in_views(), *op.out_views()):
            meta[v.base.uid] = (v.base.size, v.base.dtype)
    return meta


def make_block_fn(ops: Sequence[Op], seed: int = 0,
                  device: torch.device = torch.device("cpu")):
    """Build the floor function for one block: one PyTorch call per op.

    Returns ``(fn, input_uids, output_uids)`` where ``fn(*input_bufs,
    salts) -> output_bufs`` takes flat tensors on ``device`` and a sequence
    of per-``random``-op integer salts."""
    work = [op for op in ops if not op.is_system()]
    inputs, outputs, _contracted = block_io(ops)  # DEL/SYNC drive contraction
    meta = _base_meta(work)

    def fn(*bufs_and_salts):
        *bufs, salts = bufs_and_salts
        env: Dict[int, torch.Tensor] = dict(zip(inputs, bufs))
        n_rand = 0
        for u, (size, dtype) in meta.items():
            if u not in env:
                env[u] = torch.zeros(size, dtype=torch_dtype(dtype),
                                     device=device)
        for op in work:
            ins = [(_read(env[v.base.uid], v) if isinstance(v, View) else v)
                   for v in op.inputs]
            oc = op.opcode
            if oc in COMM_OPS:
                # single-device semantics of a placement cast: identity
                val = ins[0]
            elif oc in REDUCTIONS:
                val = apply_reduce(oc, ins[0], op.axis)
            elif oc == "matmul":
                val = torch.matmul(*ins)
            elif oc == "random":
                # per-op salts are call-time arguments: structurally-
                # identical blocks (shared executable) draw fresh values,
                # and the draws are partition-invariant (the salt is the
                # op's own, not a block property)
                val = prng.uniform(seed, salts[n_rand], op.out.shape,
                                   op.out.dtype, device)
                n_rand += 1
            elif oc == "range":
                val = torch.arange(op.out.size, dtype=torch_dtype(
                    op.out.dtype), device=device).reshape(op.out.shape)
            elif oc == "gather":
                val = take(ins[0], ins[1], op.axis or 0)
            elif oc in _UNARY or oc in _BINARY or oc == "where":
                val = apply_op(oc, ins)
            else:
                raise NotImplementedError(f"opcode {oc!r}")
            ov = op.out
            env[ov.base.uid] = _write(env[ov.base.uid], ov, val)
        return tuple(env[u] for u in outputs)

    return fn, inputs, outputs


def stats_delta(before: Mapping, after: Mapping) -> Dict:
    """Recursive ``after - before`` over (possibly nested) numeric stat
    mappings — the per-flush delta ``Runtime.flush`` records into history.
    Accepts plain dicts and the live :class:`StatsView` alike, returns
    plain dicts, and clamps deltas at zero (a ``reset_stats()`` between the
    two observations would otherwise make them negative)."""
    if isinstance(before, StatsView):
        before = before.snapshot()
    if isinstance(after, StatsView):
        after = after.snapshot()
    out: Dict = {}
    for k, v in after.items():
        if isinstance(v, Mapping):
            out[k] = stats_delta(before.get(k, {}), v)
        else:
            d = v - before.get(k, 0)
            out[k] = d if d > 0 else 0
    return out


class BlockExecutor:
    """The execute stage: a thin dispatch engine over the lowering-backend
    registry (``repro_torch.core.backends``).

    Each work block dispatches on the backend its ``BlockPlan.lowering``
    decision names (annotated by the scheduler's lower stage; decided here
    for a schedule planned without a lowering policy).  The engine owns what is common
    to every backend: the executable cache keyed by ``(backend,
    signature)``, RNG-salt plumbing, and uniform per-backend stats.

    A backend's build or launch failure raises: nothing here swaps in
    another backend behind the caller's back.  Declining a block is the
    backend's ``claims`` answer at planning time, counted in the stats.

    Dispatch is asynchronous on a CUDA device: nothing in the block loop
    synchronizes, so results only wait for the card at an explicit SYNC
    (``Runtime.materialize``)."""

    def __init__(self, seed: int = 0, backend="torch",
                 device: torch.device = torch.device("cpu")):
        """``backend`` resolves to the preference-ordered candidate list of
        the lowering policy (``backends.default_stack``): ``"torch"`` runs
        every block on the floor; ``"triton"`` prefers the fused-block
        Triton kernel with the floor for the blocks it declines; a
        tuple/list names an explicit stack."""
        from .backends import default_stack
        self.seed = seed
        self.backend = backend
        self.device = torch.device(device)
        self.backends: Tuple[str, ...] = default_stack(backend)
        self._cache: Dict[Tuple, object] = {}
        self._lock = threading.RLock()
        self.sync_store: Dict[int, torch.Tensor] = {}
        self.metrics = MetricsRegistry()
        self.stats: StatsView = StatsView(self.metrics, prefix="executor")
        self.reset_stats()

    # -- stats ---------------------------------------------------------
    def reset_stats(self) -> None:
        """Zero every counter (compiled executables and cached lowering
        decisions are kept — resetting is observation, not state).

        ``backend_blocks[name]`` counts dispatches per backend;
        ``backend_fallbacks[name][reason]`` counts, per backend the policy
        preferred over the one that ran, why it declined.  Under a
        triton-bearing policy every dispatched work block lands either in
        ``triton_blocks`` or in ``triton_fallback_blocks`` with its reason
        slug counted in ``triton_fallbacks`` (``codegen.REASONS``)."""
        st = self.stats
        with self.metrics.lock:
            for key in ("blocks_run", "exec_cache_hits", "exec_cache_misses",
                        "triton_blocks", "triton_fallback_blocks"):
                st.declare_scalar(key)
            st.declare_group("triton_fallbacks", ("reason",))
            st.declare_group("backend_blocks", ("backend",),
                             presets=self.backends)
            st.declare_group("backend_fallbacks", ("backend", "reason"),
                             presets=self.backends)

    def snapshot_stats(self) -> Dict:
        """Plain nested-dict copy of the counters, for before/after flush
        deltas (``stats_delta``)."""
        return self.stats.snapshot()

    # -- policy --------------------------------------------------------
    def lowering_context(self):
        from .backends import LoweringContext
        return LoweringContext(seed=self.seed, device=self.device)

    def lowering_policy(self):
        """What ``Runtime.flush`` hands ``Scheduler.plan`` so the lower
        stage decides per block which of this executor's backends runs it."""
        from .backends import LoweringPolicy
        return LoweringPolicy(backends=self.backends,
                              ctx=self.lowering_context())

    # -- dispatch ------------------------------------------------------
    def _executable(self, decision, ops: Sequence[Op], plan, ctx):
        """Look up (or build) the executable for one decided plan."""
        from .backends import get_backend
        key = (decision.backend, plan.signature)
        with self._lock:
            fn = self._cache.get(key)
        if fn is not None:
            self.stats.inc("exec_cache_hits")
            trace.instant("cache.exec", hit=True, backend=decision.backend)
            return fn
        self.stats.inc("exec_cache_misses")
        trace.instant("cache.exec", hit=False, backend=decision.backend)
        with trace.span("build", backend=decision.backend, n_ops=len(ops)):
            fn = get_backend(decision.backend).build(ops, plan, ctx)
        with self._lock:
            self._cache[key] = fn
        return fn

    def _account(self, decision) -> None:
        st = self.stats
        st.inc("blocks_run")
        st.inc("backend_blocks", labels=(decision.backend,))
        for name, reason in decision.declined:
            st.inc("backend_fallbacks", labels=(name, reason))
        if decision.backend == "triton":
            st.inc("triton_blocks")
        else:
            reason = decision.reason_for("triton")
            if reason is not None:
                st.inc("triton_fallback_blocks")
                st.inc("triton_fallbacks", labels=(reason,))

    def run_schedule(self, schedule, buffers: Dict[int, torch.Tensor]) -> None:
        """Dispatch a planned flush against the buffer store.

        ``schedule`` is the :class:`repro_torch.core.scheduler.Schedule`
        produced by ``Scheduler.plan``; ``buffers`` maps base uid -> flat
        device tensor and is updated with each block's outputs.  Per block:
        take the plan's lowering decision (or decide now), look up (or
        build) the executable under ``(backend, signature)``, feed the
        external input buffers plus the RNG salts, then honor SYNC
        (snapshot into ``sync_store``) and DEL (free) in Bohrium order."""
        from .backends import select_lowering
        tape = schedule.tape
        ctx = self.lowering_context()
        with trace.span("stage.execute", n_blocks=len(schedule.blocks)):
            for plan in schedule.blocks:
                ops = [tape[i] for i in plan.op_indices]
                if plan.has_work:
                    decision = plan.lowering
                    if decision is None:        # a schedule planned without
                        decision = select_lowering(      # a lowering policy
                            ops, plan, self.backends, ctx)
                    fn = self._executable(decision, ops, plan, ctx)
                    self._account(decision)
                    in_bufs = []
                    for u in plan.inputs:
                        if u not in buffers:
                            raise RuntimeError(
                                f"base {u} read before definition")
                        in_bufs.append(buffers[u])
                    salts = tuple(getattr(op, "salt", op.uid) % (2**31 - 1)
                                  for op in ops if not op.is_system()
                                  and op.opcode == "random")
                    with trace.span("block", backend=decision.backend,
                                    n_ops=len(plan.op_indices)):
                        out_bufs = fn(*in_bufs, salts)
                    for u, b in zip(plan.outputs, out_bufs):
                        buffers[u] = b
                for op in ops:  # SYNC snapshots before DEL (Bohrium order)
                    for b in op.sync_bases:
                        if b.uid in buffers:
                            self.sync_store[b.uid] = buffers[b.uid]
                    for b in op.del_bases:
                        buffers.pop(b.uid, None)
