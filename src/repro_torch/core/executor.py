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
registry.  Given a ``DeviceMesh`` it also runs sharded blocks through the
``shard_map`` backend with real collectives (``core/dist``).

Buffers are flat 1-D tensors on the executor's device.  The floor never
writes one in place (a partial write clones its base, :func:`_write`).
A recurring flush can also run as a fused loop (:meth:`BlockExecutor.
run_loop`, ``backends/loop_body.py``), whose state lives in static
buffers the loop overwrites.  A
backend that opts in (``LoweringBackend.donates``: the ``triton`` backend)
is told which of a block's input buffers it may overwrite — the donatable
ones (their base dies in the block, ``BlockPlan.donatable``) and those of
a base the block rewrites — unless another buffer or a SYNC snapshot
shares the tensor's storage: ``Runtime.materialize`` reads SYNC snapshots,
so a snapshot, like any buffer another base holds, never changes.  Each
buffer a block did overwrite counts in ``stats["donated_buffers"]``.

The op tables follow the reference's ``jnp`` semantics with 64-bit types
enabled, including its type promotion (:func:`op_dtypes`), ``jnp.mod``'s
sign rule and ``jnp.take``'s fill mode, so a block computes the same values
here as in ``repro.core.executor``.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from collections.abc import Mapping
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import prng
from .device import resolve_device
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
    return torch.where(mask, got, torch.full((), fill, dtype=dt,
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


def apply_op(opcode: str, args: Sequence, device=None) -> torch.Tensor:
    """One elementwise op with the reference's semantics.  ``args`` are
    tensors or Python scalars; the result has ``op_dtypes``' result type,
    on the tensors' device (``device``, else the CPU, when every argument
    is a literal)."""
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
                  torch.device(device or "cpu"))
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


def _view_index(v: View, device) -> torch.Tensor:
    """Flat element indices of a view into its base, built on ``device``
    (nothing crosses from the host, so a CUDA graph can hold the read)."""
    idx = torch.full((), v.offset, dtype=torch.int64, device=device)
    for s, st in zip(v.shape, v.strides):
        idx = idx[..., None] + torch.arange(s, dtype=torch.int64,
                                            device=device) * st
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


def _read(buf: torch.Tensor, v: View, batched: bool = False) -> torch.Tensor:
    """The elements of ``v`` as a tensor of ``v.shape`` (a view of ``buf``
    where possible; callers never write through it).  ``batched`` (under
    ``torch.func.vmap``) reads a pattern no slice expresses by index gather,
    never through ``as_strided`` on a tensor that carries a batch axis."""
    if _is_whole(v):
        return buf.reshape(v.shape)
    plan = _slice_plan(v)
    if plan is not None:
        return buf.reshape(plan[0])[_window(plan)].reshape(v.shape)
    if not batched and all(st >= 0 for st in v.strides):
        # stride-0 broadcasts and other non-negative patterns: one strided
        # view selects the same elements as the index gather below
        buf = buf.contiguous()
        return buf.as_strided(v.shape, v.strides, buf.storage_offset()
                              + v.offset)
    return buf[_view_index(v, buf.device)].reshape(v.shape)


def _write(buf: torch.Tensor, v: View, val,
           batched: bool = False) -> torch.Tensor:
    """``buf`` with ``v`` set to ``val`` (cast to the base dtype), as a new
    flat tensor; ``buf`` itself is never modified.  ``batched`` (under
    ``torch.func.vmap``) writes a window by one out-of-place ``index_put``:
    vmap refuses the clone-and-assign below when ``val`` carries the batch
    axis and ``buf`` does not (a base the block allocates)."""
    if not isinstance(val, torch.Tensor):
        val = torch.tensor(val)
    val = torch.broadcast_to(val.to(device=buf.device, dtype=buf.dtype),
                             v.shape)
    if _is_whole(v):
        return val.reshape(-1).contiguous()
    if batched:
        return buf.index_put((_view_index(v, buf.device),), val.reshape(-1))
    out = buf.clone()
    plan = _slice_plan(v)
    if plan is not None:
        out.view(plan[0])[_window(plan)] = val.reshape(plan[2])
        return out
    out[_view_index(v, buf.device)] = val.reshape(-1)
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


def make_block_fn(ops: Sequence[Op], seed: int = 0, device=None,
                  batched: bool = False):
    """Build the floor function for one block: one PyTorch call per op.

    Returns ``(fn, input_uids, output_uids)`` where ``fn(*input_bufs,
    salts) -> output_bufs`` takes flat tensors on ``device`` (the CUDA card
    unless given) and a sequence of per-``random``-op integer salts, or a
    ``prng.KeyTable`` (a fused loop body) whose key words the draws read
    on the device, or an int64 tensor ``(n_rand, 2)`` of the draws' key
    words (``prng.key_words``; one row of a batched dispatch's).

    ``batched=True`` builds the form ``torch.func.vmap`` maps over a
    leading request axis (``backends/batch_body.py``): window writes and
    gathered reads take their vmap-safe forms (:func:`_write`,
    :func:`_read`), with the same values."""
    device = resolve_device(device)
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
            ins = [(_read(env[v.base.uid], v, batched)
                    if isinstance(v, View) else v) for v in op.inputs]
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
                if isinstance(salts, prng.KeyTable):
                    val = prng.uniform_from(*salts.words(n_rand),
                                            op.out.shape, op.out.dtype,
                                            device)
                elif isinstance(salts, torch.Tensor):
                    val = prng.uniform_from(salts[n_rand, 0],
                                            salts[n_rand, 1], op.out.shape,
                                            op.out.dtype, device)
                else:
                    val = prng.uniform(seed, salts[n_rand], op.out.shape,
                                       op.out.dtype, device)
                n_rand += 1
            elif oc == "range":
                val = torch.arange(op.out.size, dtype=torch_dtype(
                    op.out.dtype), device=device).reshape(op.out.shape)
            elif oc == "gather":
                val = take(ins[0], ins[1], op.axis or 0)
            elif oc in _UNARY or oc in _BINARY or oc == "where":
                val = apply_op(oc, ins, device)
            else:
                raise NotImplementedError(f"opcode {oc!r}")
            ov = op.out
            env[ov.base.uid] = _write(env[ov.base.uid], ov, val, batched)
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

    Dispatch is asynchronous on a CUDA device: with no profiler attached
    nothing in the block loop synchronizes, so results only wait for the
    card at an explicit SYNC (``Runtime.materialize``).

    Thread-safe (DESIGN.md §18): the sessions of one runtime
    (``Runtime.session``) flush through one executor from many threads.
    One lock guards the executable cache (two threads that build the same
    block at once keep the first build) and the SYNC snapshot store; each
    dispatch's cache hit or miss and its ``blocks_run`` move together
    under the metrics registry's lock, so a snapshot never sees one
    without the other."""

    def __init__(self, seed: int = 0, backend="torch", device=None,
                 profiler=None, mesh=None, axis: Optional[str] = None):
        """``backend`` resolves to the preference-ordered candidate list of
        the lowering policy (``backends.default_stack``): ``"torch"`` runs
        every block on the floor; ``"triton"`` prefers the fused-block
        Triton kernel with the floor for the blocks it declines; a
        tuple/list names an explicit stack.  ``device`` is the CUDA card
        unless given.  ``profiler`` (a ``tuning.Profiler``) turns on
        per-block wall-time capture of warm dispatches: each is bracketed
        by ``torch.cuda.synchronize`` on a CUDA device and timed with
        ``time.perf_counter`` (the host's wrapper call, the launch and the
        kernel — what the cost model's ``launch_s`` and byte slope price),
        so profiling trades the asynchronous pipeline for honest walls.

        ``mesh`` (a 1-D ``DeviceMesh``, ``dist.host_mesh``) prepends the
        ``shard_map`` backend so sharded blocks run with real collectives,
        folds placement into the executable-cache key and declares the
        ``shard_map_blocks``/``collectives``/``interconnect_bytes`` stats.
        The store then holds each base the mesh can shard as a ``Shard(0)``
        DTensor (``dist.mesh.held_sharded``); a block another backend runs
        sees whole tensors, gathered first, and leaves this rank's chunk of
        a sharded output.  The mesh's device type must be the executor's."""
        from .backends import default_stack
        self.seed = seed
        self.profiler = profiler
        self.backend = backend
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh under an "
                                 f"executor on {self.device}")
            self.axis = axis or mesh.mesh_dim_names[0]
            self.n_dev = int(mesh.size())
        else:
            self.axis = axis
            self.n_dev = 1
        self.backends: Tuple[str, ...] = default_stack(backend, mesh)
        self._cache: Dict[Tuple, object] = {}
        #: lowering decisions for plans the scheduler did not annotate
        self._decisions: Dict[Tuple, object] = {}
        self._lock = threading.RLock()
        self.sync_store: Dict[int, torch.Tensor] = {}
        self.metrics = MetricsRegistry()
        self.stats: StatsView = StatsView(self.metrics, prefix="executor")
        self.reset_stats()

    # -- stats ---------------------------------------------------------
    def reset_stats(self) -> None:
        """Zero every counter (compiled executables and cached lowering
        decisions are kept — resetting is observation, not state).

        ``donated_buffers`` counts input buffers blocks overwrote in
        place; ``backend_blocks[name]`` counts dispatches per backend;
        ``backend_fallbacks[name][reason]`` counts, per backend the policy
        preferred over the one that ran, why it declined.  Under a
        triton-bearing policy every dispatched work block lands either in
        ``triton_blocks`` or in ``triton_fallback_blocks`` with its reason
        slug counted in ``triton_fallbacks`` (``codegen.REASONS``).

        Fused loops (:meth:`run_loop`): ``loop_flushes`` counts drains and
        ``loop_iterations`` the iterations they ran; ``loop_captures`` and
        ``loop_replays`` the CUDA graphs of loop bodies captured and their
        replays (one an iteration; none on the CPU); ``loop_state_copies``
        every copy the loop path makes of its state — into a static state
        buffer at a drain's start where the state is not already there, at
        an iteration's end where a block's carried output did not land in
        its buffer, and of another buffer or SYNC snapshot that shares a
        state buffer's storage, before a drain overwrites it.

        On a mesh (``shard_map`` in the stack): ``shard_map_blocks`` counts
        the dispatches that backend ran, ``collectives`` their unique
        collectives and ``interconnect_bytes`` their fabric bytes
        (``dist.reshard.block_comm_bytes``); a COMM op another backend runs
        is a local copy and counts in neither."""
        st = self.stats
        with self.metrics.lock:
            for key in ("blocks_run", "exec_cache_hits", "exec_cache_misses",
                        "donated_buffers", "triton_blocks",
                        "triton_fallback_blocks", "loop_flushes",
                        "loop_iterations", "loop_captures", "loop_replays",
                        "loop_state_copies"):
                st.declare_scalar(key)
            st.declare_group("triton_fallbacks", ("reason",))
            st.declare_group("backend_blocks", ("backend",),
                             presets=self.backends)
            st.declare_group("backend_fallbacks", ("backend", "reason"),
                             presets=self.backends)
            if "shard_map" in self.backends:
                st.declare_scalar("shard_map_blocks")
                st.declare_scalar("collectives")
                st.declare_scalar("interconnect_bytes", 0.0)
            else:
                for key in ("shard_map_blocks", "collectives",
                            "interconnect_bytes"):
                    st.drop(key)

    def snapshot_stats(self) -> Dict:
        """Plain nested-dict copy of the counters, for before/after flush
        deltas (``stats_delta``)."""
        return self.stats.snapshot()

    # -- policy --------------------------------------------------------
    def lowering_context(self, contract_fma: bool = False):
        """The context this executor's blocks are built under;
        ``contract_fma`` (a ``gpu_fma`` runtime's) picks B1's contracting
        form."""
        from .backends import LoweringContext
        return LoweringContext(seed=self.seed, device=self.device,
                               mesh=self.mesh, axis=self.axis,
                               n_dev=self.n_dev, contract_fma=contract_fma)

    def lowering_policy(self, contract_fma: bool = False):
        """What ``Runtime.flush`` hands ``Scheduler.plan`` so the lower
        stage decides per block which of this executor's backends runs it
        (``Runtime.lowering_policy`` passes its cost model's
        ``contract_fma``); the schedule carries its context to
        :meth:`run_schedule`."""
        from .backends import LoweringPolicy
        return LoweringPolicy(backends=self.backends,
                              ctx=self.lowering_context(contract_fma))

    def topology_key(self) -> Tuple:
        """The device/mesh identity a plan is valid for, mixed into the
        merge-cache key (``()`` on a single-device executor)."""
        if self.mesh is None:
            return ()
        from .dist.mesh import topology_key
        return topology_key(self.mesh)

    def run(self, tape: Sequence[Op], op_blocks: Sequence[Sequence[int]],
            buffers: Dict[int, torch.Tensor]) -> None:
        """Legacy front door: plan the blocks, then execute the schedule."""
        from .scheduler import Schedule, plan_blocks   # local: avoid cycle
        self.run_schedule(Schedule(tape=list(tape),
                                   blocks=plan_blocks(tape, op_blocks)),
                          buffers)

    # -- dispatch ------------------------------------------------------
    def _decide(self, ops: Sequence[Op], plan, ctx):
        """Lowering decision for a plan the scheduler did not annotate
        (legacy :meth:`run`, hand-built schedules) — the same selection
        rule, cached by the plan's signature so steady-state dispatches
        skip the probing."""
        from .backends import select_lowering
        key = plan.signature
        if self.mesh is not None:       # decisions depend on placement
            from .dist.spec import placement_digest
            key = (key, placement_digest(ops))
        with self._lock:
            d = self._decisions.get(key)
        if d is None:
            d = select_lowering(ops, plan, self.backends, ctx)
            with self._lock:
                self._decisions[key] = d
        return d

    def _executable(self, decision, ops: Sequence[Op], plan, ctx):
        """Look up (or build) the executable for one decided plan.
        Returns ``(fn, warm)``: ``warm`` is True on a cache hit (the
        profiler times only warm dispatches — a cold one includes the
        kernel's generation).  The key is the backend, the plan's
        signature and the backend's ``cache_token`` (``shard_map`` folds in
        placement, so one signature never serves two shardings)."""
        from .backends import get_backend
        key = ((decision.backend, plan.signature)
               + tuple(get_backend(decision.backend).cache_token(
                   ops, plan, ctx)))
        with self._lock:
            fn = self._cache.get(key)
        if fn is not None:
            trace.instant("cache.exec", hit=True, backend=decision.backend)
            return fn, True
        trace.instant("cache.exec", hit=False, backend=decision.backend)
        with trace.span("build", backend=decision.backend, n_ops=len(ops)):
            fn = get_backend(decision.backend).build(ops, plan, ctx)
        with self._lock:   # a concurrent build of the same block: keep one
            fn = self._cache.setdefault(key, fn)
        return fn, False

    def _synchronize(self) -> None:
        """Wait for the card (the profiler's brackets); the CPU's torch ops
        have finished when they return."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _account(self, decision, warm: bool) -> None:
        """Count one dispatch: its executable-cache hit (``warm``) or miss
        with ``blocks_run`` and its backend, as one update of the
        registry."""
        st = self.stats
        with self.metrics.lock:
            st.inc("exec_cache_hits" if warm else "exec_cache_misses")
            st.inc("blocks_run")
            st.inc("backend_blocks", labels=(decision.backend,))
            for name, reason in decision.declined:
                st.inc("backend_fallbacks", labels=(name, reason))
            if decision.backend == "shard_map":
                st.inc("shard_map_blocks")
            if decision.backend == "triton":
                st.inc("triton_blocks")
            else:
                reason = decision.reason_for("triton")
                if reason is not None:
                    st.inc("triton_fallback_blocks")
                    st.inc("triton_fallbacks", labels=(reason,))

    @staticmethod
    def _grant(plan, in_bufs: Sequence[torch.Tensor],
               refs: Counter) -> FrozenSet[int]:
        """Input positions a block may overwrite: the donatable ones and
        those of a base the block rewrites, whose storage no other buffer
        and no SYNC snapshot holds (``refs`` counts the holders of each
        storage)."""
        outs = set(plan.outputs)
        return frozenset(
            k for k, u in enumerate(plan.inputs)
            if (k in plan.donatable or u in outs)
            and refs[_storage(in_bufs[k])] == 1)

    def run_schedule(self, schedule, buffers: Dict[int, torch.Tensor]) -> None:
        """Dispatch a planned flush against the buffer store.

        ``schedule`` is the :class:`repro_torch.core.scheduler.Schedule`
        produced by ``Scheduler.plan``; ``buffers`` maps base uid -> flat
        device tensor and is updated with each block's outputs.  Per block:
        take the plan's lowering decision (or decide now), look up (or
        build) the executable under ``(backend, signature)``, feed the
        external input buffers plus the RNG salts (and, to a backend that
        donates, the input positions it may overwrite), then honor SYNC
        (snapshot into ``sync_store``) and DEL (free) in Bohrium order.
        With a profiler attached, each warm dispatch is timed between two
        synchronizations and recorded.  On a mesh, a block that a backend
        other than ``shard_map`` runs gets its sharded inputs whole and
        leaves this rank's chunk of each sharded output
        (:meth:`_chunked`)."""
        from .backends import get_backend
        tape = schedule.tape
        ctx = schedule.ctx if schedule.ctx is not None \
            else self.lowering_context()
        # holders of each storage: buffers and SYNC snapshots (other
        # sessions' snapshots share no storage with this store's buffers
        # but rows of one batched dispatch, which they can only make
        # conservative)
        with self._lock:
            snapshots = list(self.sync_store.values())
        refs = Counter(_storage(b) for b in (*buffers.values(), *snapshots))

        def hold(store: Dict[int, torch.Tensor], u: int, buf) -> None:
            with self._lock:      # the SYNC store is every session's
                old = store.pop(u, None)
                if old is not None:
                    refs[_storage(old)] -= 1
                if buf is not None:
                    store[u] = buf
                    refs[_storage(buf)] += 1

        with trace.span("stage.execute", n_blocks=len(schedule.blocks)):
            for plan in schedule.blocks:
                ops = [tape[i] for i in plan.op_indices]
                if plan.has_work:
                    decision = plan.lowering
                    if decision is None:        # a schedule planned without
                        decision = self._decide(ops, plan, ctx)   # a policy
                    fn, warm = self._executable(decision, ops, plan, ctx)
                    self._account(decision, warm)
                    in_bufs = []
                    for u in plan.inputs:
                        if u not in buffers:
                            raise RuntimeError(
                                f"base {u} read before definition")
                        in_bufs.append(buffers[u])
                    placed = (self.mesh is not None
                              and decision.backend != "shard_map")
                    if placed:       # the collective XLA inserts where the
                        from .dist.mesh import whole  # reference's floor
                        in_bufs = [whole(b) for b in in_bufs]  # reads a
                        # sharded global array
                    salts = tuple(getattr(op, "salt", op.uid) % (2**31 - 1)
                                  for op in ops if not op.is_system()
                                  and op.opcode == "random")
                    kw = {}
                    if get_backend(decision.backend).donates:
                        kw["reuse"] = self._grant(plan, in_bufs, refs)
                    timing = warm and self.profiler is not None
                    with trace.span("block", backend=decision.backend,
                                    n_ops=len(plan.op_indices)):
                        if timing:
                            # drain queued work: the clock sees one block
                            self._synchronize()
                            t0 = time.perf_counter()
                        out_bufs = fn(*in_bufs, salts, **kw)
                        if timing:
                            self._synchronize()
                            self.profiler.record(decision.backend, ops, plan,
                                                 ctx,
                                                 time.perf_counter() - t0)
                    if placed:
                        out_bufs = self._chunked(out_bufs, ops, plan.outputs)
                    get_backend(decision.backend).post_dispatch(
                        ops, plan, ctx, self.stats)
                    pos = {u: k for k, u in enumerate(plan.inputs)}
                    reused = sum(1 for u, b in zip(plan.outputs, out_bufs)
                                 if u in pos and b is in_bufs[pos[u]])
                    if reused:
                        self.stats.inc("donated_buffers", reused)
                    for u, b in zip(plan.outputs, out_bufs):
                        hold(buffers, u, b)
                for op in ops:  # SYNC snapshots before DEL (Bohrium order)
                    for b in op.sync_bases:
                        if b.uid in buffers:
                            hold(self.sync_store, b.uid, buffers[b.uid])
                    for b in op.del_bases:
                        hold(buffers, b.uid, None)

    def _chunked(self, bufs: Sequence[torch.Tensor], ops: Sequence[Op],
                 uids: Sequence[int]) -> List:
        """The store form of a block's whole outputs ``bufs`` (bases
        ``uids``) on a mesh: each output of a base the mesh holds sharded
        becomes a copy of this rank's chunk as a DTensor (a copy, so the
        rest of the whole tensor is freed)."""
        from .dist.mesh import as_sharded, chunk_of, held_sharded
        bases = {v.base.uid: v.base for op in ops
                 for v in (*op.in_views(), *op.out_views())}
        return [as_sharded(chunk_of(b, self.mesh).clone(), self.mesh)
                if held_sharded(bases[u], self.n_dev) else b
                for u, b in zip(uids, bufs)]

    def run_loop(self, loop_plan, buffers: Dict[int, torch.Tensor],
                 state_uids: Sequence[int], inv_uids: Sequence[int],
                 salts: Sequence[Sequence[int]],
                 unroll: int, ctx=None) -> Tuple[torch.Tensor, ...]:
        """Run ``len(salts)`` iterations of a recurring flush as one fused
        loop (cross-flush loop fusion, ``core/loop.py``); returns the final
        state buffers.

        ``loop_plan`` is the scheduler's :class:`~repro_torch.core.
        scheduler.LoopPlan`.  The state is ``buffers[u]`` for ``u`` in
        ``state_uids`` (one per tape-level output, canonical order: the
        last executed flush's outputs), the loop invariants ``buffers[u]``
        for ``u`` in ``inv_uids`` (the inputs the mapping marks ``inv``),
        and ``salts`` holds one row per iteration: the salts of its
        ``random`` ops in the body's block order.  ``unroll`` is the most
        iterations a drain of this loop runs (the rows of the body's key
        table).

        The loop body (``backends.loop_body.build_loop_fn``) is built once
        per plan key and owns static state and invariant buffers: a state
        is copied into them only where it is not already there (after the
        first drain it is: the final state returned is those buffers), an
        invariant only when its storage changed, and the invariant's store
        entry then becomes the static buffer.  The loop overwrites the
        state buffers in place, so any other store entry or SYNC snapshot
        that shares their storage is copied off first.  On a CUDA device
        the body's one iteration is a CUDA graph replayed once an
        iteration; on the CPU it runs eagerly.  ``ctx`` is the lowering
        context the body's blocks are built under (this executor's
        default when None); its ``contract_fma`` is part of the body's
        key."""
        from .backends.loop_body import build_loop_fn
        ctx = ctx if ctx is not None else self.lowering_context()
        key = ("loop", loop_plan.key, ctx.contract_fma)
        n = len(salts)
        st = self.stats
        with trace.span("stage.execute", loop=True, n_iterations=n):
            with self._lock:
                body = self._cache.get(key)
            if body is not None:
                st.inc("exec_cache_hits")
                trace.instant("cache.exec", hit=True, loop=True)
            else:
                st.inc("exec_cache_misses")
                trace.instant("cache.exec", hit=False, loop=True)
                with trace.span("build", loop=True,
                                n_ops=len(loop_plan.tape)):
                    body = build_loop_fn(loop_plan.tape, loop_plan.plans,
                                         loop_plan.input_sources,
                                         loop_plan.tape_inputs,
                                         loop_plan.tape_outputs,
                                         ctx, unroll)
                with self._lock:
                    self._cache[key] = body
            state = [buffers[u] for u in state_uids]
            invariants = [buffers[u] for u in inv_uids]
            body.allocate(state, invariants)
            keep = set(state_uids)
            slots = {_storage(b) for b in body.slots}
            moved = 0
            with self._lock:      # the SYNC store is every session's
                for store in (buffers, self.sync_store):
                    for u, b in list(store.items()):
                        if _storage(b) in slots and not (store is buffers
                                                         and u in keep):
                            store[u] = b.clone()
                            moved += 1
            moved += body.bind(state, invariants)
            for u, b in zip(inv_uids, body.inv):
                buffers[u] = b
            captures, replays = body.captures, body.replays
            copies = body.run(salts, self.seed)
            st.inc("loop_flushes")
            st.inc("loop_iterations", n)
            st.inc("loop_captures", body.captures - captures)
            st.inc("loop_replays", body.replays - replays)
            st.inc("loop_state_copies", moved + copies)
            st.inc("donated_buffers", sum(
                1 for b, s in zip(state, body.slots) if b is s))
        return tuple(body.slots)

    def run_batch(self, schedule, tape_inputs: Sequence[int],
                  tape_outputs: Sequence[int],
                  in_cols: Sequence[Sequence[torch.Tensor]],
                  salt_rows: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """Dispatch B structurally identical flushes as ONE batched call
        (cross-request micro-batching, DESIGN.md §18).

        ``schedule`` is the lead request's planned flush (every work block
        on the ``torch`` floor), ``tape_inputs``/``tape_outputs`` its
        tape-level io in canonical ``cache.tape_io`` order, ``in_cols`` one
        column per input position (each a length-B list of flat buffers,
        request order) and ``salt_rows`` one row per request of that
        request's ``random``-op salts (schedule work-block order).  Returns
        one ``(B, size)`` stacked buffer per output position; the caller
        hands row ``r`` to request ``r``'s buffer store.  Those rows are
        views of one tensor, each its own elements: safe because the floor
        never writes a buffer in place, and a later block that does (B1
        under a donation grant) writes only the elements of its own row.

        The salts are host ints, so each request's key words are computed
        here (``prng.key_words``) and go to the batch as one ``(B, n_rand,
        2)`` int64 tensor: a request draws exactly what its solo flush
        draws.  The executable (``backends.batch_body.build_batch_fn``) is
        cached under ``("serve_batch", plan key, B)``, built once per key
        (two threads that build it at once keep the first build)."""
        from .backends.batch_body import build_batch_fn
        B = len(salt_rows)
        plan_key = (schedule.key if schedule.key is not None
                    else tuple(p.signature for p in schedule.blocks))
        key = ("serve_batch", plan_key, B)
        with trace.span("serve.batch", n_requests=B):
            with self._lock:
                cached = self._cache.get(key)
            hit = cached is not None
            trace.instant("cache.exec", hit=hit, batch=True)
            if not hit:
                with trace.span("build", batch=True,
                                n_ops=len(schedule.tape)):
                    built = build_batch_fn(schedule.tape, schedule.blocks,
                                           tuple(tape_inputs),
                                           tuple(tape_outputs),
                                           self.lowering_context())
                with self._lock:
                    cached = self._cache.setdefault(key, built)
            fn, n_rand = cached
            self.stats.inc("exec_cache_hits" if hit else "exec_cache_misses")
            self.metrics.counter("serve.batch.dispatches").inc()
            self.metrics.counter("serve.batch.requests").inc(B)
            stacked = tuple(torch.stack(list(col)) for col in in_cols)
            words = torch.tensor(
                [[prng.key_words(self.seed, s) for s in row]
                 for row in salt_rows], dtype=torch.int64,
                device=self.device).reshape(B, n_rand, 2)
            return list(fn(stacked, words))


def _storage(t: torch.Tensor) -> int:
    """Identity of a tensor's storage (tensors that share it alias; a
    sharded buffer's is its local chunk's)."""
    local = getattr(t, "to_local", None)
    if local is not None:
        t = local()
    return t.untyped_storage().data_ptr()
