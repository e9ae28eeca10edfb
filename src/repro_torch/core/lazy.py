"""Lazy array front-end — the Bohrium bytecode recorder (paper Fig. 2), on
PyTorch.

``repro_torch.core.lazy`` is a drop-in-style NumPy subset, the port's copy
of ``repro.core.lazy``: operations on ``LazyArray`` record array bytecode
onto a tape instead of executing.  On a side effect (``.numpy()`` /
``sync``) the tape is partitioned by a WSP algorithm under a cost model,
each block runs as one executable, and results materialize.  ``DEL`` is
recorded when the last Python reference to a base drops (CPython
refcounting, as in Bohrium's Python front-end) or via explicit
``.delete()``.

Arrays default to float64, as in the reference (which turns on 64-bit
types).  A runtime runs on the CUDA device unless it is given
``device="cpu"``; without a card and without that choice it raises.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .algorithms import PartitionResult
from .cache import MergeCache
from .cost import contracts_fma
from .device import resolve_device
from .dist import insert_resharding, tape_has_sharding
from .dist.mesh import whole
from .dist.spec import sharding_ever_used
from .executor import BlockExecutor, _read, numpy_dtype, stats_delta
from .ir import BaseArray, Op, View
from .loop import LoopFuser
from .obs import trace
from .scheduler import Scheduler

Scalar = Union[int, float, bool]


class Runtime:
    """Owns the tape (stage 1 of the scheduler pipeline: trace), the buffer
    store, the staged scheduler (stages 2–5) and the executor (stage 6).

    Parameters
    ----------
    algorithm : WSP partitioner — ``"singleton"`` (no fusion), ``"linear"``,
        ``"greedy"`` (default) or ``"optimal"`` (branch & bound, small
        tapes); see ``repro_torch.core.algorithms``.
    cost_model : name registered in ``repro_torch.core.cost.make_cost_model``
        (``"bohrium"`` reproduces the paper; ``"gpu"`` prices device-memory
        time, launches and Triton kernel expressibility; ``"calibrated"``
        the same structure with the fit ``core.tuning`` installed;
        ``"gpu_fma"`` adds a bonus a multiply→add pair, and under it every
        block the triton backend runs is B1's contracting form, one fused
        multiply-add a pair — :meth:`lowering_policy`).
    use_cache : reuse block structure across structurally-identical flushes
        (the paper's merge cache, §IV-F).
    node_budget : cap on partitioner search nodes before falling back to
        greedy.
    seed : base PRNG seed for ``random`` ops (per-op salts keep draws
        partition-invariant, and the draws equal the reference's bits).
    backend : lowering-backend policy (``repro_torch.core.backends``).
        ``"torch"`` executes every block on the floor, one PyTorch call per
        op; ``"triton"`` prefers the fused-block Triton kernel (one kernel
        per block) with the floor for the blocks it declines; a tuple/list
        names an explicit preference-ordered backend stack.
    device : ``None`` (default) runs on the CUDA card and raises when there
        is none; ``"cpu"`` (or any torch device) runs there.
    mesh : optional 1-D ``DeviceMesh`` (``dist.host_mesh``) of the same
        device type; prepends the ``shard_map`` backend (real collectives
        for sharded blocks), keys plans by its topology and enables the
        resharding pass.  Every rank runs the same program (SPMD), and
        ``.numpy()`` of a sharded array gathers it on every rank.
    history_limit : cap on ``Runtime.history`` entries.
    profiler : optional ``repro_torch.core.tuning.Profiler``; when set, warm
        block dispatches are timed between two synchronizations of the
        card and recorded for cost-model calibration (``core.tuning``).
        Loop fusion stays off while one is attached (it needs per-block
        timings).
    loop_fusion : fuse across the flush boundary (DESIGN.md §16): when
        consecutive flushes re-trace a structurally identical tape with a
        consistent carried-state mapping, steady-state flushes are
        deferred and run in batches as one fused loop over the block
        schedule (``core/loop.py``; on a CUDA device one captured CUDA
        graph of an iteration, replayed once an iteration).  Bitwise the
        per-flush results; a materialization or a structure change first
        drains the queue in program order.  Pass ``False`` for per-flush
        semantics, e.g. to count per-flush stats or history entries.
    loop_threshold : recurrence hysteresis — a tape's first
        ``loop_threshold`` occurrences execute per-flush; deferral starts
        at occurrence ``loop_threshold + 1``.
    loop_unroll : most deferred iterations per fused loop (the rows of the
        loop body's key table).
    partition_backend : ``"greedy"`` (the classic per-``algorithm``
        sweep) or ``"ilp"``: the anytime branch-and-bound solver
        warm-started from greedy (``core.partition_ilp``), never costlier
        than greedy.
    time_budget_s : wall-clock cap for the ilp solver (None: the node
        budget only).
    plan_store : optional persistent plan cache (DESIGN.md §18): a
        ``repro_torch.core.serve.PlanStore`` or a directory path.  The
        scheduler probes it on a merge-cache miss and persists fresh plans,
        so a warm process start replays block plans and lowering decisions
        from disk without re-running graph, partition and lower.

    **Concurrency contract** (DESIGN.md §18).  One ``Runtime`` is
    single-threaded state: its tape, buffer store and refcounts have no
    locking, so exactly one thread may trace and flush it at a time.
    Concurrency goes through *sessions*: :meth:`session` returns a
    per-tenant ``Runtime`` with its own tape and buffers that SHARES this
    runtime's scheduler (merge cache, plan store) and executor (executable
    cache, SYNC store, metrics), which are thread-safe, so N threads may
    flush N sessions at once.  An array belongs to the session that
    recorded it.
    """

    def __init__(self, algorithm: str = "greedy", cost_model: str = "bohrium",
                 use_cache: bool = True, node_budget: int = 100_000,
                 seed: int = 0, backend="torch", device=None,
                 history_limit: int = 1024, profiler=None,
                 loop_fusion: bool = True,
                 loop_threshold: int = 3, loop_unroll: int = 32,
                 partition_backend: str = "greedy",
                 time_budget_s: Optional[float] = None, plan_store=None,
                 mesh=None, _scheduler: Optional[Scheduler] = None,
                 _executor: Optional[BlockExecutor] = None):
        self.algorithm = algorithm
        self.cost_model = cost_model
        self.use_cache = use_cache
        self.node_budget = node_budget
        self.partition_backend = partition_backend
        self.time_budget_s = time_budget_s
        self.device = resolve_device(device)
        self.tape: List[Op] = []
        self.buffers: Dict[int, torch.Tensor] = {}
        # sessions share their parent's planning and execution state (the
        # `_scheduler`/`_executor` private parameters); a root runtime
        # builds its own
        self.scheduler = (_scheduler if _scheduler is not None
                          else Scheduler(MergeCache()))
        self.cache = self.scheduler.cache
        self._loop = (LoopFuser(threshold=loop_threshold, unroll=loop_unroll)
                      if loop_fusion else None)
        self.executor = (_executor if _executor is not None
                         else BlockExecutor(seed=seed, backend=backend,
                                            device=self.device,
                                            profiler=profiler, mesh=mesh))
        if self.executor.device != self.device:
            raise ValueError(f"a runtime on {self.device} over an executor "
                             f"on {self.executor.device}")
        if plan_store is not None:
            from .serve.store import PlanStore
            if not isinstance(plan_store, PlanStore):
                plan_store = PlanStore(plan_store)
            plan_store.bind_metrics(self.executor.metrics)
            self.scheduler.plan_store = plan_store
        self._known: set = set()
        self._refcount: Dict[int, int] = {}
        self._bases: Dict[int, BaseArray] = {}
        self._flushing = False
        self._ordinal = 0            # runtime-local op counter (RNG salts)
        self.flushes = 0
        #: cumulative wall-clock spent inside ``flush`` (planning and
        #: dispatch, not the user program's op recording)
        self.flush_wall_s = 0.0
        self.last_partition: Optional[PartitionResult] = None
        #: the last tape handed to the scheduler (after resharding)
        self.last_tape: Optional[List[Op]] = None
        self._t_trace0: Optional[int] = None   # first record() of this tape
        #: per-flush records: planning stats plus an ``"exec"`` dict of
        #: per-flush executor stat deltas (NOT cumulative totals)
        self.history: "deque[Dict]" = deque(maxlen=history_limit)

    # -- recording -----------------------------------------------------
    def record(self, op: Op) -> None:
        if not self.tape:
            # stage 1 (trace) starts here; flush() emits the retroactive
            # ``stage.trace`` span from this timestamp
            self._t_trace0 = time.perf_counter_ns()
        # a base is pre-existing if it's on this tape already, in the buffer
        # store, or live in the deferred loop-fusion queue (its value has
        # not materialized yet but logically exists)
        live = self._loop.live if self._loop is not None else ()
        new = []
        for v in (*op.in_views(), *op.out_views()):
            u = v.base.uid
            if u not in self._known and u not in self.buffers \
                    and u not in live:
                new.append(v.base)
                self._known.add(u)
        if new:
            op.new_bases = frozenset(set(op.new_bases) | set(new))
        op.salt = self._ordinal      # deterministic per-program RNG salt
        self._ordinal += 1
        self.tape.append(op)

    def incref(self, base: BaseArray) -> None:
        self._refcount[base.uid] = self._refcount.get(base.uid, 0) + 1
        self._bases[base.uid] = base

    def decref(self, base: BaseArray) -> None:
        c = self._refcount.get(base.uid)
        if c is None:
            return
        if c <= 1:
            del self._refcount[base.uid]
            self._bases.pop(base.uid, None)
            if (base.uid in self._known or base.uid in self.buffers
                    or (self._loop is not None
                        and base.uid in self._loop.live)):
                self.record(Op("del", None, del_bases=frozenset({base})))
        else:
            self._refcount[base.uid] = c - 1

    # -- flushing ------------------------------------------------------
    def lowering_policy(self):
        """The executor's lowering policy under this runtime's cost model:
        its context carries ``contract_fma`` when the model is
        ``gpu_fma`` (``cost.contracts_fma``), so B1 builds its contracting
        form, cached apart from the bitwise one, and a later
        ``set_policy(cost_model=...)`` never reuses a kernel of the other
        form.  The torch floor never contracts."""
        return self.executor.lowering_policy(
            contract_fma=contracts_fma(self.cost_model))

    def flush(self) -> None:
        """Run the staged pipeline on the recorded tape: the scheduler plans
        (graph → partition → schedule → lower, with the merge cache
        short-circuiting partition and lower), then the executor dispatches
        the block plans.

        With loop fusion on, a recurring steady-state tape is *deferred*
        instead: the iteration is queued and run later — with the rest of
        its batch — as one fused loop (``LoopFuser.fuse``).  Calling
        ``flush()`` with an EMPTY tape drains any queued iterations, as
        does any tape that breaks the recurrence (a SYNC, a structure
        change)."""
        if self._flushing:
            return
        fus = self._loop
        if not self.tape:
            if fus is not None and fus.pending:
                self._flushing = True
                t0 = time.perf_counter()
                try:
                    with trace.context(flush=self.flushes), \
                         trace.span("flush", n_ops=0, drain=True):
                        fus.drain(self)
                finally:
                    self._flushing = False
                    dt = time.perf_counter() - t0
                    self.flush_wall_s += dt
                    self.executor.metrics.histogram(
                        "runtime.flush_wall_s").observe(dt)
            return
        self._flushing = True
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        try:
            tape, self.tape = self.tape, []
            with trace.context(flush=self.flushes), \
                 trace.span("flush", n_ops=len(tape)) as fsp:
                tr = trace.active()
                if tr is not None and self._t_trace0 is not None:
                    # stage 1 ran while the user program recorded ops; emit
                    # it retroactively from the first record() timestamp
                    tr.complete("stage.trace", self._t_trace0, t0_ns,
                                {"n_ops": len(tape), "flush": self.flushes})
                self._t_trace0 = None
                if sharding_ever_used() and tape_has_sharding(tape):
                    # placement disagreements become explicit COMM graph
                    # nodes BEFORE partitioning, so WSP prices interconnect
                    # traffic
                    tape = insert_resharding(tape)
                h0, m0 = self.cache.hits, self.cache.misses
                if fus is not None and fus.fuse(self, tape):
                    fsp.set(deferred=True)
                    self._known = set()
                    self.flushes += 1
                    return
                self.last_tape = tape
                sched = self.scheduler.plan(
                    tape, algorithm=self.algorithm,
                    cost_model=self.cost_model,
                    node_budget=self.node_budget,
                    use_cache=self.use_cache,
                    topology=self.executor.topology_key(),
                    lowering=self.lowering_policy(),
                    partition_backend=self.partition_backend,
                    time_budget_s=self.time_budget_s)
                if sched.result is not None:
                    self.last_partition = sched.result
                    entry = {"cost": sched.result.cost, "n_ops": len(tape),
                             "n_blocks": sched.result.n_blocks,
                             "cached": False, **sched.stats}
                else:
                    entry = {"n_ops": len(tape), "cached": True,
                             **sched.stats}
                entry["merge_hits"] = self.cache.hits - h0
                entry["merge_misses"] = self.cache.misses - m0
                fsp.set(n_blocks=len(sched.blocks),
                        cached=entry.get("cached", False))
                before = self.executor.snapshot_stats()
                self.executor.run_schedule(sched, self.buffers)
                entry["exec"] = stats_delta(before, self.executor.stats)
                if fus is not None:
                    fus.mark_executed()
                self.history.append(entry)
                self._known = set()
                self.flushes += 1
        finally:
            self._flushing = False
            dt = time.perf_counter() - t0
            self.flush_wall_s += dt
            self.executor.metrics.histogram(
                "runtime.flush_wall_s").observe(dt)

    def materialize(self, view: View) -> np.ndarray:
        self.record(Op("sync", None, sync_bases=frozenset({view.base})))
        self.flush()
        buf = self.buffers.get(view.base.uid)
        if buf is None:
            buf = self.executor.sync_store[view.base.uid]
        buf = whole(buf)             # a sharded one: every rank gathers it
        return np.array(_read(buf, view).cpu().numpy())

    def adopt(self, arr) -> "LazyArray":
        """Bring data into the runtime (no bytecode recorded).  A numpy array
        is copied to the runtime's device; a torch tensor is copied there
        from wherever it lies (device to device for a tensor already on a
        card), so the runtime owns every buffer it holds."""
        if isinstance(arr, torch.Tensor):
            flat = torch.empty(arr.numel(), dtype=arr.dtype,
                               device=self.device)
            flat.view(arr.shape).copy_(arr.detach())
            base = BaseArray(arr.numel(), numpy_dtype(arr.dtype))
            self.buffers[base.uid] = flat
            return LazyArray(self, View.contiguous(base, tuple(arr.shape)))
        arr = np.ascontiguousarray(arr)
        base = BaseArray(arr.size, arr.dtype)
        self.buffers[base.uid] = torch.from_numpy(
            arr.reshape(-1).copy()).to(self.device)
        return LazyArray(self, View.contiguous(base, arr.shape))

    # -- sessions (concurrent serving, DESIGN.md §18) ------------------
    def session(self, *, loop_fusion: bool = False, **kw) -> "Runtime":
        """A per-tenant runtime sharing this runtime's scheduler (merge
        cache + plan store) and executor (executable cache, metrics) but
        with private tape, buffers and refcounts.  Each session is
        single-threaded; N sessions may trace and flush concurrently from
        N threads.  It inherits the planning policy and this runtime's
        device and backend (the executor's).  Loop fusion defaults OFF in
        sessions — a serving request is usually one flush, and the fuser's
        deferral window would hold results hostage across requests."""
        kw.setdefault("algorithm", self.algorithm)
        kw.setdefault("cost_model", self.cost_model)
        kw.setdefault("use_cache", self.use_cache)
        kw.setdefault("node_budget", self.node_budget)
        kw.setdefault("partition_backend", self.partition_backend)
        kw.setdefault("time_budget_s", self.time_budget_s)
        kw.setdefault("device", self.device)
        return Runtime(loop_fusion=loop_fusion, backend=self.executor.backend,
                       _scheduler=self.scheduler, _executor=self.executor,
                       **kw)

    @contextlib.contextmanager
    def activate(self):
        """Make this runtime the calling thread's active runtime: the
        module-level constructors (``zeros``/``random``/…) and ``flush()``
        route here for the duration.  Thread-local — other threads'
        active runtimes are untouched."""
        prev = getattr(_active, "rt", None)
        _active.rt = self
        try:
            yield self
        finally:
            _active.rt = prev


#: process-default runtime, created on first use (what module-level ops use
#: when no runtime is activated on the calling thread)
_rt: Optional[Runtime] = None
#: per-thread active-runtime override (``Runtime.activate`` /
#: ``fresh_runtime``)
_active = threading.local()


def get_runtime() -> Runtime:
    """The calling thread's active runtime, else the process default (built
    on first use, on the CUDA card)."""
    global _rt
    rt = getattr(_active, "rt", None)
    if rt is not None:
        return rt
    if _rt is None:
        _rt = Runtime()
    return _rt


def set_policy(algorithm: Optional[str] = None, cost_model: Optional[str] = None,
               use_cache: Optional[bool] = None, node_budget: Optional[int] = None):
    rt = get_runtime()
    if algorithm is not None:
        rt.algorithm = algorithm
    if cost_model is not None:
        rt.cost_model = cost_model
    if use_cache is not None:
        rt.use_cache = use_cache
    if node_budget is not None:
        rt.node_budget = node_budget


@contextlib.contextmanager
def fresh_runtime(**kw):
    """Context manager giving an isolated runtime (tests/benchmarks),
    installed as the CALLING THREAD's active runtime.  Like ``Runtime``,
    it runs on the CUDA card unless given ``device="cpu"``."""
    prev = getattr(_active, "rt", None)
    rt = Runtime(**kw)
    _active.rt = rt
    try:
        yield rt
    finally:
        _active.rt = prev


# ---------------------------------------------------------------------------

class LazyArray:
    __array_priority__ = 100  # beat numpy in mixed expressions

    def __init__(self, rt: Runtime, view: View):
        self.rt = rt
        self.view = view
        rt.incref(view.base)
        self._alive = True

    def __del__(self):
        if getattr(self, "_alive", False):
            self._alive = False
            try:
                self.rt.decref(self.view.base)
            except Exception:
                pass

    def delete(self) -> None:
        """Explicit DEL (deterministic alternative to refcount timing)."""
        if self._alive:
            self._alive = False
            self.rt.decref(self.view.base)

    # -- geometry -------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.view.shape

    @property
    def ndim(self) -> int:
        return len(self.view.shape)

    @property
    def size(self) -> int:
        return self.view.size

    @property
    def dtype(self):
        return self.view.dtype

    @property
    def T(self) -> "LazyArray":
        v = self.view
        return LazyArray(self.rt, View(v.base, v.offset, v.shape[::-1],
                                       v.strides[::-1]))

    def transpose(self, *axes) -> "LazyArray":
        """Permute axes — a pure view (stride shuffle), records nothing."""
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        if not axes:
            return self.T
        assert sorted(axes) == list(range(self.ndim)), \
            f"bad permutation {axes!r} for ndim {self.ndim}"
        v = self.view
        return LazyArray(self.rt, View(v.base, v.offset,
                                       tuple(v.shape[a] for a in axes),
                                       tuple(v.strides[a] for a in axes)))

    def reshape(self, *shape) -> "LazyArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = tuple(int(s) for s in shape)
        if -1 in shape:
            rest = 1
            for s in shape:
                if s != -1:
                    rest *= s
            shape = tuple(self.size // rest if s == -1 else s for s in shape)
        if not self.view.is_contiguous():
            return self.copy().reshape(*shape)
        return LazyArray(self.rt, View.contiguous(self.view.base, shape,
                                                  self.view.offset))

    def broadcast_to(self, shape: Tuple[int, ...]) -> "LazyArray":
        v = self.view
        shape = tuple(int(s) for s in shape)
        pad = len(shape) - len(v.shape)
        src_shape = (1,) * pad + v.shape
        src_strides = (0,) * pad + v.strides
        strides = []
        for t, s, st in zip(shape, src_shape, src_strides):
            if s == t:
                strides.append(st)
            elif s == 1:
                strides.append(0)
            else:
                raise ValueError(f"cannot broadcast {v.shape} to {shape}")
        return LazyArray(self.rt, View(v.base, v.offset, shape, tuple(strides)))

    def __getitem__(self, key) -> "LazyArray":
        v = self.view
        if not isinstance(key, tuple):
            key = (key,)
        off, shape, strides = v.offset, [], []
        dim = 0
        for k in key:
            if isinstance(k, int):
                if k < 0:
                    k += v.shape[dim]
                off += k * v.strides[dim]
                dim += 1
            elif isinstance(k, slice):
                start, stop, step = k.indices(v.shape[dim])
                n = max(0, (stop - start + (step - (1 if step > 0 else -1))) // step)
                off += start * v.strides[dim]
                shape.append(n)
                strides.append(v.strides[dim] * step)
                dim += 1
            else:
                raise TypeError(f"unsupported index {k!r}")
        shape += list(v.shape[dim:])
        strides += list(v.strides[dim:])
        return LazyArray(self.rt, View(v.base, off, tuple(shape), tuple(strides)))

    def __setitem__(self, key, value) -> None:
        dst = self[key] if not (isinstance(key, slice) and key == slice(None)) else self
        _record_elementwise(self.rt, "copy", dst.view,
                            (dst._coerce(value, dst.shape),))

    # -- arithmetic -------------------------------------------------------
    def _coerce(self, other, shape):
        if isinstance(other, LazyArray):
            if other.shape != shape:
                return other.broadcast_to(shape).view
            return other.view
        if isinstance(other, np.ndarray):
            la = self.rt.adopt(other)
            return la.broadcast_to(shape).view if la.shape != shape else la.view
        return float(other)

    def _binop(self, other, opcode, reverse=False) -> "LazyArray":
        shape = self.shape
        if isinstance(other, (LazyArray, np.ndarray)):
            oshape = other.shape
            shape = tuple(np.broadcast_shapes(self.shape, oshape))
        me = self.view if self.shape == shape else self.broadcast_to(shape).view
        ov = self._coerce(other, shape)
        dtype = self.dtype
        out = _alloc(self.rt, shape, dtype)
        args = (ov, me) if reverse else (me, ov)
        _record_elementwise(self.rt, opcode, out.view, args)
        return out

    def __add__(self, o): return self._binop(o, "add")
    def __radd__(self, o): return self._binop(o, "add", True)
    def __sub__(self, o): return self._binop(o, "sub")
    def __rsub__(self, o): return self._binop(o, "sub", True)
    def __mul__(self, o): return self._binop(o, "mul")
    def __rmul__(self, o): return self._binop(o, "mul", True)
    def __truediv__(self, o): return self._binop(o, "div")
    def __rtruediv__(self, o): return self._binop(o, "div", True)
    def __pow__(self, o): return self._binop(o, "pow")
    def __mod__(self, o): return self._binop(o, "mod")
    def __gt__(self, o): return self._binop(o, "greater")
    def __lt__(self, o): return self._binop(o, "less")
    def __neg__(self):
        out = _alloc(self.rt, self.shape, self.dtype)
        _record_elementwise(self.rt, "neg", out.view, (self.view,))
        return out

    def _iop(self, other, opcode) -> "LazyArray":
        ov = self._coerce(other, self.shape)
        _record_elementwise(self.rt, opcode, self.view, (self.view, ov))
        return self

    def __iadd__(self, o): return self._iop(o, "add")
    def __isub__(self, o): return self._iop(o, "sub")
    def __imul__(self, o): return self._iop(o, "mul")
    def __itruediv__(self, o): return self._iop(o, "div")

    # -- reductions ---------------------------------------------------------
    def _reduce(self, opcode: str, axis: Optional[int]) -> "LazyArray":
        if axis is None:
            r = self
            while r.ndim > 0:
                r = r._reduce(opcode, 0)
            return r
        if axis < 0:
            axis += self.ndim
        shape = self.shape[:axis] + self.shape[axis + 1:]
        out = _alloc(self.rt, shape, self.dtype)
        op = Op(opcode, out.view, (self.view,), axis=axis)
        self.rt.record(op)
        return out

    def sum(self, axis: Optional[int] = None): return self._reduce("reduce_sum", axis)
    def max(self, axis: Optional[int] = None): return self._reduce("reduce_max", axis)
    def min(self, axis: Optional[int] = None): return self._reduce("reduce_min", axis)
    def prod(self, axis: Optional[int] = None): return self._reduce("reduce_prod", axis)

    # -- materialization ------------------------------------------------------
    def copy(self) -> "LazyArray":
        out = _alloc(self.rt, self.shape, self.dtype)
        _record_elementwise(self.rt, "copy", out.view, (self.view,))
        return out

    def numpy(self) -> np.ndarray:
        return self.rt.materialize(self.view)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self) -> float:
        return float(self.numpy())

    def __float__(self) -> float:
        return self.item()

    def __repr__(self) -> str:
        return f"LazyArray(shape={self.shape}, dtype={self.dtype})"


# -- helpers ----------------------------------------------------------------

def _alloc(rt: Runtime, shape: Tuple[int, ...], dtype) -> LazyArray:
    size = 1
    for s in shape:
        size *= s
    base = BaseArray(max(size, 1), np.dtype(dtype))
    return LazyArray(rt, View.contiguous(base, tuple(shape)))


def _record_elementwise(rt: Runtime, opcode: str, out: View, inputs) -> None:
    rt.record(Op(opcode, out, tuple(inputs)))


# -- module-level API (NumPy-ish) ---------------------------------------------

def zeros(shape, dtype=np.float64) -> LazyArray:
    if isinstance(shape, int):
        shape = (shape,)
    rt = get_runtime()
    out = _alloc(rt, tuple(shape), dtype)
    _record_elementwise(rt, "copy", out.view, (0.0,))
    return out


def ones(shape, dtype=np.float64) -> LazyArray:
    return full(shape, 1.0, dtype)


def full(shape, value: Scalar, dtype=np.float64) -> LazyArray:
    if isinstance(shape, int):
        shape = (shape,)
    rt = get_runtime()
    out = _alloc(rt, tuple(shape), dtype)
    _record_elementwise(rt, "copy", out.view, (float(value),))
    return out


def empty(shape, dtype=np.float64) -> LazyArray:
    return zeros(shape, dtype)


def arange(n: int, dtype=np.float64) -> LazyArray:
    rt = get_runtime()
    out = _alloc(rt, (int(n),), dtype)
    rt.record(Op("range", out.view))
    return out


def random(shape, dtype=np.float64) -> LazyArray:
    if isinstance(shape, int):
        shape = (shape,)
    rt = get_runtime()
    out = _alloc(rt, tuple(shape), dtype)
    rt.record(Op("random", out.view))
    return out


def asarray(a) -> LazyArray:
    if isinstance(a, LazyArray):
        return a
    return get_runtime().adopt(np.asarray(a))


def _unary(name):
    def f(x: LazyArray) -> LazyArray:
        out = _alloc(x.rt, x.shape, x.dtype)
        _record_elementwise(x.rt, name, out.view, (x.view,))
        return out
    f.__name__ = name
    return f


sqrt = _unary("sqrt")
exp = _unary("exp")
log = _unary("log")
absolute = _unary("abs")
sin = _unary("sin")
cos = _unary("cos")
erf = _unary("erf")
tanh = _unary("tanh")
square = _unary("square")
rsqrt = _unary("rsqrt")
floor = _unary("floor")
sign = _unary("sign")
sigmoid = _unary("sigmoid")


def maximum(a: LazyArray, b, out: Optional[LazyArray] = None) -> LazyArray:
    dst = out if out is not None else _alloc(a.rt, a.shape, a.dtype)
    _record_elementwise(a.rt, "maximum", dst.view, (a.view, a._coerce(b, a.shape)))
    return dst


def minimum(a: LazyArray, b, out: Optional[LazyArray] = None) -> LazyArray:
    dst = out if out is not None else _alloc(a.rt, a.shape, a.dtype)
    _record_elementwise(a.rt, "minimum", dst.view, (a.view, a._coerce(b, a.shape)))
    return dst


def where(cond: LazyArray, a, b) -> LazyArray:
    def _dt(x):
        if isinstance(x, (LazyArray, np.ndarray)):
            return x.dtype
        return np.result_type(x)          # python scalar -> its numpy dtype
    out = _alloc(cond.rt, cond.shape, np.result_type(_dt(a), _dt(b)))
    _record_elementwise(cond.rt, "where", out.view,
                        (cond.view, cond._coerce(a, cond.shape),
                         cond._coerce(b, cond.shape)))
    return out


def matmul(a: LazyArray, b: LazyArray) -> LazyArray:
    """Matrix product, batched like ``jnp.matmul``: leading (batch) axes
    broadcast, the last two contract.  An opaque op — always its own fusion
    block (``fusion.OPAQUE_OPCODES``) lowered straight to ``torch.matmul``."""
    assert a.ndim >= 2 and b.ndim >= 2, (a.shape, b.shape)
    assert a.shape[-1] == b.shape[-2], (a.shape, b.shape)
    batch = tuple(np.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    out = _alloc(a.rt, batch + (a.shape[-2], b.shape[-1]), a.dtype)
    a.rt.record(Op("matmul", out.view, (a.view, b.view)))
    return out


def concatenate(arrays, axis: int = -1) -> LazyArray:
    """Concatenate along ``axis`` — lowered to one fresh base plus a window
    ``copy`` per piece, so the copies fuse with equal-domain producers."""
    arrays = [a if isinstance(a, LazyArray) else asarray(a) for a in arrays]
    assert arrays, "need at least one array"
    a0 = arrays[0]
    if axis < 0:
        axis += a0.ndim
    for a in arrays[1:]:
        assert a.shape[:axis] + a.shape[axis + 1:] == \
            a0.shape[:axis] + a0.shape[axis + 1:], (a.shape, a0.shape)
    total = sum(a.shape[axis] for a in arrays)
    shape = a0.shape[:axis] + (total,) + a0.shape[axis + 1:]
    out = _alloc(a0.rt, shape, a0.dtype)
    off = 0
    for a in arrays:
        key = (slice(None),) * axis + (slice(off, off + a.shape[axis]),)
        out[key] = a
        off += a.shape[axis]
    return out


def take(a: LazyArray, idx, axis: int = 0) -> LazyArray:
    """Gather ``a``'s elements at ``idx`` along ``axis`` (NumPy ``take``).

    Records a ``gather`` op: ``out[i...] = a[..., idx[i...], ...]``.  The
    output has ``idx``'s shape along the indexed axis; for 1-D ``a`` the
    output shape IS ``idx.shape``.  Indices are float-carried on the tape
    (the runtime is float-typed) and truncated to int at execution; the
    gather fuses with elementwise producers/consumers of its output and
    index — only writers of the gathered table are fusion barriers
    (``fusion.fusible``)."""
    idx = asarray(idx) if not isinstance(idx, LazyArray) else idx
    if axis < 0:
        axis += a.ndim
    assert 0 <= axis < a.ndim, f"axis {axis} out of range for ndim {a.ndim}"
    shape = a.shape[:axis] + idx.shape + a.shape[axis + 1:]
    out = _alloc(a.rt, shape, a.dtype)
    a.rt.record(Op("gather", out.view, (a.view, idx.view), axis=axis))
    return out


def sync(*arrays: LazyArray) -> None:
    for a in arrays:
        a.rt.record(Op("sync", None, sync_bases=frozenset({a.view.base})))
    if arrays:
        arrays[0].rt.flush()


def flush() -> None:
    get_runtime().flush()
