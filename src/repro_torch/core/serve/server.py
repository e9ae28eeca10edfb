"""Multi-tenant serving front door (DESIGN.md §18) — the port of
``repro/core/serve/server.py``.

A :class:`Server` owns one shared :class:`~repro_torch.core.lazy.Runtime`
and hands every tenant a private session (``Runtime.session``): sessions
share the merge cache, plan store, executable cache and metrics — the
expensive, thread-safe state — while each keeps its own tape and buffer
store, so N tenants trace and flush concurrently from N threads.  Every
session issues its work on the device's current (default) stream: one
tenant's read of its results waits for whatever the other tenants queued
before it.

Request lifecycle (``submit``):

1. **admission** — acquire a bounded-queue slot (backpressure, per-tenant
   fairness; ``serve.admission.*``);
2. **trace** — run the request function under the tenant's session (its
   lock serializes requests *within* a tenant only);
3. **execute** — either a plain per-session flush, or — when batching is
   on and the tape qualifies — join a micro-batch window: structurally
   identical tapes from different tenants coalesce onto ONE batched
   dispatch of the shared block plan (``backends.batch_body``), each
   request contributing its own input buffers and RNG salts;
4. **materialize** — read the request's outputs to host arrays, record the
   output DELs deterministically, release the slot.

Micro-batch window semantics: the first request to arrive with a given
merge-cache signature becomes the *leader*, opens a group and waits up to
``window_s`` (or until ``max_batch`` members); followers joining within
the window park on the group.  The leader closes the group, plans ONCE on
its own tape (hitting merge cache / plan store like any flush), gathers
every member's input columns and salt rows, runs the batched dispatch,
and hands each member its output row; members then do their own session
bookkeeping on their own thread.  A group of one — or a plan that lowers
any work block to anything but the ``torch`` floor (the reference's rule
for its ``xla`` floor: under ``backend="triton"``, every request whose
blocks the fused-block kernel claims) — runs the per-session flush path,
bit-identical either way.

Request functions must RETURN lazy arrays, not materialize them: calling
``.numpy()`` inside ``fn`` flushes the session early and forfeits (only)
the batching opportunity.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from ..cache import tape_io
from ..dist import tape_has_sharding
from ..dist.mesh import whole
from ..executor import _read
from ..lazy import LazyArray, Runtime
from ..obs import trace
from ..scheduler import merge_key
from .admission import AdmissionController, ServeRejected   # noqa: F401
from .store import PlanStore


def _host(buf, view) -> np.ndarray:
    """One array's value on the host, in memory of its own (one copy, from
    the device or, on the CPU, out of the buffer; a sharded buffer is
    gathered first)."""
    return _read(whole(buf), view).to("cpu", copy=True).numpy()


class _Group:
    """One open micro-batch window (all members share a tape signature)."""

    __slots__ = ("key", "reqs", "full", "closed")

    def __init__(self, key: Tuple):
        self.key = key
        self.reqs: List["_Request"] = []
        self.full = threading.Event()
        self.closed = False


class _Request:
    """One in-flight request parked in a micro-batch group."""

    __slots__ = ("sess", "tape", "arrs", "out_uids", "out_bufs", "error",
                 "done")

    def __init__(self, sess: Runtime, tape, arrs: Sequence[LazyArray]):
        self.sess = sess
        self.tape = tape
        self.arrs = arrs
        self.out_uids: Tuple[int, ...] = ()
        #: per-output (size,) buffers from the batched dispatch; None means
        #: "execute your tape yourself" (group of one / non-batchable plan)
        self.out_bufs = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


class Server:
    """Thread-safe multi-tenant front door over one shared runtime.

    Without a ``runtime`` it builds one from ``runtime_kw`` (loop fusion
    off), which runs on the CUDA card unless ``device`` names another and
    raises when there is none."""

    def __init__(self, runtime: Optional[Runtime] = None, *,
                 window_s: float = 0.002, max_batch: int = 8,
                 max_pending: int = 64, per_tenant: Optional[int] = None,
                 batching: bool = True, store=None, **runtime_kw):
        if runtime is None:
            if store is not None:
                runtime_kw.setdefault("plan_store", store)
            runtime = Runtime(loop_fusion=False, **runtime_kw)
        elif store is not None:
            if not isinstance(store, PlanStore):
                store = PlanStore(store)
            store.bind_metrics(runtime.executor.metrics)
            runtime.scheduler.plan_store = store
        self.runtime = runtime
        self.metrics = runtime.executor.metrics
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self.batching = bool(batching)
        self.admission = AdmissionController(max_pending, per_tenant,
                                             metrics=self.metrics)
        self._sessions: Dict[Hashable, Tuple[Runtime, threading.Lock]] = {}
        self._slock = threading.Lock()
        self._groups: Dict[Tuple, _Group] = {}
        self._glock = threading.Lock()

    # -- sessions ------------------------------------------------------
    def session(self, tenant: Hashable) -> Tuple[Runtime, threading.Lock]:
        """The tenant's (session, lock) pair, created on first use."""
        with self._slock:
            ent = self._sessions.get(tenant)
            if ent is None:
                ent = (self.runtime.session(), threading.Lock())
                self._sessions[tenant] = ent
            return ent

    # -- the front door ------------------------------------------------
    def submit(self, tenant: Hashable, fn: Callable,
               timeout: Optional[float] = None):
        """Trace ``fn`` on the tenant's session and execute it; returns the
        materialized numpy value(s) of whatever lazy array(s) ``fn``
        returned (a single array in → a single ndarray out)."""
        self.admission.acquire(tenant, timeout=timeout)
        try:
            sess, lock = self.session(tenant)
            with lock, trace.span("serve.request", tenant=str(tenant)):
                if sess.tape:        # prior request's deferred output DELs
                    sess.flush()
                with sess.activate():
                    outs = fn()
                single = isinstance(outs, LazyArray)
                arrs = [outs] if single else list(outs)
                self.metrics.counter("serve.requests",
                                     ("tenant",)).inc(labels=(str(tenant),))
                if self.batching and self._batchable(sess, arrs):
                    vals = self._submit_batched(sess, arrs)
                else:
                    self.metrics.counter("serve.singles").inc()
                    vals = self._run_single(sess, arrs)
                return vals[0] if single else vals
        finally:
            self.admission.release(tenant)

    # -- execution paths -----------------------------------------------
    def _batchable(self, sess: Runtime, arrs: Sequence[LazyArray]) -> bool:
        tape = sess.tape
        if not tape or not sess.use_cache:
            return False
        if any(op.opcode == "sync" for op in tape):
            return False             # fn materialized mid-request
        if tape_has_sharding(tape):
            return False             # shard_map blocks are not vmap-safe
        live = set(sess.buffers)
        for op in tape:
            for v in (*op.in_views(), *op.out_views()):
                live.add(v.base.uid)
        return all(a.view.base.uid in live for a in arrs)

    def _run_single(self, sess: Runtime, arrs: Sequence[LazyArray]) -> List:
        """Per-session flush: the outputs are live, so the plain pipeline
        materializes them into the session's buffer store."""
        sess.flush()
        vals = [_host(sess.buffers[a.view.base.uid], a.view) for a in arrs]
        for a in arrs:
            a.delete()               # deterministic DEL, on this thread,
        return vals                  # inside the session lock

    def _signature(self, sess: Runtime, tape) -> Tuple:
        ex = sess.executor
        return merge_key(tape, sess.algorithm, sess.cost_model,
                         ex.lowering_policy(), sess.partition_backend,
                         ex.topology_key())

    def _submit_batched(self, sess: Runtime, arrs: Sequence[LazyArray]) -> List:
        tape, sess.tape = sess.tape, []
        sess._known = set()
        req = _Request(sess, tape, arrs)
        key = self._signature(sess, tape)
        with self._glock:
            g = self._groups.get(key)
            leader = g is None or g.closed or len(g.reqs) >= self.max_batch
            if leader:
                g = _Group(key)
                self._groups[key] = g
            g.reqs.append(req)
            if len(g.reqs) >= self.max_batch:
                g.full.set()
        if leader:
            g.full.wait(self.window_s)
            with self._glock:
                g.closed = True
                if self._groups.get(key) is g:
                    del self._groups[key]
            self._run_group(g)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return self._finish(req)

    def _run_group(self, g: _Group) -> None:
        """Leader-side: plan once, dispatch the whole window, hand each
        member its output row.  Member sessions are only *read* here (input
        buffers) — their owning threads are parked on ``req.done``."""
        reqs = g.reqs
        try:
            if len(reqs) > 1:
                self._run_batch(reqs)
            # a group of one keeps out_bufs=None: the member executes its
            # own tape through the ordinary per-session flush
        except BaseException as e:   # noqa: BLE001 — delivered per-request
            for r in reqs:
                r.error = e
        finally:
            for r in reqs:
                r.done.set()

    def _run_batch(self, reqs: List[_Request]) -> None:
        rt = self.runtime
        lead = reqs[0]
        sess = lead.sess
        sched = rt.scheduler.plan(
            lead.tape, algorithm=sess.algorithm, cost_model=sess.cost_model,
            node_budget=sess.node_budget, use_cache=True,
            topology=rt.executor.topology_key(),
            lowering=rt.executor.lowering_policy(),
            partition_backend=sess.partition_backend,
            time_budget_s=sess.time_budget_s)
        if any(p.lowering is not None and p.lowering.backend != "torch"
               for p in sched.blocks if p.has_work):
            return                   # not on the floor: members run solo
        ins_l, outs_l, _ = tape_io(lead.tape)
        salt_pos = [i for p in sched.blocks if p.has_work
                    for i in p.op_indices
                    if lead.tape[i].opcode == "random"]
        in_cols: List[List] = [[] for _ in ins_l]
        salt_rows: List[List[int]] = []
        io: List[Tuple] = []
        for r in reqs:
            ins_r, outs_r, _ = tape_io(r.tape)
            for j, u in enumerate(ins_r):
                buf = r.sess.buffers.get(u)
                if buf is None:
                    raise RuntimeError(f"base {u} read before definition")
                in_cols[j].append(buf)
            salt_rows.append([r.tape[i].salt % (2**31 - 1)
                              for i in salt_pos])
            io.append((ins_r, outs_r))
        stacked = rt.executor.run_batch(sched, ins_l, outs_l,
                                        in_cols, salt_rows)
        self.metrics.counter("serve.batches").inc()
        for r_idx, r in enumerate(reqs):
            r.out_uids = tuple(io[r_idx][1])
            r.out_bufs = [stacked[k][r_idx] for k in range(len(outs_l))]

    def _finish(self, req: _Request) -> List:
        """Member-side bookkeeping, on the owning thread under the session
        lock: put the output row into the session store, honor the tape's
        DELs, then materialize this request's arrays."""
        sess = req.sess
        if req.out_bufs is None:
            # solo: restore the captured tape and run the ordinary
            # pipeline (the merge cache makes this cheap)
            sess.tape = req.tape + sess.tape
            self.metrics.counter("serve.singles").inc()
            return self._run_single(sess, req.arrs)
        for u, b in zip(req.out_uids, req.out_bufs):
            sess.buffers[u] = b
        for op in req.tape:
            for base in op.del_bases:
                sess.buffers.pop(base.uid, None)
        sess.flushes += 1
        self.metrics.counter("serve.batched_requests").inc()
        vals = [_host(sess.buffers[a.view.base.uid], a.view)
                for a in req.arrs]
        for a in req.arrs:
            a.delete()
        return vals
