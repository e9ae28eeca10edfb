"""Cross-flush loop fusion: the tape-recurrence detector (DESIGN.md §16) —
the port of ``repro/core/loop.py``.

The paper fuses operations *within* one flush; iterative programs re-trace a
structurally identical tape every timestep, so even with a warm merge cache
each step pays per-block executable dispatch and plan replay.  The
:class:`LoopFuser` watches consecutive flushes: when a tape recurs — equal
structure (``cache.tapes_structurally_equal``) with a consistent
carried-state mapping from this flush's inputs to the previous flush's
outputs (``cache.carried_state_mapping``) — more than ``threshold`` times,
subsequent flushes are *deferred*: the runtime queues the iteration (just
its RNG salts and io bookkeeping) instead of executing it, and a later
*drain* runs the whole queue as ONE fused loop over the block schedule
(``BlockExecutor.run_loop``; on a CUDA device one captured iteration
replayed once an iteration, ``backends/loop_body.py``).  Per-iteration
planning and Python dispatch disappear; the carried bases become loop
state.

Deferral is only legal when nothing observes intermediate state: the
carried-state mapping's supersession rule guarantees every deferred
iteration's outputs are overwritten or deleted by the next, so only the
final state must materialize.  Any tape that breaks the pattern — different
structure, a SYNC (materialization), a changed carried mapping — first
drains the queue (preserving program order), then executes normally.
Hysteresis (``threshold``) keeps one-off tapes on the per-flush path;
``unroll`` bounds the queue so a drain happens at least every ``unroll``
iterations, and the loop body is built once per structure (its key table
holds ``unroll`` rows, so every drain size shares it).

Bitwise fidelity: the loop body is composed from the *same* per-block
backend builders the per-flush path dispatches, and each iteration's
``random`` ops read the key words of their own trace-time salts from a
device key table — a loop-fused run produces bit-identical buffers to the
per-flush run (differentially tested; fuzzed by
``repro_torch.testing.tapegen``'s iterative mode).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from .cache import (TapeMatcher, carried_state_mapping, tape_io,
                    tapes_structurally_equal)
from .obs import trace

_SALT_MOD = 2 ** 31 - 1       # matches BlockExecutor.run_schedule's salts


class LoopFuser:
    """Per-runtime recurrence tracker + deferred-flush queue.

    ``threshold`` is the hysteresis: a tape's first ``threshold``
    occurrences execute per-flush (warming the merge cache and proving the
    carried mapping stable); from occurrence ``threshold + 1`` on, flushes
    defer.  ``unroll`` caps the deferred queue (and sizes the loop
    body's key table)."""

    def __init__(self, threshold: int = 3, unroll: int = 32):
        self.threshold = max(1, int(threshold))
        self.unroll = max(1, int(unroll))
        self.streak = 0                       # consecutive recurrences seen
        self.mapping: Optional[Tuple] = None  # carried-state mapping
        self.loop_plan = None                 # scheduler.LoopPlan once armed
        #: queued iterations: (salt_row, store_dels, output_uids)
        self.pending: List[Tuple] = []
        #: uids logically live in the queue's final state but not yet in the
        #: buffer store — the front-end must treat them as existing bases
        #: (``Runtime.record``'s new-base detection, ``decref``'s DEL)
        self.live: set = set()
        self._live_key: Optional[Tuple[int, ...]] = None
        #: outputs of the last *executed* flush — seeds the loop state
        self.exec_outs: Optional[Tuple[int, ...]] = None
        self._last_tape = None
        self._last_io: Optional[Tuple] = None
        self._n_rand = 0
        #: compiled once at arm time: direct-field matcher for the armed
        #: structure (steady-state fast path) + tape positions of random ops
        self._matcher: Optional[TapeMatcher] = None
        self._salt_pos: Tuple[int, ...] = ()
        #: state-machine event log (obs/explain reads it); each entry is a
        #: dict with at least an ``"event"`` key — arm/defer/drain/break
        self.events: Deque[Dict] = deque(maxlen=256)
        self._arm_seq = 0            # async trace id for deferred windows

    def _event(self, event: str, **kv) -> None:
        """Record a state-machine transition: kept in :attr:`events` for
        explain reports AND mirrored as a trace instant when tracing."""
        self.events.append({"event": event, **kv})
        trace.instant(f"loop.{event}", **kv)

    # -- the flush handshake -------------------------------------------
    def fuse(self, rt, tape) -> bool:
        """Called by ``Runtime.flush`` with the recorded tape.  Returns True
        when the flush was deferred (queued; nothing to execute).  Returns
        False when the flush must execute per-flush — having first drained
        any queued iterations so program order is preserved."""
        armed = self._matcher is not None
        matched = self._observe(rt, tape)
        # Once armed, the tape-side conditions (no SYNC, has work, outputs)
        # are structural facts the matcher re-certified — only the session
        # conditions need rechecking per flush.
        reason = (self._session_block_reason(rt)
                  if armed and self.loop_plan is not None
                  else self._defer_block_reason(rt, tape))
        if not (matched and self.streak >= self.threshold and reason is None):
            if matched and self.streak >= self.threshold:
                # the recurrence held but this flush can't defer — a
                # session/tape condition, not a structure break
                self._event("break", reason=reason, streak=self.streak)
            if self.pending:
                self.drain(rt)
            return False
        if self.loop_plan is None:
            self._arm(rt, tape)
            if self.loop_plan is None:
                return False
        self._defer(rt, tape)
        return True

    def mark_executed(self) -> None:
        """Record that the tape last given to :meth:`fuse` was executed
        per-flush: its outputs are now live buffers and seed any future
        loop state."""
        if self._last_io is not None:
            self.exec_outs = self._last_io[1]

    # -- recurrence detection ------------------------------------------
    def _observe(self, rt, tape) -> bool:
        """Compare ``tape`` against the previous flush.  A recurrence needs
        equal structure AND the same carried-state mapping as every earlier
        pair in the streak (a changed mapping is a different loop).  Once
        the loop is armed a compiled :class:`cache.TapeMatcher` replaces
        the generic signature comparison: one early-exit field pass that
        also yields the tape io, so steady-state detection costs tens of
        microseconds.  On a break the queue drains BEFORE the tracker state
        moves on."""
        if self._matcher is not None:
            io = self._matcher.match(tape)
            if io is not None and self._mapping_holds(io):
                self.streak += 1
                self._last_tape, self._last_io = tape, io
                return True
        io = tape_io(tape)
        if self._last_tape is not None and tapes_structurally_equal(
                self._last_tape, tape):
            m = carried_state_mapping(self._last_io, io)
            if m is not None and (self.streak == 0 or m == self.mapping):
                self.mapping = m
                self.streak += 1
                self._last_tape, self._last_io = tape, io
                return True
        if self.streak > 0 or self.pending:
            self._event("break", reason="structure-change",
                        streak=self.streak)
        if self.pending:
            self.drain(rt)
        self.streak = 0
        self.mapping = None
        self.loop_plan = None
        self._n_rand = 0
        self._matcher = None
        self._salt_pos = ()
        self._last_tape, self._last_io = tape, io
        return False

    def _mapping_holds(self, io: Tuple) -> bool:
        """Fast equivalent of ``carried_state_mapping(last_io, io) ==
        self.mapping``: the mapping's positions are structural, so it holds
        iff each input uid matches its mapped source and every previous
        output is superseded."""
        ins, outs, dels = io
        l_ins, l_outs, _l_dels = self._last_io
        mp = self.mapping
        if mp is None or len(mp) != len(ins):
            return False
        for j, (kind, q) in enumerate(mp):
            if ins[j] != (l_outs[q] if kind == "carry" else l_ins[q]):
                return False
        if outs != l_outs:
            sup = set(outs)
            sup.update(dels)
            for u in l_outs:
                if u not in sup:
                    return False
        return True

    def _session_block_reason(self, rt) -> Optional[str]:
        """Per-flush session conditions — None when deferral is allowed,
        else a reason slug (recorded on break events).  A profiler needs
        per-block timings; a mesh routes through ``shard_map`` collectives
        (out of scope for the loop body, and a CUDA graph cannot capture a
        gloo collective); ``use_cache=False`` disables plan reuse
        entirely.  And the loop state must actually exist: the previous
        flush's outputs must be live buffers (or queued — then drain
        seeding happens against ``exec_outs`` which ARE buffers)."""
        ex = rt.executor
        if not rt.use_cache:
            return "cache-disabled"
        if ex.profiler is not None:
            return "profiler-active"
        if ex.mesh is not None:
            return "mesh-active"
        outs = self.exec_outs
        if outs is None:
            return "no-executed-state"
        bufs = rt.buffers
        for u in outs:
            if u not in bufs:
                return "state-not-resident"
        return None

    def _defer_block_reason(self, rt, tape) -> Optional[str]:
        """:meth:`_session_block_reason` plus the tape-side conditions:
        SYNC ops materialize state (the host observes it now), and the tape
        must do work and produce outputs."""
        reason = self._session_block_reason(rt)
        if reason is not None:
            return reason
        has_work = False
        for op in tape:
            if op.sync_bases:
                return "sync-op"
            if not op.is_system():
                has_work = True
        if not has_work:
            return "no-work"
        if not self._last_io[1]:
            return "no-outputs"
        return None

    # -- loop planning --------------------------------------------------
    def _arm(self, rt, tape) -> None:
        """Plan the steady-state loop body once per recurring structure.
        The regular plan is a guaranteed merge-cache hit by now (the
        structure executed ``threshold`` times); ``plan_loop`` re-lowers
        its blocks with launch overhead amortized over the unroll and
        caches the product beside the block plan."""
        sched = rt.scheduler.plan(
            tape, algorithm=rt.algorithm, cost_model=rt.cost_model,
            node_budget=rt.node_budget, use_cache=True,
            topology=rt.executor.topology_key(),
            lowering=rt.executor.lowering_policy(),
            partition_backend=rt.partition_backend,
            time_budget_s=rt.time_budget_s)
        if sched.key is None:
            return
        self.loop_plan = rt.scheduler.plan_loop(
            sched, key=sched.key, io=self._last_io, mapping=self.mapping,
            cost_model=rt.cost_model, lowering=rt.executor.lowering_policy(),
            unroll=self.unroll)
        salt_pos = []
        for p in self.loop_plan.plans:
            if not p.has_work:
                continue
            for i in p.op_indices:
                op = self.loop_plan.tape[i]
                if not op.is_system() and op.opcode == "random":
                    salt_pos.append(i)
        self._salt_pos = tuple(salt_pos)
        self._n_rand = len(salt_pos)
        # compile the steady-state matcher; its io must reproduce the
        # generic tape_io exactly or the fast path stays off
        m = TapeMatcher(tape, self._last_io)
        self._matcher = m if m.match(tape) == self._last_io else None
        self._event("arm", streak=self.streak, unroll=self.unroll,
                    n_state=len(self._last_io[1]),
                    fast_matcher=self._matcher is not None)

    # -- deferral & drain ----------------------------------------------
    def _defer(self, rt, tape) -> None:
        """Queue one iteration: its salt row (in block-dispatch order, the
        order the loop body consumes them) plus the io bookkeeping the
        drain needs (store deletes to honor, output uids for the final
        state).  Appends the flush's history entry."""
        sp = self._salt_pos
        row = tuple(tape[i].salt % _SALT_MOD for i in sp) if sp else ()
        ins, outs, dels = self._last_io
        if not self.pending:
            # a new deferred window opens: one async trace pair spans it
            # from the first queued iteration to its drain
            self._arm_seq += 1
            tr = trace.active()
            if tr is not None:
                tr.async_begin("loop.deferred", f"loop-{self._arm_seq}")
        self.pending.append((row, dels, outs))
        self._event("defer", pending=len(self.pending))
        rt.executor.metrics.gauge("loop.pending").set(len(self.pending))
        if outs != self._live_key:   # only the LAST queued state is live
            self.live = set(outs)
            self._live_key = outs
        rt.history.append({"n_ops": len(tape), "cached": True,
                           "loop_deferred": True,
                           "pending": len(self.pending)})
        if len(self.pending) >= self.unroll:
            self.drain(rt)

    def drain(self, rt) -> None:
        """Execute every queued iteration as ONE fused loop.

        Loop state is seeded from the last executed flush's output buffers
        (position ``q`` of the canonical output order = state slot ``q``,
        exactly how the carried mapping indexes them); invariants are the
        untouched store bases the mapping marked ``("inv", j)``.  After the
        loop the queue's pre-existing deletes are honored against the
        store and the final state lands under the LAST queued iteration's
        output uids — intermediate iterations never touch the store, which
        is precisely what the supersession rule licensed."""
        if not self.pending:
            return
        from .executor import stats_delta
        lp = self.loop_plan
        pending, self.pending = self.pending, []
        n = len(pending)
        self._event("drain", n_iterations=n)
        rt.executor.metrics.gauge("loop.pending").set(0)
        tr = trace.active()
        if tr is not None:
            tr.async_end("loop.deferred", f"loop-{self._arm_seq}",
                         {"n_iterations": n})
        ins_uids = self._last_io[0]
        inv_uids = [ins_uids[j] for j, s in enumerate(lp.input_sources)
                    if s[0] == "inv"]
        before = rt.executor.snapshot_stats()
        final = rt.executor.run_loop(lp, rt.buffers, self.exec_outs,
                                     inv_uids, [row for row, _, _ in pending],
                                     self.unroll)
        for _row, dels, _outs in pending:
            for u in dels:
                rt.buffers.pop(u, None)
        last_outs = pending[-1][2]
        for u, b in zip(last_outs, final):
            rt.buffers[u] = b
        self.exec_outs = last_outs
        self.live = set()            # the store is authoritative again
        self._live_key = None
        rt.history.append({"loop_drain": True, "n_iterations": n,
                           "cached": True,
                           "exec": stats_delta(before, rt.executor.stats)})
