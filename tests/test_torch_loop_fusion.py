"""Cross-flush loop fusion in the port (``repro_torch.core.loop``), held
against the reference's (``repro.core.loop``) on the CPU.

The reference's cases (``tests/test_loop_fusion.py``): recurrence
detection, hysteresis, unroll-forced drains, broken recurrences, mid-loop
materialize, ``use_cache=False``, the empty-flush drain, the in-place
stencil and the random-bearing loop on both backend stacks (bits only: no
timing), the state a SYNC snapshot shares, and the matcher cases.  Then
``xref``: ``IterativeProgram(seed)`` through the JAX package per-flush and
through the port loop-fused, bitwise; the cache helpers against the
reference's on the same tapes; the per-flush lowering decisions against
the first-claimant rule they had before pricing; the loop body's key table
and counter; and the executor's legacy ``run``.
"""

import numpy as np
import pytest
import torch

from repro.core import cache as ref_cache
from repro.core.lazy import fresh_runtime as ref_fresh_runtime
from repro.testing import tapegen as ref_tapegen

from repro_torch.core import lazy as bh
from repro_torch.core import prng
from repro_torch.core.backends import (LoweringBackend, get_backend,
                                       register_backend, select_lowering,
                                       unregister_backend)
from repro_torch.core.cache import (TapeMatcher, carried_state_mapping,
                                    tape_io, tapes_structurally_equal)
from repro_torch.core.cost import make_cost_model
from repro_torch.core.lazy import Runtime, fresh_runtime
from repro_torch.testing.programs import BENCHMARKS, quickstart
from repro_torch.testing.tapegen import IterativeProgram
from test_codegen import SCALED
from test_torch_planning import to_port

XREF_SEEDS = range(20)


def _step(x, c=1.01):
    y = x * c + 0.5
    x.delete()
    return y


def _run_chain(iters, c=1.01, **rt_kw):
    """The minimal recurring program: x <- x*c + 0.5 with a flush per
    step (fresh-chain carry: new base every step, old base deleted)."""
    with fresh_runtime(device="cpu", **rt_kw) as rt:
        x = bh.full(256, 1.0)
        bh.flush()
        for _ in range(iters):
            x = _step(x, c)
            bh.flush()
        out = x.numpy()
        hist = list(rt.history)
        x._alive = False
    return out, hist


def _deferred(hist):
    return [h for h in hist if h.get("loop_deferred")]


def _drains(hist):
    return [h for h in hist if h.get("loop_drain")]


def test_loop_fusion_is_the_default():
    rt = Runtime(device="cpu")
    assert rt._loop is not None
    assert (rt._loop.threshold, rt._loop.unroll) == (3, 32)
    assert Runtime(device="cpu", loop_fusion=False)._loop is None


# ---------------------------------------------------------------------------
# Steady-state detection and history bookkeeping
# ---------------------------------------------------------------------------

def test_steady_state_defers_and_drains():
    out, hist = _run_chain(10, loop_fusion=True, loop_threshold=3,
                           loop_unroll=32)
    ref, _ = _run_chain(10, loop_fusion=False)
    assert out.tobytes() == ref.tobytes()
    # threshold=3: iterations 1-3 execute per-flush, 4-10 defer
    assert len(_deferred(hist)) == 7
    drains = _drains(hist)
    assert len(drains) == 1                      # tail drain at materialize
    assert drains[0]["n_iterations"] == 7
    assert drains[0]["cached"] is True
    ex = drains[0]["exec"]
    assert (ex["loop_flushes"], ex["loop_iterations"]) == (1, 7)
    # fresh-chain carry: seeded once, then each iteration's new base is
    # copied back into the state buffer; no graph on the CPU
    assert ex["loop_state_copies"] == 1 + 7
    assert (ex["loop_captures"], ex["loop_replays"]) == (0, 0)


def test_deferred_entries_carry_pending_depth():
    _, hist = _run_chain(6, loop_fusion=True, loop_threshold=2,
                         loop_unroll=32)
    pend = [h["pending"] for h in _deferred(hist)]
    assert pend == [1, 2, 3, 4]                  # queue depth grows by one


def test_normal_entries_carry_merge_counters():
    _, hist = _run_chain(4, loop_fusion=False)
    work = [h for h in hist if "merge_hits" in h]
    assert work, "executed flushes must record merge-cache deltas"
    assert all("merge_misses" in h for h in work)
    assert sum(h["merge_hits"] for h in work) > 0


# ---------------------------------------------------------------------------
# Hysteresis boundaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threshold", [1, 2, 4])
def test_hysteresis_boundary(threshold):
    """Deferral starts exactly at occurrence ``threshold + 1``."""
    iters = threshold + 3
    _, hist = _run_chain(iters, loop_fusion=True, loop_threshold=threshold,
                         loop_unroll=64)
    assert len(_deferred(hist)) == iters - threshold


def test_below_threshold_never_defers():
    _, hist = _run_chain(3, loop_fusion=True, loop_threshold=3,
                         loop_unroll=64)
    assert _deferred(hist) == []
    assert _drains(hist) == []


def test_unroll_capacity_forces_mid_run_drains():
    _, hist = _run_chain(12, loop_fusion=True, loop_threshold=2,
                         loop_unroll=4)
    # 10 deferred iterations -> capacity drains of 4, 4, tail drain of 2
    assert [d["n_iterations"] for d in _drains(hist)] == [4, 4, 2]
    # one loop body serves every drain size
    assert [d["exec"]["exec_cache_misses"] for d in _drains(hist)] == \
        [1, 0, 0]


# ---------------------------------------------------------------------------
# Recurrence edges: what must (and must not) break the streak
# ---------------------------------------------------------------------------

def _run_two_phase(cs, **rt_kw):
    with fresh_runtime(device="cpu", **rt_kw) as rt:
        x = bh.full(256, 1.0)
        bh.flush()
        for c in cs:
            x = _step(x, c)
            bh.flush()
        out = x.numpy()
        hist = list(rt.history)
        x._alive = False
    return out, hist


def test_changed_constant_breaks_recurrence():
    """A different literal is a different program: the streak resets and
    nothing fuses a stale constant into the loop body."""
    cs = [1.01, 1.01, 1.01, 1.01, 2.5, 2.5]
    ref, _ = _run_two_phase(cs, loop_fusion=False)
    out, hist = _run_two_phase(cs, loop_fusion=True, loop_threshold=2,
                               loop_unroll=32)
    assert out.tobytes() == ref.tobytes()
    assert any(d["n_iterations"] for d in _drains(hist))


def test_changed_structure_breaks_recurrence():
    def run(**rt_kw):
        with fresh_runtime(device="cpu", **rt_kw) as rt:
            x = bh.full(256, 1.0)
            bh.flush()
            for i in range(8):
                if i == 5:
                    y = x * 1.01 + bh.sin(x)    # different shape of step
                else:
                    y = x * 1.01 + 0.5
                x.delete()
                x = y
                bh.flush()
            out = x.numpy()
            hist = list(rt.history)
            x._alive = False
        return out, hist

    ref, _ = run(loop_fusion=False)
    out, hist = run(loop_fusion=True, loop_threshold=2, loop_unroll=32)
    assert out.tobytes() == ref.tobytes()
    assert sum(d["n_iterations"] for d in _drains(hist)) == len(
        _deferred(hist))


def test_interleaved_tapes_never_defer():
    """A/B/A/B alternation: consecutive flushes never repeat, so the
    streak never forms and everything executes per-flush."""
    def run(**rt_kw):
        with fresh_runtime(device="cpu", **rt_kw) as rt:
            x = bh.full(256, 1.0)
            y = bh.full(128, 2.0)
            bh.flush()
            for _ in range(6):
                x = _step(x)
                bh.flush()
                y = _step(y, 1.5)
                bh.flush()
            ox, oy = x.numpy(), y.numpy()
            hist = list(rt.history)
            x._alive = y._alive = False
        return ox, oy, hist

    rx, ry, _ = run(loop_fusion=False)
    ox, oy, hist = run(loop_fusion=True, loop_threshold=2, loop_unroll=32)
    assert _deferred(hist) == []
    assert ox.tobytes() == rx.tobytes()
    assert oy.tobytes() == ry.tobytes()


def test_mid_loop_materialize_drains():
    """A .numpy() mid-loop is a SYNC: the queue drains so the host sees
    the true current state, then the loop re-arms."""
    def run(**rt_kw):
        with fresh_runtime(device="cpu", **rt_kw):
            x = bh.full(256, 1.0)
            bh.flush()
            mid = None
            for i in range(10):
                x = _step(x)
                bh.flush()
                if i == 6:
                    mid = x.numpy().copy()
            out = x.numpy()
            x._alive = False
        return mid, out

    rmid, rout = run(loop_fusion=False)
    mid, out = run(loop_fusion=True, loop_threshold=2, loop_unroll=64)
    assert mid.tobytes() == rmid.tobytes()
    assert out.tobytes() == rout.tobytes()


def test_use_cache_off_disables_deferral():
    _, hist = _run_chain(8, loop_fusion=True, loop_threshold=2,
                         loop_unroll=32, use_cache=False)
    assert _deferred(hist) == []


def test_empty_flush_drains_pending():
    with fresh_runtime(device="cpu", loop_fusion=True, loop_threshold=2,
                       loop_unroll=64) as rt:
        x = bh.full(256, 1.0)
        bh.flush()
        for _ in range(6):
            x = _step(x)
            bh.flush()
        assert rt._loop.pending
        bh.flush()                               # empty tape -> drain
        assert not rt._loop.pending
        assert _drains(rt.history)
        out = x.numpy()
        x._alive = False
    ref, _ = _run_chain(6, loop_fusion=False)
    assert out.tobytes() == ref.tobytes()


def test_state_machine_events_are_traced():
    """arm, defer, drain and break reach the tracer as ``loop.*`` instants
    and the fuser's event log, with the deferred window as an async
    pair."""
    from repro_torch.core.obs import trace
    tr = trace.enable()
    try:
        _run_chain(6, loop_threshold=2, loop_unroll=32)
    finally:
        trace.disable()
    names = [ev["name"] for ev in tr.events]
    for event in ("loop.arm", "loop.defer", "loop.drain", "loop.break"):
        assert event in names, event
    assert names.count("loop.defer") == 4
    assert "loop.deferred" in names


# ---------------------------------------------------------------------------
# Bitwise fidelity of the loop-fused path
# ---------------------------------------------------------------------------

def _heat(iters, **rt_kw):
    with fresh_runtime(device="cpu", **rt_kw) as rt:
        g = bh.zeros((32, 32))
        g[0, :] = 100.0
        bh.flush()
        for _ in range(iters):
            inner = (g[1:-1, :-2] + g[1:-1, 2:] + g[:-2, 1:-1]
                     + g[2:, 1:-1]) * 0.25
            g[1:-1, 1:-1] = inner
            inner.delete()
            bh.flush()
        out = g.numpy()
        st = rt.executor.stats.snapshot()
        g._alive = False
    return out, st


@pytest.mark.parametrize("backend", ["torch", "triton"])
def test_inplace_stencil_bitwise(backend):
    """RMW partial-write carry (same base every step) on both backend
    stacks — the loop body composes whatever the lower stage picked."""
    ref, _ = _heat(9, loop_fusion=False, backend=backend)
    got, st = _heat(9, loop_fusion=True, loop_threshold=2, loop_unroll=4,
                    backend=backend)
    assert ref.tobytes() == got.tobytes()
    assert (st["loop_flushes"], st["loop_iterations"]) == (2, 7)
    if backend == "triton":
        # B1 writes the stencil's write-back into the state buffer itself:
        # the state is copied in once, then never again
        assert st["loop_state_copies"] == 1


@pytest.mark.parametrize("backend", ["torch", "triton"])
def test_random_bearing_loop_bitwise(backend):
    """Each deferred iteration's draws read the key words of their own
    trace-time salts from the key table: bitwise the per-flush draws."""
    def run(**rt_kw):
        with fresh_runtime(device="cpu", backend=backend, **rt_kw):
            x = bh.full(512, 0.0)
            bh.flush()
            for _ in range(9):
                r = bh.floor(bh.random((512,)) * 8.0)
                y = x + r
                r.delete()
                x.delete()
                x = y
                bh.flush()
            out = x.numpy()
            x._alive = False
        return out
    ref = run(loop_fusion=False)
    got = run(loop_fusion=True, loop_threshold=2, loop_unroll=4)
    assert ref.tobytes() == got.tobytes()


@pytest.mark.parametrize("backend", ["torch", "triton"])
def test_sync_snapshot_of_the_state_is_copied_not_overwritten(backend):
    """A drain runs in the loop's state buffers; a SYNC snapshot that holds
    one of them (the mid-loop ``.numpy()`` right after a drain) is copied
    off before the next drain overwrites that buffer, and the results stay
    bitwise."""
    def run(**rt_kw):
        with fresh_runtime(device="cpu", backend=backend, **rt_kw) as rt:
            x = bh.full(256, 1.0)
            bh.flush()
            for i in range(12):
                x = _step(x)
                bh.flush()
                if i == 6:
                    x.numpy()
                    uid = x.view.base.uid
                    kept = rt.executor.sync_store[uid].clone()
            out = x.numpy()
            snap = rt.executor.sync_store[uid]
            st = rt.executor.stats.snapshot()
            x._alive = False
        return out, snap, kept, st
    ref, *_ = run(loop_fusion=False)
    got, snap, kept, st = run(loop_fusion=True, loop_threshold=2,
                              loop_unroll=64)
    assert got.tobytes() == ref.tobytes()
    assert torch.equal(snap, kept)
    # steps 2-6 and 9-11 deferred: seeded twice, a copy back per
    # iteration and the snapshot
    assert (st["loop_flushes"], st["loop_iterations"]) == (2, 8)
    assert st["loop_state_copies"] == 2 + 8 + 1


# ---------------------------------------------------------------------------
# TapeMatcher: the steady-state fast path is exactly the generic check
# ---------------------------------------------------------------------------

def _record(build):
    with fresh_runtime(device="cpu") as rt:
        keep = build()
        tape = list(rt.tape)
        rt.tape.clear()
        for a in keep:
            a._alive = False
    return tape


def test_matcher_agrees_with_generic_path():
    def build(c=0.5):
        x = bh.full(64, 1.0)
        y = x * 2.0 + c
        z = y.sum()
        y.delete()
        return [x, z]

    t1, t2 = _record(build), _record(build)
    m = TapeMatcher(t1, tape_io(t1))
    assert m.match(t1) == tape_io(t1)            # template self-match
    assert tapes_structurally_equal(t1, t2)
    assert m.match(t2) == tape_io(t2)            # fresh bases, same shape

    t3 = _record(lambda: build(0.75))            # literal changed
    assert not tapes_structurally_equal(t1, t3)
    assert m.match(t3) is None

    def build_other():
        x = bh.full(64, 1.0)
        y = x + x
        z = y.sum()
        y.delete()
        return [x, z]

    t4 = _record(build_other)                    # structure changed
    assert m.match(t4) is None
    assert m.match(t1[:-1]) is None              # length changed


def test_matcher_rejects_aliasing_pattern_change():
    """Same base read twice vs two distinct bases: the renumbering is part
    of the structure."""
    def aliased():
        x = bh.full(64, 1.0)
        y = x * x
        return [x, y]

    def split():
        x = bh.full(64, 1.0)
        w = bh.full(64, 1.0)
        y = x * w
        return [x, w, y]

    ta, ts = _record(aliased), _record(split)
    mul_a = [op for op in ta if op.opcode not in ("full",)]
    mul_s = [op for op in ts if op.opcode not in ("full",)]
    ma = TapeMatcher(mul_a, tape_io(mul_a))
    assert ma.match(mul_a) == tape_io(mul_a)
    assert ma.match(mul_s) is None


def _ref_steps(n_steps):
    """``n_steps`` consecutive step tapes of a reference program that
    mixes an in-place carry, a fresh-chain carry and an invariant."""
    from repro.core import lazy as rbh
    tapes = []
    with ref_fresh_runtime(loop_fusion=False) as rt:
        g = rbh.zeros((8, 8))
        a = rbh.full(16, 1.0)
        k = rbh.full(16, 2.0)
        rbh.flush()
        for _ in range(n_steps):
            g[1:-1, :] = g[1:-1, :] * 0.5 + 1.0
            b = a * 0.5 + k
            a.delete()
            a = b
            tapes.append(list(rt.tape))
            rbh.flush()
        for x in (g, a, k):
            x._alive = False
    return tapes


def test_cache_helpers_match_reference():
    """On the same step tapes (the reference's, translated op for op as one
    program, so a base keeps one port base across steps), the port's
    structure test, tape io (by position) and carried-state mapping are
    the reference's."""
    ref_tapes = _ref_steps(3)
    whole = to_port([op for t in ref_tapes for op in t])
    tapes, at = [], 0
    for t in ref_tapes:
        tapes.append(whole[at:at + len(t)])
        at += len(t)

    def positions(io, tape):
        order = {}
        for op in tape:
            for v in (*op.in_views(), *op.out_views()):
                order.setdefault(v.base.uid, len(order))
        return tuple(tuple(order.get(u) for u in part) for part in io)

    for rt_, t in zip(ref_tapes, tapes):
        assert positions(ref_cache.tape_io(rt_), rt_) == \
            positions(tape_io(t), t)
    for (r0, r1), (p0, p1) in zip(zip(ref_tapes, ref_tapes[1:]),
                                  zip(tapes, tapes[1:])):
        assert ref_cache.tapes_structurally_equal(r0, r1)
        assert tapes_structurally_equal(p0, p1)
        want = ref_cache.carried_state_mapping(ref_cache.tape_io(r0),
                                               ref_cache.tape_io(r1))
        assert want is not None
        assert carried_state_mapping(tape_io(p0), tape_io(p1)) == want
        m = TapeMatcher(p0, tape_io(p0))
        assert m.match(p1) == tape_io(p1)


# ---------------------------------------------------------------------------
# xref: IterativeProgram, reference per-flush vs port loop-fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", XREF_SEEDS)
def test_xref_iterative_program_bitwise(seed):
    """The JAX package's per-flush run and the port's loop-fused run (the
    floor on even seeds, B1's plain version on odd ones) give the same
    bits: in-place and fresh-chain carries, invariants, reductions fed
    back, and per-step draws from the key table."""
    backend = ("torch", "triton")[seed % 2]
    ref = ref_tapegen.IterativeProgram(seed).run(loop_fusion=False)
    with fresh_runtime(device="cpu", backend=backend, loop_threshold=2,
                       loop_unroll=4) as rt:
        got = IterativeProgram(seed).run_current()
        st = rt.executor.stats.snapshot()
        deferred = len(_deferred(rt.history))
    ref_tapegen._assert_bitwise(ref, got, f"seed {seed} [port loop-fused]")
    assert st["loop_iterations"] == deferred


@pytest.mark.parametrize("seed", [0, 1, 16])
def test_xref_deferrals_match_reference(seed, monkeypatch):
    """The port's fuser defers and drains the same steps as the
    reference's on the same program (seed 16's recipe never recurs with a
    loop-safe mapping: neither fuser defers it)."""
    import repro.core.lazy as ref_lazy
    kw = dict(loop_threshold=2, loop_unroll=4)
    with ref_fresh_runtime(**kw) as rrt:
        monkeypatch.setattr(ref_lazy, "fresh_runtime", _reuse(rrt))
        ref_tapegen.IterativeProgram(seed).run(**kw)
        monkeypatch.undo()
        want = _pattern(rrt.history)
    with fresh_runtime(device="cpu", **kw) as rt:
        IterativeProgram(seed).run_current()
        assert _pattern(rt.history) == want


def _reuse(rt):
    """A ``fresh_runtime`` stand-in that hands out ``rt`` (already
    active), so a program's own ``run`` records into a runtime the test
    can read."""
    import contextlib

    @contextlib.contextmanager
    def cm(**_kw):
        yield rt
    return cm


def _pattern(hist):
    return [("defer" if h.get("loop_deferred") else
             f"drain{h['n_iterations']}" if h.get("loop_drain") else "run")
            for h in hist]


# ---------------------------------------------------------------------------
# Lowering: priced selection keeps the per-flush decisions
# ---------------------------------------------------------------------------

def _first_claimant(ops, plan, backends, ctx):
    """The rule the port's lower stage had before pricing: the first
    claimant in preference order."""
    declined = []
    for name in backends:
        reason = get_backend(name).claims(ops, plan, ctx)
        if reason is None:
            return name, tuple(declined)
        declined.append((name, reason))
    raise AssertionError("no claimant")


CASES = list(SCALED) + [("quickstart", (1, 5000))]
PROGRAMS = dict(BENCHMARKS, quickstart=quickstart)


@pytest.mark.parametrize("name,args", CASES, ids=[c[0] for c in CASES])
def test_per_flush_lowering_decisions_unchanged(name, args):
    """Every block of every program: the decision the lower stage made
    (priced, under the runtime's bohrium model) and the ones the gpu model
    gives per flush and amortized over a 32-iteration loop are all the
    first claimant's."""
    seen = []
    with fresh_runtime(backend="triton", device="cpu",
                       loop_fusion=False) as rt:
        run = rt.executor.run_schedule

        def spy(schedule, buffers):
            for plan in schedule.blocks:
                if plan.has_work:
                    seen.append(([schedule.tape[i] for i in plan.op_indices],
                                 plan))
            return run(schedule, buffers)

        rt.executor.run_schedule = spy
        np.asarray(PROGRAMS[name](*args))
        policy = rt.executor.lowering_policy()
    gpu = make_cost_model("gpu")
    for ops, plan in seen:
        want = _first_claimant(ops, plan, policy.backends, policy.ctx)
        assert (plan.lowering.backend, plan.lowering.declined) == want
        for amortize in (1, 32):
            d = select_lowering(ops, plan, policy.backends, policy.ctx, gpu,
                                amortize=amortize)
            assert (d.backend, d.declined) == want


def test_floor_prices_an_inexpressible_block_at_two_dispatches():
    from types import SimpleNamespace

    from repro_torch.core.backends import LoweringContext
    from repro_torch.core.ir import BaseArray, Op, View
    n = 16
    a, b = BaseArray(n, np.dtype(np.float64)), BaseArray(n, np.dtype(np.float64))
    plan = SimpleNamespace(signature=None, op_indices=(0,))
    ctx = LoweringContext(device="cpu")
    fused = [Op("mul", View.contiguous(b, (n,)),
                (View.contiguous(a, (n,)), 2.0), new_bases=frozenset({b}))]
    reversed_read = [Op("copy", View.contiguous(b, (n,)),
                        (View(a, n - 1, (n,), (-1,)),),
                        new_bases=frozenset({b}))]
    floor = get_backend("torch")
    assert floor.dispatches(fused, plan, ctx) == 1
    assert floor.dispatches(reversed_read, plan, ctx) == 2
    gpu = make_cost_model("gpu")
    assert gpu.dispatch_price(2, amortize=32) == pytest.approx(
        gpu.launch_s * 2 / 32)


# ---------------------------------------------------------------------------
# The loop body: key table, counter, builds
# ---------------------------------------------------------------------------

def test_key_table_words_are_the_salts_key_words():
    """``KeyTable.words`` at the counter's row gives ``prng.key_words`` of
    that iteration's salt, and a draw through them is ``uniform_at``'s."""
    salts = [[5, 9], [11, 13], [2 ** 31 - 2, 0]]
    table = torch.tensor([[prng.key_words(7, s) for s in row]
                          for row in salts], dtype=torch.uint32)
    kt = prng.KeyTable(table, torch.zeros(1, dtype=torch.int32))
    idx = torch.arange(33)
    for i, row in enumerate(salts):
        kt.ctr.fill_(i)
        for j, salt in enumerate(row):
            k1, k2 = kt.at(j).words(0)
            assert (int(k1), int(k2)) == prng.key_words(7, salt)
            assert torch.equal(prng.uniform_bits(k1, k2, idx, np.float64),
                               prng.uniform_at(7, salt, idx, np.float64))


class _Broken(LoweringBackend):
    name = "broken"

    def claims(self, ops, plan, ctx):
        return None

    def build(self, ops, plan, ctx):
        raise RuntimeError("builder failed")


def test_loop_body_build_failure_raises():
    """A loop body whose block's builder fails raises: no quiet degrade to
    the floor (the per-flush path builds the same block the same way)."""
    register_backend(_Broken())
    try:
        with pytest.raises(RuntimeError, match="builder failed"):
            _run_chain(6, backend=("broken", "torch"), loop_threshold=2)
    finally:
        unregister_backend("broken")


def test_legacy_executor_run_still_works():
    from repro_torch.core import partition
    from repro_torch.core.executor import BlockExecutor
    from repro_torch.core.ir import Op
    with fresh_runtime(device="cpu") as rt:
        x = bh.full(8, 2.0)
        y = x * 4.0
        rt.record(Op("sync", None, sync_bases=frozenset({y.view.base})))
        tape = list(rt.tape)
        rt.tape.clear()
        x._alive = y._alive = False
        y_uid = y.view.base.uid
    res = partition(tape, algorithm="greedy", cost_model="bohrium")
    for backend in ("torch", "triton"):
        ex = BlockExecutor(backend=backend, device="cpu")
        ex.run(tape, res.op_blocks(), {})
        np.testing.assert_array_equal(ex.sync_store[y_uid].numpy(),
                                      np.full(8, 8.0))
        assert ex.stats["blocks_run"] >= 1
        assert len(ex._decisions) >= 1           # decided once, cached
