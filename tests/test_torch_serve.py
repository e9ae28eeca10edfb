"""The port's serving layer (``repro_torch.core.serve``) against the JAX
package's (``repro.core.serve``), on the CPU.

* Cross-package, bitwise: the serving load's shared and tenant requests
  and ``tests/test_serve.py``'s ``_make_request`` (with and without
  ``random``) give the same bits through ``repro.core.serve.Server`` and the
  port's ``Server(device="cpu")``, on the same numpy data.
* A counterpart of every test of ``tests/test_serve.py``: concurrent
  sessions, the stats snapshot under concurrent flushes, the plan store's
  warm start (in this process and in a fresh one) and fault matrix,
  admission control and micro-batching.  The torn-snapshot test holds the
  invariant ``hits + misses == blocks_run`` inside every snapshot: the port
  moves the three counters together under the registry lock.
* ``check_serve`` on seeds 0-9, and the same seed through the reference's
  recipe and the port's, bitwise.
* Store envelopes cross-read cleanly as stale misses in both directions.

Every thread a test starts is joined with a timeout, and a join that times
out fails the test.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro.core import lazy as jbh
from repro.core.serve import PlanStore as RefPlanStore
from repro.core.serve import Server as RefServer
from repro.testing.tapegen import TapeProgram as RefTapeProgram

from repro_torch.core import lazy as bh
from repro_torch.core.lazy import Runtime, fresh_runtime
from repro_torch.core.obs import trace
from repro_torch.core.serve import (AdmissionController, PlanStore,
                                    SERVE_STORE_VERSION, Server,
                                    ServeRejected)
from repro_torch.testing import tapegen
from repro_torch.testing.tapegen import TapeProgram, _assert_bitwise

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "src")
CPU = "cpu"
JOIN_S = 60.0


def _run_threads(n, target):
    errors = []

    def wrap(i):
        try:
            target(i)
        except BaseException as e:      # noqa: BLE001 — surfaced below
            errors.append((i, e))

    threads = [threading.Thread(target=wrap, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a worker hung"
    assert not errors, f"worker failures: {errors}"


def _store_file(root):
    files = [os.path.join(root, n) for n in os.listdir(root)
             if n.endswith(".json")]
    assert files, f"no store entries in {root}"
    return files[0]


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _counter(rt, name):
    return rt.executor.metrics.counter(name).get()


def _warm_program():
    a = bh.arange(256)
    b = a * 2.0 + 1.0
    c = bh.sqrt(b) + a * 0.5
    return c.numpy()


# ---------------------------------------------------------------------------
# the requests, for either package's lazy module
# ---------------------------------------------------------------------------

def _make_request(data, with_random=False, m=bh):
    def fn():
        a = m.asarray(data)
        b = m.floor((a * 2.0 + 3.0) % 1021.0)
        c = m.maximum(b, a) + b.sum().broadcast_to(a.shape)
        if with_random:
            c = c + m.floor(m.random(a.shape) * 8.0)
        return c
    return fn


def _shared_request(data, m=bh):
    """The serving load's coalescable structure (``benchmarks/serving.py``)."""
    def fn():
        a = m.asarray(data)
        b = m.floor((a * 2.0 + 3.0) % 1021.0)
        return m.maximum(b, a) + b.sum().broadcast_to(a.shape)
    return fn


def _tenant_request(data, tenant, m=bh):
    """The serving load's per-tenant structure (a literal in the tape)."""
    scale = float(tenant + 2)

    def fn():
        a = m.asarray(data)
        return m.floor((a * scale) % 1021.0) + a
    return fn


REQUESTS = {
    "shared": lambda d, t, m: _shared_request(d, m),
    "tenant": lambda d, t, m: _tenant_request(d, t, m),
    "make_request": lambda d, t, m: _make_request(d, False, m),
    "make_request_random": lambda d, t, m: _make_request(d, True, m),
}


@pytest.mark.parametrize("kind", sorted(REQUESTS))
def test_requests_match_the_jax_package_bitwise(kind):
    """Serial batching-off servers of both packages, two rounds of four
    tenants (so the RNG salts advance per session), bitwise."""
    rng = np.random.default_rng(8)
    datas = [np.floor(rng.random(256) * 16.0) for _ in range(4)]
    ref, port = RefServer(batching=False), Server(batching=False, device=CPU)
    for r in range(2):
        for t in range(4):
            want = ref.submit(t, REQUESTS[kind](datas[t], t, jbh))
            got = port.submit(t, REQUESTS[kind](datas[t], t, bh))
            assert want.dtype == got.dtype and want.shape == got.shape
            assert want.tobytes() == got.tobytes(), (kind, r, t)


# ---------------------------------------------------------------------------
# concurrent sessions
# ---------------------------------------------------------------------------

class TestConcurrentSessions:
    N = 6

    def test_concurrent_flushes_bitwise_vs_serial(self):
        progs = [TapeProgram(900 + i, n_actions=10) for i in range(self.N)]
        refs = [p.run(device=CPU) for p in progs]
        rt = Runtime(loop_fusion=False, device=CPU)
        sessions = [rt.session() for _ in range(self.N)]
        results = [None] * self.N
        barrier = threading.Barrier(self.N)

        def worker(i):
            barrier.wait(JOIN_S)
            with sessions[i].activate():
                results[i] = progs[i].run_current()

        _run_threads(self.N, worker)
        for i in range(self.N):
            _assert_bitwise(refs[i], results[i], f"tenant {i}")

    def test_no_lost_stats_increments(self):
        """N sessions x M flushes of one structure: exact dispatch totals.
        A read-modify-write race on a counter would lose counts here."""
        prog = TapeProgram(41, n_actions=8)
        with fresh_runtime(loop_fusion=False, device=CPU) as solo:
            prog.run_current()
            expected = solo.executor.stats.snapshot()["blocks_run"]
        rounds = 3
        rt = Runtime(loop_fusion=False, device=CPU)
        sessions = [rt.session() for _ in range(self.N)]
        barrier = threading.Barrier(self.N)

        def worker(i):
            barrier.wait(JOIN_S)
            with sessions[i].activate():
                for _ in range(rounds):
                    prog.run_current()

        _run_threads(self.N, worker)
        st = rt.executor.stats.snapshot()
        assert st["blocks_run"] == expected * self.N * rounds
        # every work-block dispatch probed the executable cache exactly once
        assert (st["exec_cache_hits"] + st["exec_cache_misses"]
                == st["blocks_run"])

    def test_concurrent_merge_hits_match_warm_serial_rate(self):
        """Against a pre-warmed merge cache, EVERY concurrent flush must
        hit — the shared cache's hit rate is no worse than a serial warm
        replay's."""
        prog = TapeProgram(77, n_actions=8)
        rt = Runtime(loop_fusion=False, device=CPU)
        with rt.activate():
            prog.run_current()          # cold: populates the merge cache
        h0, m0 = rt.cache.hits, rt.cache.misses
        with rt.activate():
            prog.run_current()          # serial warm replay
        warm_hits = rt.cache.hits - h0
        assert warm_hits > 0 and rt.cache.misses == m0
        sessions = [rt.session() for _ in range(self.N)]
        barrier = threading.Barrier(self.N)

        def worker(i):
            barrier.wait(JOIN_S)
            with sessions[i].activate():
                prog.run_current()

        h1, m1 = rt.cache.hits, rt.cache.misses
        _run_threads(self.N, worker)
        assert rt.cache.hits - h1 >= warm_hits * self.N
        assert rt.cache.misses == m1

    def test_fresh_runtime_is_thread_local(self):
        """Two threads' fresh runtimes must not observe each other."""
        seen = {}
        barrier = threading.Barrier(2)

        def worker(i):
            with fresh_runtime(device=CPU) as rt:
                barrier.wait(JOIN_S)
                x = bh.full((8,), float(i))
                seen[i] = (rt, x.rt, float(x.numpy()[0]))

        _run_threads(2, worker)
        assert seen[0][0] is seen[0][1] and seen[1][0] is seen[1][1]
        assert seen[0][0] is not seen[1][0]
        assert seen[0][2] == 0.0 and seen[1][2] == 1.0

    def test_session_shares_caches_not_tape(self):
        rt = Runtime(loop_fusion=False, device=CPU)
        s1, s2 = rt.session(), rt.session()
        assert s1.scheduler is rt.scheduler
        assert s1.executor is rt.executor
        assert s1.cache is s2.cache
        assert s1.tape is not s2.tape and s1.buffers is not s2.buffers


def test_session_inherits_policy_device_and_backend():
    rt = Runtime(algorithm="linear", cost_model="max_contract",
                 node_budget=77, partition_backend="ilp", time_budget_s=0.5,
                 backend="triton", device=CPU)
    s = rt.session()
    assert (s.algorithm, s.cost_model, s.node_budget, s.partition_backend,
            s.time_budget_s) == ("linear", "max_contract", 77, "ilp", 0.5)
    assert s.device == rt.device and s.executor.backend == "triton"
    assert s._loop is None and rt.session(loop_fusion=True)._loop is not None
    with pytest.raises(ValueError, match="executor on cpu"):
        rt.session(device="meta")


def test_stress_many_sessions_short_switch_interval():
    """More threads than cores flushing one structure with a tiny switch
    interval: the shared counters and caches lose nothing."""
    prog = TapeProgram(5, n_actions=6)
    with fresh_runtime(loop_fusion=False, device=CPU) as solo:
        want = prog.run_current()
        per_run = solo.executor.stats.snapshot()["blocks_run"]
    n = 2 * (os.cpu_count() or 4) + 2
    rt = Runtime(loop_fusion=False, device=CPU)
    sessions = [rt.session() for _ in range(n)]
    got = [None] * n
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            with sessions[i].activate():
                got[i] = prog.run_current()
        _run_threads(n, worker)
    finally:
        sys.setswitchinterval(old)
    for g in got:
        _assert_bitwise(want, g, "stress")
    st = rt.executor.stats.snapshot()
    assert st["blocks_run"] == per_run * n
    assert st["exec_cache_hits"] + st["exec_cache_misses"] == per_run * n


# ---------------------------------------------------------------------------
# stats snapshot / reset thread visibility
# ---------------------------------------------------------------------------

class TestStatsThreadVisibility:
    def test_snapshot_is_consistent_under_concurrent_flushes(self):
        """A snapshot racing live flushes never tears: the port counts a
        dispatch's cache hit or miss and its ``blocks_run`` as one update
        under the registry lock, so hits + misses == blocks_run holds
        inside every snapshot, and the final totals are exact."""
        prog = TapeProgram(13, n_actions=6)
        rt = Runtime(loop_fusion=False, device=CPU)
        with rt.activate():
            prog.run_current()
        per_run = rt.executor.stats.snapshot()["blocks_run"]
        rt.executor.reset_stats()
        stop = threading.Event()
        torn = []
        snaps = [0]

        def snapshotter():
            while not stop.is_set():
                time.sleep(0)            # let the flushing threads run
                st = rt.executor.snapshot_stats()
                snaps[0] += 1
                if (st["exec_cache_hits"] + st["exec_cache_misses"]
                        != st["blocks_run"]):
                    torn.append(dict(st))

        snap_t = threading.Thread(target=snapshotter, daemon=True)
        snap_t.start()
        try:
            sessions = [rt.session() for _ in range(4)]

            def worker(i):
                with sessions[i].activate():
                    for _ in range(3):
                        prog.run_current()

            _run_threads(4, worker)
        finally:
            stop.set()
            snap_t.join(JOIN_S)
        assert not snap_t.is_alive()
        assert snaps[0] > 0
        assert not torn, f"torn snapshots: {torn[:3]}"
        assert rt.executor.stats.snapshot()["blocks_run"] == per_run * 12

    def test_snapshot_blocks_while_reset_holds_the_lock(self):
        rt = Runtime(loop_fusion=False, device=CPU)
        order = []
        entered = threading.Event()

        def snap():
            entered.set()
            rt.executor.snapshot_stats()
            order.append("snapshot")

        with rt.executor.metrics.lock:
            t = threading.Thread(target=snap, daemon=True)
            t.start()
            entered.wait(2.0)
            time.sleep(0.05)
            order.append("holder")
        t.join(JOIN_S)
        assert not t.is_alive()
        assert order == ["holder", "snapshot"]

    def test_reset_mid_run_never_yields_negative_history_deltas(self):
        prog = TapeProgram(29, n_actions=6)
        rt = Runtime(loop_fusion=False, device=CPU)
        sess = rt.session()
        stop = threading.Event()

        def resetter():
            while not stop.is_set():
                time.sleep(0)            # let the flushing thread run
                rt.executor.reset_stats()

        t = threading.Thread(target=resetter, daemon=True)
        t.start()
        try:
            with sess.activate():
                for _ in range(3):
                    prog.run_current()
        finally:
            stop.set()
            t.join(JOIN_S)
        assert not t.is_alive()

        def no_negatives(d):
            for v in d.values():
                if isinstance(v, dict):
                    no_negatives(v)
                else:
                    assert v >= 0, d

        for entry in sess.history:
            no_negatives(entry["exec"])


# ---------------------------------------------------------------------------
# plan store: warm start + fault injection
# ---------------------------------------------------------------------------

class TestPlanStore:
    def test_cold_run_writes_warm_runtime_hits(self, tmp_path):
        store_dir = str(tmp_path)
        rt1 = Runtime(plan_store=store_dir, loop_fusion=False, device=CPU)
        with rt1.activate():
            ref = _warm_program()
        assert _counter(rt1, "cache.plan_store.write") >= 1
        assert len(os.listdir(store_dir)) >= 1

        tr = trace.enable()
        try:
            rt2 = Runtime(plan_store=store_dir, loop_fusion=False,
                          device=CPU)
            with rt2.activate():
                got = _warm_program()
        finally:
            trace.disable()
        assert np.array_equal(ref, got)
        assert _counter(rt2, "cache.plan_store.hit") >= 1
        names = {e["name"] for e in tr.events}
        assert "stage.partition" not in names   # graph/partition skipped
        assert "cache.plan_store" in names

    def test_warm_start_in_fresh_process(self, tmp_path):
        """A store populated by one process is hit by a genuinely new one:
        ``cache.plan_store.hit`` >= 1 and no ``stage.partition`` span."""
        store_dir = str(tmp_path)
        script = (
            "import sys, json\n"
            "from repro_torch.core.lazy import Runtime\n"
            "from repro_torch.core import lazy as bh\n"
            "from repro_torch.core.obs import trace\n"
            "tr = trace.enable()\n"
            "rt = Runtime(plan_store=sys.argv[1], loop_fusion=False,\n"
            "             device='cpu')\n"
            "with rt.activate():\n"
            "    a = bh.arange(256)\n"
            "    c = (bh.sqrt(a * 2.0 + 1.0) + a * 0.5).numpy()\n"
            "m = rt.executor.metrics\n"
            "print(json.dumps({\n"
            "    'hit': m.counter('cache.plan_store.hit').get(),\n"
            "    'write': m.counter('cache.plan_store.write').get(),\n"
            "    'partition': sum(1 for e in tr.events\n"
            "                     if e['name'] == 'stage.partition'),\n"
            "    'checksum': float(c.sum())}))\n")
        env = dict(os.environ, PYTHONPATH=_SRC)
        outs = []
        for _ in range(2):
            p = subprocess.run([sys.executable, "-c", script, store_dir],
                               capture_output=True, text=True, env=env,
                               timeout=240)
            assert p.returncode == 0, p.stderr
            outs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        cold, warm = outs
        assert cold["write"] >= 1 and cold["partition"] >= 1
        assert warm["hit"] >= 1 and warm["partition"] == 0
        assert warm["checksum"] == cold["checksum"]

    def _populate(self, store_dir):
        rt = Runtime(plan_store=store_dir, loop_fusion=False, device=CPU)
        with rt.activate():
            ref = _warm_program()
        return ref

    def _reload(self, store_dir):
        rt = Runtime(plan_store=store_dir, loop_fusion=False, device=CPU)
        with rt.activate():
            got = _warm_program()
        return rt, got

    @pytest.mark.parametrize("doctor,counter", [
        (lambda raw: raw[: len(raw) // 2], "serve.store.corrupt"),  # truncated
        (lambda raw: b"\x00\xffgarbage not json", "serve.store.corrupt"),
        (lambda raw: json.dumps(
            {**json.loads(raw), "version": SERVE_STORE_VERSION + "-next"}
        ).encode(), "serve.store.stale"),                # foreign format
        (lambda raw: json.dumps(
            {**json.loads(raw), "cost_registry_version": -1}
        ).encode(), "serve.store.stale"),                # old cost registry
        (lambda raw: json.dumps(
            {**json.loads(raw), "epoch_sensitive": True,
             "calibration_epoch": -12345}
        ).encode(), "serve.store.stale"),                # stale calibration
        (lambda raw: json.dumps(
            {**json.loads(raw), "blocks": [["not", "ints"]]}
        ).encode(), "serve.store.corrupt"),              # schema violation
    ])
    def test_fault_injection_is_a_clean_counted_miss(self, tmp_path, doctor,
                                                     counter):
        store_dir = str(tmp_path)
        ref = self._populate(store_dir)
        path = _store_file(store_dir)
        raw = _read_bytes(path)
        with open(path, "wb") as f:
            f.write(doctor(raw))
        rt, got = self._reload(store_dir)      # must not raise
        assert np.array_equal(ref, got)
        assert _counter(rt, counter) >= 1
        assert _counter(rt, "cache.plan_store.hit") == 0
        # the bad entry was re-planned and re-persisted
        assert _counter(rt, "cache.plan_store.write") >= 1

    def test_partition_backend_is_a_distinct_store_identity(self, tmp_path):
        """A store populated by the greedy backend is a clean (counted)
        miss for an ilp runtime — the backend is part of the plan key — and
        the greedy entry survives for later greedy warm starts."""
        store_dir = str(tmp_path)
        ref = self._populate(store_dir)        # greedy populates the store
        n_greedy = len(os.listdir(store_dir))
        rt = Runtime(plan_store=store_dir, loop_fusion=False,
                     partition_backend="ilp", device=CPU)
        with rt.activate():
            got = _warm_program()
        assert np.array_equal(ref, got)
        assert _counter(rt, "cache.plan_store.hit") == 0
        assert _counter(rt, "cache.plan_store.miss") >= 1
        assert _counter(rt, "cache.plan_store.write") >= 1
        assert len(os.listdir(store_dir)) > n_greedy
        rt2, got2 = self._reload(store_dir)    # greedy still warm-starts
        assert np.array_equal(ref, got2)
        assert _counter(rt2, "cache.plan_store.hit") >= 1
        rt3 = Runtime(plan_store=store_dir, loop_fusion=False,
                      partition_backend="ilp", device=CPU)
        with rt3.activate():
            got3 = _warm_program()
        assert np.array_equal(ref, got3)
        assert _counter(rt3, "cache.plan_store.hit") >= 1

    def test_crash_during_write_leaves_old_entry_readable(self, tmp_path,
                                                          monkeypatch):
        store_dir = str(tmp_path)
        ref = self._populate(store_dir)
        path = _store_file(store_dir)
        before = _read_bytes(path)

        # dying before the rename: the tmp file exists, the publish never
        # happens
        def crash(src, dst):
            raise OSError("simulated crash before rename")

        store = PlanStore(store_dir)
        monkeypatch.setattr(os, "replace", crash)
        ok = store.store(("k",) * 3, ((0,),), None)
        monkeypatch.undo()
        assert ok is False
        assert store._metrics.counter("serve.store.write_error").get() == 1
        assert _read_bytes(path) == before   # old entry untouched
        assert all(n.endswith(".json") for n in os.listdir(store_dir))
        rt, got = self._reload(store_dir)
        assert np.array_equal(ref, got)
        assert _counter(rt, "cache.plan_store.hit") >= 1

    def test_concurrent_writers_race_cleanly(self, tmp_path):
        store = PlanStore(str(tmp_path))
        key = ("greedy", "bohrium", (), ("torch",), ("sig",), "greedy")
        blocks = ((0, 1), (2,))

        def worker(i):
            for _ in range(20):
                assert store.store(key, blocks, None)
                loaded = store.load(key)
                assert loaded is not None and loaded[0] == blocks

        _run_threads(4, worker)
        assert store._metrics.counter("serve.store.corrupt").get() == 0
        assert store._metrics.counter("serve.store.stale").get() == 0
        # no orphaned temp files leaked past the atomic publish
        assert all(n.endswith(".json") for n in os.listdir(str(tmp_path)))

    def test_store_survives_unwritable_directory(self, tmp_path):
        """An unwritable store directory is a counted write error, never an
        exception.  Root ignores the mode bits, so the directory's path is
        made a regular file's child there: every write fails for anyone."""
        store_dir = str(tmp_path / "sub")
        store = PlanStore(store_dir)
        os.chmod(store_dir, 0o500)
        try:
            if os.getuid() == 0:
                store.root = str(tmp_path / "file" / "sub")
                (tmp_path / "file").write_text("")
            ok = store.store(("k",) * 3, ((0,),), None)
        finally:
            os.chmod(store_dir, 0o700)
        assert ok is False
        assert store._metrics.counter("serve.store.write_error").get() == 1


def _key():
    """A merge-cache key of the port's shape (cost token at ``key[2]``)."""
    tape = TapeProgram(3, n_actions=4).record()
    from repro_torch.core.scheduler import merge_key
    return merge_key(tape, "greedy", "bohrium", None)


def test_reference_envelope_is_a_stale_miss_in_the_port(tmp_path):
    key = _key()
    RefPlanStore(str(tmp_path)).store(key, ((0, 1),), None)
    port = PlanStore(str(tmp_path))
    assert port.path_for(key) == RefPlanStore(str(tmp_path)).path_for(key)
    assert port.load(key) is None
    assert port._metrics.counter("serve.store.stale").get() == 1
    assert port._metrics.counter("serve.store.corrupt").get() == 0


def test_port_envelope_is_a_stale_miss_in_the_reference(tmp_path):
    key = _key()
    PlanStore(str(tmp_path)).store(key, ((0, 1),), None)
    ref = RefPlanStore(str(tmp_path))
    assert ref.load(key) is None
    assert ref._metrics.counter("serve.store.stale").get() == 1
    assert ref._metrics.counter("serve.store.corrupt").get() == 0
    port = PlanStore(str(tmp_path))             # and the port reads it back
    assert port.load(key) == (((0, 1),), None)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

class TestAdmission:
    def test_backpressure_then_reject_on_timeout(self):
        adm = AdmissionController(max_pending=1)
        adm.acquire("a")
        t0 = time.perf_counter()
        with pytest.raises(ServeRejected):
            adm.acquire("b", timeout=0.05)
        assert time.perf_counter() - t0 >= 0.05
        m = adm._metrics
        assert m.counter("serve.admission.backpressure_waits").get() == 1
        assert m.counter("serve.admission.rejected",
                         ("tenant",)).get(("b",)) == 1
        adm.release("a")
        adm.acquire("b", timeout=0.05)     # slot freed: admitted
        adm.release("b")
        assert m.gauge("serve.queue_depth").get() == 0

    def test_backpressure_wakes_waiter(self):
        adm = AdmissionController(max_pending=1)
        adm.acquire("a")
        admitted = threading.Event()

        def waiter():
            adm.acquire("b", timeout=5.0)
            admitted.set()

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        time.sleep(0.05)
        assert not admitted.is_set()       # parked behind the full queue
        adm.release("a")
        assert admitted.wait(2.0)
        t.join(JOIN_S)
        assert not t.is_alive()

    def test_per_tenant_cap_keeps_other_tenants_admissible(self):
        adm = AdmissionController(max_pending=8, per_tenant=1)
        adm.acquire("greedy")
        with pytest.raises(ServeRejected):
            adm.acquire("greedy", timeout=0.01)
        adm.acquire("other", timeout=0.01)  # unaffected by greedy's cap
        adm.release("greedy")
        adm.release("other")

    def test_server_rejects_when_full(self):
        srv = Server(batching=False, max_pending=1, device=CPU)
        release = threading.Event()
        started = threading.Event()

        def slow(tenant):
            def fn():
                started.set()
                release.wait(5.0)
                return bh.full((8,), 1.0)
            return srv.submit(tenant, fn)

        t = threading.Thread(target=slow, args=("a",), daemon=True)
        t.start()
        assert started.wait(2.0)
        with pytest.raises(ServeRejected):
            srv.submit("b", lambda: bh.full((8,), 2.0), timeout=0.05)
        release.set()
        t.join(JOIN_S)
        assert not t.is_alive()
        out = srv.submit("b", lambda: bh.full((8,), 2.0), timeout=1.0)
        assert float(out[0]) == 2.0


def test_admission_counters_match_the_reference():
    """The same acquire/release sequence leaves the same counters in both
    packages' controllers."""
    from repro.core.serve import AdmissionController as RefAdmission
    snaps = []
    for cls in (RefAdmission, AdmissionController):
        adm = cls(max_pending=2, per_tenant=1)
        adm.acquire("a")
        adm.acquire("b")
        for tenant in ("a", "c"):
            with pytest.raises(Exception) as e:
                adm.acquire(tenant, timeout=0.0)
            assert type(e.value).__name__ == "ServeRejected"
        adm.release("a")
        adm.acquire("c")
        m = adm._metrics
        snaps.append((
            m.counter("serve.admission.admitted", ("tenant",)).values,
            m.counter("serve.admission.rejected", ("tenant",)).values,
            m.counter("serve.admission.backpressure_waits").get(),
            m.gauge("serve.queue_depth").get(), adm.pending))
    assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# micro-batching server
# ---------------------------------------------------------------------------

class TestServerBatching:
    TENANTS = 4

    def _datas(self, seed=3):
        rng = np.random.default_rng(seed)
        return [np.floor(rng.random(64) * 16.0) for _ in range(self.TENANTS)]

    def _concurrent(self, srv, datas, rounds=1, **req_kw):
        out = {}
        barrier = threading.Barrier(self.TENANTS)

        def worker(i):
            for r in range(rounds):
                barrier.wait(JOIN_S)
                out[(i, r)] = srv.submit(i, _make_request(datas[i], **req_kw))

        _run_threads(self.TENANTS, worker)
        return out

    @pytest.mark.parametrize("with_random", [False, True])
    def test_batched_equals_serial_bitwise(self, with_random):
        datas = self._datas()
        ref_srv = Server(batching=False, device=CPU)
        refs = {}
        for r in range(2):
            for i in range(self.TENANTS):
                refs[(i, r)] = ref_srv.submit(
                    i, _make_request(datas[i], with_random=with_random))
        srv = Server(window_s=0.25, max_batch=self.TENANTS, device=CPU)
        out = self._concurrent(srv, datas, rounds=2,
                               with_random=with_random)
        for k in refs:
            assert refs[k].tobytes() == out[k].tobytes(), f"request {k}"
        m = srv.metrics
        assert m.counter("serve.batched_requests").get() >= self.TENANTS
        assert m.counter("serve.batches").get() >= 1

    def test_batch_sustains_four_tenants(self):
        """>= 4 concurrent tenants, coalesced into shared dispatches,
        bitwise identical to the unbatched path."""
        datas = self._datas(seed=11)
        ref_srv = Server(batching=False, device=CPU)
        refs = [ref_srv.submit(i, _make_request(datas[i]))
                for i in range(self.TENANTS)]
        srv = Server(window_s=0.5, max_batch=self.TENANTS, device=CPU)
        out = self._concurrent(srv, datas)
        for i in range(self.TENANTS):
            assert refs[i].tobytes() == out[(i, 0)].tobytes()
        assert srv.metrics.counter("serve.batch.requests").get() \
            == self.TENANTS
        assert srv.metrics.counter("serve.batch.dispatches").get() == 1

    def test_structurally_distinct_requests_do_not_coalesce(self):
        srv = Server(window_s=0.05, max_batch=4, device=CPU)
        outs = {}
        barrier = threading.Barrier(2)

        def worker(i):
            barrier.wait(JOIN_S)
            scale = float(i + 2)           # different literal => different

            def fn():                      # structure => no shared group
                a = bh.arange(32)
                return a * scale + 1.0
            outs[i] = srv.submit(i, fn)

        _run_threads(2, worker)
        for i in range(2):
            assert np.array_equal(outs[i],
                                  np.arange(32) * float(i + 2) + 1.0)
        assert srv.metrics.counter("serve.batches").get() == 0
        assert srv.metrics.counter("serve.singles").get() == 2

    def test_request_fn_may_materialize_early(self):
        srv = Server(window_s=0.01, device=CPU)

        def fn():
            a = bh.arange(16)
            s = float(a.sum().numpy())     # early sync: batching forfeited
            return a + s
        out = srv.submit("t", fn)
        assert np.array_equal(out, np.arange(16) + 120.0)
        assert srv.metrics.counter("serve.singles").get() == 1

    def test_tenant_state_isolated_across_requests(self):
        srv = Server(batching=False, device=CPU)
        a = srv.submit("x", lambda: bh.full((4,), 1.0))
        b = srv.submit("y", lambda: bh.full((4,), 2.0))
        a2 = srv.submit("x", lambda: bh.full((4,), 1.0))
        assert float(a[0]) == 1.0 and float(b[0]) == 2.0
        assert np.array_equal(a, a2)

    def test_server_with_plan_store_end_to_end(self, tmp_path):
        datas = self._datas(seed=7)
        srv1 = Server(store=str(tmp_path), window_s=0.1,
                      max_batch=self.TENANTS, device=CPU)
        out1 = self._concurrent(srv1, datas)
        assert _counter(srv1.runtime, "cache.plan_store.write") >= 1
        srv2 = Server(store=str(tmp_path), window_s=0.1,
                      max_batch=self.TENANTS, device=CPU)
        out2 = self._concurrent(srv2, datas)
        assert _counter(srv2.runtime, "cache.plan_store.hit") >= 1
        for k in out1:
            assert out1[k].tobytes() == out2[k].tobytes()

    def test_triton_plans_run_solo(self):
        """The batching rule: a plan that lowers a block to anything but
        the floor runs every member solo — under ``backend="triton"`` the
        fused-block kernel (its plain version on the CPU) claims these
        blocks, so nothing batches and the values are the floor's."""
        datas = self._datas(seed=5)
        ref_srv = Server(batching=False, device=CPU)
        refs = [ref_srv.submit(i, _make_request(datas[i], True))
                for i in range(self.TENANTS)]
        srv = Server(window_s=0.25, max_batch=self.TENANTS, backend="triton",
                     device=CPU)
        out = self._concurrent(srv, datas, with_random=True)
        for i in range(self.TENANTS):
            assert refs[i].tobytes() == out[(i, 0)].tobytes()
        m = srv.metrics
        assert m.counter("serve.batches").get() == 0
        assert m.counter("serve.singles").get() == self.TENANTS
        st = srv.runtime.executor.stats
        assert st["backend_blocks"]["triton"] >= self.TENANTS
        assert st["backend_blocks"]["torch"] == 0

    def test_batched_dispatch_has_a_batching_rule_for_every_op(self):
        """With vmap's per-example fallback turned off (it would loop over
        the requests), the batched dispatch still runs: every floor op on
        the load's and check_serve's tapes has a batching rule."""
        from torch._C import _functorch
        datas = self._datas(seed=9)
        was = _functorch._is_vmap_fallback_enabled()
        _functorch._set_vmap_fallback_enabled(False)
        try:
            for make in (lambda d, t: _make_request(d, True),
                         lambda d, t: tapegen.serve_request(bh, 17, d, 12)):
                ref_srv = Server(batching=False, device=CPU)
                refs = [ref_srv.submit(t, make(datas[t], t))
                        for t in range(self.TENANTS)]
                srv = Server(window_s=0.5, max_batch=self.TENANTS,
                             device=CPU)
                out = {}
                barrier = threading.Barrier(self.TENANTS)

                def worker(t):
                    barrier.wait(JOIN_S)
                    out[t] = srv.submit(t, make(datas[t], t))

                _run_threads(self.TENANTS, worker)
                for t in range(self.TENANTS):
                    assert refs[t].tobytes() == out[t].tobytes()
                assert srv.metrics.counter("serve.batches").get() == 1
        finally:
            _functorch._set_vmap_fallback_enabled(was)


def test_batch_fn_takes_only_floor_blocks():
    """``build_batch_fn`` refuses a plan with a block lowered off the floor
    instead of running it some other way."""
    from repro_torch.core.backends import LoweringDecision
    from repro_torch.core.backends.batch_body import build_batch_fn
    from repro_torch.core.cache import tape_io
    from repro_torch.core.scheduler import Scheduler
    tape = TapeProgram(2, n_actions=4).record()
    rt = Runtime(device=CPU, backend="torch")
    sched = Scheduler().plan(tape, lowering=rt.executor.lowering_policy())
    ins, outs, _ = tape_io(tape)
    ctx = rt.executor.lowering_context()
    fn, n_rand = build_batch_fn(sched.tape, sched.blocks, ins, outs, ctx)
    assert n_rand == sum(op.opcode == "random" for op in tape)
    from dataclasses import replace
    bad = [replace(p, lowering=LoweringDecision("triton")) if p.has_work
           else p for p in sched.blocks]
    with pytest.raises(ValueError, match="torch floor"):
        build_batch_fn(sched.tape, bad, ins, outs, ctx)


# ---------------------------------------------------------------------------
# check_serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(10))
def test_check_serve(seed):
    tapegen.check_serve(seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_check_serve_xref(seed):
    """The same seed through the reference's ``check_serve`` recipe (its
    ``TapeProgram`` and a batching-off ``repro.core.serve.Server``) and
    through the port's ``check_serve``: both phases' outputs bitwise."""
    tenants, requests, n_actions, size = 4, 2, 8, 64
    got = tapegen.check_serve(seed, tenants=tenants, requests=requests,
                              n_actions=n_actions, size=size)
    prog_seeds, datas, rseeds = tapegen.serve_recipe(
        seed, tenants=tenants, requests=requests, size=size)
    for i, s in enumerate(prog_seeds):
        want = RefTapeProgram(s, n_actions=n_actions, size=size,
                              exact=True).run()
        _assert_bitwise(want, got["sessions"][i], f"seed {seed} tenant {i}")
    ref_srv = RefServer(batching=False)
    for r, rs in enumerate(rseeds):
        for i in range(tenants):
            want = ref_srv.submit(i, tapegen.serve_request(jbh, rs, datas[i],
                                                           n_actions))
            _assert_bitwise([want], [got["served"][(i, r)]],
                            f"seed {seed} request {(i, r)}")
