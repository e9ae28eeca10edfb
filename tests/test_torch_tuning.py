"""The port's measured-cost calibration (``repro_torch.core.tuning``, the
``calibrated`` cost model) against the JAX package's, on the CPU.

* ``fit_profile``: the same synthetic samples, drawn from a seed with
  numpy, give EXACTLY the reference's fitted launch prices, byte slopes and
  residual (the same numpy arithmetic on the same arrays); the defaults for
  what a profile cannot identify differ only by each package's rates;
* profiles round-trip through JSON and refuse a bumped registry version, a
  foreign schema and a profile the JAX package wrote;
* the executor's profiler is off by default, skips cold dispatches and
  records warm ones with the block's own features;
* ``calibrated`` with no fit prices exactly like ``gpu``, stays monotone
  under a fit, lets an installed fit flip a triton/torch tie and the
  decisions of the benchmark programs, invalidates the merge cache on a new
  fit, and runs an exact program bitwise to the ``gpu`` runtime;
* ``calibrate(device="cpu")`` at small sizes fits both backends, and
  raises without a card unless given a device.

The measured version of the decision flip (the reference's
``test_calibration_changes_benchmark_decisions``, which depends on a wall
clock) runs on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``'s
``CALIBRATED`` lines); here a synthetic fit is installed instead.
"""

import numpy as np
import pytest
import torch

from repro.core import cost as ref_cost
from repro.core import tuning as ref_tuning

from repro_torch.core import cost
from repro_torch.core import lazy as bh
from repro_torch.core import make_cost_model, model_cache_token, partition
from repro_torch.core.backends import (LoweringContext, get_backend,
                                       select_lowering)
from repro_torch.core.blocks import BlockInfo
from repro_torch.core.cache import tape_signature
from repro_torch.core.cost import GPUCost
from repro_torch.core.ir import BaseArray, Op, View
from repro_torch.core.lazy import fresh_runtime
from repro_torch.core.scheduler import plan_blocks
from repro_torch.core.tuning import (CalibratedFit, Profile, Profiler,
                                     ProfileSample, StaleProfileError,
                                     calibrate, clear_fit, current_epoch,
                                     fit_profile, install_fit,
                                     load_and_install)
from repro_torch.core.tuning.calibrate import CARD_SIZES
from repro_torch.testing.programs import BENCHMARKS
from repro_torch.testing.tapegen import TapeProgram

CPU = "cpu"


@pytest.fixture(autouse=True)
def _no_leaked_fit():
    """Every test starts and ends with no installed calibration, in either
    package."""
    clear_fit()
    ref_tuning.clear_fit()
    yield
    clear_fit()
    ref_tuning.clear_fit()


# ---------------------------------------------------------------------------
# fit_profile, held against the reference
# ---------------------------------------------------------------------------

def _synthetic(seed, *, fabric=False, constant_bytes=False):
    """Rows ``(backend, sig, wall_s, dispatches, hbm_bytes, fabric_bytes,
    n_ops)`` drawn from ``seed``: per backend a launch price and a byte
    slope, 1-2 dispatches a key, several repeats a key with positive noise,
    and a few 20x outliers (a GC pause) for the residual trim."""
    rng = np.random.default_rng(seed)
    rows = []
    for backend, launch, slope in (("torch", 9e-5, 4e-12),
                                   ("triton", 4e-5, 3.2e-12)):
        for k in range(int(rng.integers(6, 12))):
            nbytes = 4096.0 if constant_bytes else \
                float(2 ** int(rng.integers(12, 28)))
            fab = float(rng.integers(0, 4) * 65536) if fabric else 0.0
            disp = int(rng.integers(1, 3))
            base = launch * disp + slope * nbytes + 2e-11 * fab
            for r in range(int(rng.integers(1, 4))):
                wall = base * (1.0 + float(rng.exponential(0.05)))
                if rng.random() < 0.08:
                    wall *= 20.0
                rows.append((backend, f"{seed:04d}{k:012d}", wall, disp,
                             nbytes, fab, int(rng.integers(1, 9))))
    return rows


def _fits(rows):
    port = fit_profile(Profile([ProfileSample(*r) for r in rows]))
    ref = ref_tuning.fit_profile(
        ref_tuning.Profile([ref_tuning.ProfileSample(*r) for r in rows]))
    return port, ref


@pytest.mark.parametrize("seed", range(8))
def test_fit_profile_equals_reference_exactly(seed):
    port, ref = _fits(_synthetic(seed))
    assert port.launch_s == ref.launch_s
    assert port.hbm_slope_s == ref.hbm_slope_s
    assert port.hbm_s_per_byte == ref.hbm_s_per_byte
    assert port.residual_s == ref.residual_s
    assert (port.n_samples, port.n_keys) == (ref.n_samples, ref.n_keys)
    assert set(port.launch_s) == {"torch", "triton"}
    assert all(v > 0 for v in port.launch_s.values())


@pytest.mark.parametrize("seed", range(3))
def test_fit_profile_with_fabric_column_equals_reference(seed):
    port, ref = _fits(_synthetic(100 + seed, fabric=True))
    assert port.launch_s == ref.launch_s
    assert port.hbm_slope_s == ref.hbm_slope_s
    assert port.fabric_s_per_byte == ref.fabric_s_per_byte
    assert port.residual_s == ref.residual_s


def test_unfitted_defaults_differ_only_by_each_packages_rates():
    port, ref = _fits(_synthetic(7, constant_bytes=True))
    assert port.launch_s == ref.launch_s
    assert port.hbm_slope_s == ref.hbm_slope_s == {}
    assert port.hbm_s_per_byte == 1.0 / cost.HBM_BW
    assert ref.hbm_s_per_byte == 1.0 / ref_cost.HBM_BW
    assert port.fabric_s_per_byte == 1.0 / cost.FABRIC_BW
    assert ref.fabric_s_per_byte == 1.0 / ref_cost.ICI_BW


def test_fit_recovers_synthetic_coefficients():
    launch, slope = 3e-5, 2e-12
    samples = [ProfileSample("triton", f"{i:016d}", launch + slope * b,
                             1, float(b), 0.0, 2)
               for i, b in enumerate((2 ** 15, 2 ** 21, 2 ** 25, 2 ** 27))]
    fit = fit_profile(Profile(samples))
    assert fit.launch_s["triton"] == pytest.approx(launch, rel=1e-6)
    assert fit.hbm_slope_s["triton"] == pytest.approx(slope, rel=1e-6)
    assert fit.hbm_s_per_byte == pytest.approx(slope, rel=1e-6)


def test_fit_empty_profile_is_none():
    assert fit_profile(Profile()) is None


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------

def _toy_profile(cls=Profile, sample=ProfileSample):
    # walls = launch + slope*bytes, torch launch 1e-5 < triton 4e-5
    return cls([
        sample("torch", "a" * 16, 2e-5, 1, 4096.0, 0.0, 3),
        sample("torch", "b" * 16, 3e-5, 1, 8192.0, 0.0, 4),
        sample("triton", "a" * 16, 6e-5, 1, 4096.0, 0.0, 3),
        sample("triton", "b" * 16, 8e-5, 1, 8192.0, 0.0, 4),
    ])


def test_profile_json_roundtrip(tmp_path):
    path = str(tmp_path / "profile.json")
    prof = _toy_profile()
    prof.save(path)
    back = Profile.load(path)
    assert back.samples == prof.samples
    assert back.backends() == ("torch", "triton")


def test_stale_profile_refused_on_registry_bump(tmp_path, monkeypatch):
    path = str(tmp_path / "profile.json")
    _toy_profile().save(path)
    monkeypatch.setattr(cost, "COST_REGISTRY_VERSION",
                        cost.COST_REGISTRY_VERSION + 1)
    with pytest.raises(StaleProfileError):
        Profile.load(path)
    with pytest.raises(StaleProfileError):
        load_and_install(path)


def test_reference_written_profile_refused(tmp_path):
    """A profile the JAX package wrote priced its xla/pallas backends on
    other hardware: the port refuses it, whatever its registry number."""
    path = str(tmp_path / "profile.json")
    _toy_profile(ref_tuning.Profile, ref_tuning.ProfileSample).save(path)
    with pytest.raises(StaleProfileError, match="schema"):
        Profile.load(path)
    with pytest.raises(StaleProfileError):
        load_and_install(path)


def test_garbage_schema_refused(tmp_path):
    path = str(tmp_path / "profile.json")
    with open(path, "w") as f:
        f.write('{"schema": "something_else", "samples": []}')
    with pytest.raises(StaleProfileError):
        Profile.load(path)


def test_load_and_install_warm_start(tmp_path):
    path = str(tmp_path / "profile.json")
    _toy_profile().save(path)
    fit = load_and_install(path)
    assert fit.n_keys == 4
    assert fit.launch_s["triton"] > fit.launch_s["torch"]
    m = make_cost_model("calibrated")
    assert m.fit == fit
    assert (m.dispatch_price(1, backend="triton")
            > m.dispatch_price(1, backend="torch"))


def test_load_of_an_empty_profile_raises(tmp_path):
    path = str(tmp_path / "profile.json")
    Profile().save(path)
    with pytest.raises(ValueError, match="no samples"):
        load_and_install(path)


# ---------------------------------------------------------------------------
# Profiler capture
# ---------------------------------------------------------------------------

def _doubling(profiler, backend, flushes):
    """``flushes`` flushes of ``y = x * 2`` over 2048 float64 values, each
    read back; returns the last result."""
    with fresh_runtime(algorithm="greedy", backend=backend, device=CPU,
                       profiler=profiler):
        x = bh.asarray(np.arange(2048.0))
        for _ in range(flushes):
            got = (x * 2.0).numpy()
    return got


@pytest.mark.parametrize("backend", ["torch", "triton"])
def test_profiler_records_warm_dispatches_with_block_features(backend):
    p = Profiler()
    got = _doubling(p, backend, 4)
    np.testing.assert_array_equal(got, np.arange(2048.0) * 2.0)
    assert len(p) > 0, "identical flushes must produce warm samples"
    for s in p.profile.samples:
        assert s.backend == backend
        assert s.wall_s > 0.0
        assert s.dispatches == 1
        assert s.hbm_bytes == 2 * 2048 * 8      # x read, y written
        assert s.fabric_bytes == 0.0
        assert s.n_ops == 1
        assert len(s.sig) == 16


def test_profiler_features_are_the_backends_and_blocks_own():
    """``dispatches`` is the winning backend's own answer and ``hbm_bytes``
    the block's Def. 13 external bytes, for every recorded dispatch of a
    program that mixes both backends (a matmul the triton generator
    declines)."""
    seen = []

    class Spy(Profiler):
        def record(self, backend, ops, plan, ctx, wall_s):
            seen.append((backend, list(ops), plan, ctx))
            super().record(backend, ops, plan, ctx, wall_s)

    p = Spy()
    with fresh_runtime(algorithm="greedy", backend="triton", device=CPU,
                       profiler=p):
        a = bh.asarray(np.arange(64.0).reshape(8, 8))
        for _ in range(3):
            m = bh.matmul(a, a) * 0.5 + 1.0
            float(m.sum().numpy())
    assert {b for b, *_ in seen} == {"torch", "triton"}
    for (backend, ops, plan, ctx), s in zip(seen, p.profile.samples):
        assert s.dispatches == get_backend(backend).dispatches(ops, plan,
                                                               ctx)
        assert s.hbm_bytes == BlockInfo.from_ops(ops).ext_size("bytes")


def test_profiler_skips_cold_dispatches():
    p = Profiler()
    _doubling(p, "triton", 1)          # single flush: everything cold
    assert len(p) == 0


def test_profiler_off_by_default():
    with fresh_runtime(algorithm="greedy", device=CPU) as rt:
        assert rt.executor.profiler is None


def test_profiler_keeps_flushes_out_of_fused_loops():
    """A profiler needs per-block timings, so a recurring tape is never
    deferred into a fused loop while one is attached."""
    p = Profiler()
    with fresh_runtime(algorithm="greedy", device=CPU, profiler=p,
                       loop_threshold=2) as rt:
        x = bh.asarray(np.linspace(0.0, 1.0, 64))
        bh.flush()
        for _ in range(6):
            y = x * 0.5 + 0.1
            x.delete()
            x = y
            bh.flush()
        x.numpy()
        events = list(rt._loop.events)
        assert not any(h.get("loop_deferred") for h in rt.history)
    assert any(e["event"] == "break" and e.get("reason") == "profiler-active"
               for e in events)
    assert not any(e["event"] in ("arm", "defer") for e in events)
    assert len(p) > 0


# ---------------------------------------------------------------------------
# The calibrated cost model
# ---------------------------------------------------------------------------

def _tape(build):
    """Record ``build()``'s ops on a CPU runtime without executing."""
    with fresh_runtime(device=CPU) as rt:
        arrays = build()
        tape = list(rt.tape)
        rt.tape.clear()
        for a in arrays:
            a._alive = False
    return tape


def _work_blocks():
    def build():
        x = bh.random((512,))
        y = bh.sin(x) * 0.5 + x
        s = y.sum()
        out = bh.zeros((512,)) + s.broadcast_to((512,))
        return x, y, s, out
    infos = [BlockInfo.from_op(op) for op in _tape(build)
             if not op.is_system()]
    merged = infos[0]
    for bi in infos[1:]:
        merged = merged.merged_with(bi)
    return infos + [merged]


def test_calibrated_zero_samples_is_the_gpu_model():
    """With no installed fit, ``calibrated`` prices exactly like ``gpu``:
    the same block costs, dispatch and lowering prices, and partitions."""
    cal, gpu = make_cost_model("calibrated"), GPUCost()
    assert cal.fit is None
    assert (cal.hbm_bw, cal.launch_s) == (gpu.hbm_bw, gpu.launch_s)
    for b in _work_blocks():
        assert cal.block_cost(b) == gpu.block_cost(b)
    for n in (1, 2, 3):
        for be in (None, "torch", "triton"):
            assert cal.dispatch_price(n, backend=be) == \
                gpu.dispatch_price(n, backend=be)
            # the byte term every backend pays alike: no decision moves
            assert cal.lowering_price(n, 4096.0, backend=be) == \
                gpu.lowering_price(n, 4096.0, backend=be) \
                + (1.0 / gpu.hbm_bw) * 4096.0
    for seed in range(4):
        tape = TapeProgram(seed, n_actions=12, exact=False).record()
        a = partition(tape, cost_model="calibrated")
        b = partition(tape, cost_model="gpu")
        assert a.op_blocks() == b.op_blocks() and a.cost == b.cost


def test_calibrated_is_monotone_under_fit():
    install_fit(CalibratedFit(launch_s={"torch": 1e-4, "triton": 5e-4},
                              hbm_slope_s={"torch": 3e-12},
                              hbm_s_per_byte=3e-12, fabric_s_per_byte=1e-9))
    m = make_cost_model("calibrated")
    assert m.launch_s == 1e-4 and m.hbm_bw == 1.0 / 3e-12
    blocks = _work_blocks()
    merged = blocks[-1]
    for b in blocks[:-1]:
        assert m.merge_saving(b, merged) >= -1e-12
        assert m.block_cost(b) > 0.0


def test_calibrated_refuses_a_comm_block():
    """A COMM block is priced with the reference's fabric term (it raised
    before the mesh was ported): ``gpu``'s price plus the block's unique
    collective bytes times the fabric slope — ``1 / FABRIC_BW`` with no
    fit, the fit's ``fabric_s_per_byte`` with one."""
    from repro_torch.core.dist import ShardSpec, block_comm_bytes
    a = BaseArray(64, np.dtype(np.float64))
    a.shard_spec = ShardSpec.for_dim((64,), 0, "dev", 4)
    o = BaseArray(64, np.dtype(np.float64))
    op = Op("comm_allgather", View.contiguous(o, (64,)),
            (View.contiguous(a, (64,)),), new_bases=frozenset({o}))
    b = BlockInfo.from_op(op)
    fabric = block_comm_bytes([op])
    assert fabric == 3 * 64 * 8
    gpu = make_cost_model("gpu").block_cost(b)
    assert make_cost_model("calibrated", fit=None).block_cost(b) == \
        pytest.approx(gpu + fabric / cost.FABRIC_BW, rel=1e-15)
    fit = CalibratedFit(launch_s={}, hbm_slope_s={},
                        hbm_s_per_byte=1.0 / cost.HBM_BW,
                        fabric_s_per_byte=1e-9)
    assert make_cost_model("calibrated", fit=fit).block_cost(b) == \
        pytest.approx(gpu + fabric * 1e-9, rel=1e-15)


def _tie_block():
    def build():
        x = bh.random((1024,))
        y = x * 2.0 + 1.0
        return x, y
    tape = _tape(build)
    return tape, plan_blocks(tape, [list(range(len(tape)))])[0]


def test_fitted_prices_flip_a_tie():
    install_fit(CalibratedFit(launch_s={"torch": 1e-5, "triton": 9e-5},
                              hbm_slope_s={}, hbm_s_per_byte=1e-12,
                              fabric_s_per_byte=1e-9))
    m = make_cost_model("calibrated")
    ctx = LoweringContext(device=torch.device(CPU))
    tape, plan = _tie_block()
    stack = ("triton", "torch")
    d_analytic = select_lowering(tape, plan, stack, ctx, GPUCost())
    d_cal = select_lowering(tape, plan, stack, ctx, m)
    assert d_analytic.backend == "triton"     # tie -> preference order
    assert d_cal.backend == "torch"           # measured overhead flips it
    assert d_cal.reason_for("triton") is None  # declined on price


def test_fitted_byte_slopes_price_each_backend():
    install_fit(CalibratedFit(launch_s={"torch": 1e-5, "triton": 1e-5},
                              hbm_slope_s={"torch": 9e-12,
                                           "triton": 3e-12},
                              hbm_s_per_byte=3e-12))
    m = make_cost_model("calibrated")
    ctx = LoweringContext(device=torch.device(CPU))
    tape, plan = _tie_block()
    d = select_lowering(tape, plan, ("torch", "triton"), ctx, m)
    assert d.backend == "triton"              # cheaper bytes win it
    assert m.lowering_price(1, 1e6, backend="torch") == \
        pytest.approx(1e-5 + 9e-6)


SYNTHETIC_FIT = CalibratedFit(launch_s={"torch": 2e-6, "triton": 6e-5},
                              hbm_slope_s={"torch": 3.5e-12,
                                           "triton": 3.1e-12},
                              hbm_s_per_byte=3.1e-12)


@pytest.mark.parametrize("name,args", [("black_scholes", (2, 1024)),
                                       ("heat_equation", (2, 24)),
                                       ("leibnitz_pi", (2, 1024))])
def test_installed_fit_changes_benchmark_decisions(name, args):
    """A fit whose floor launches cheaper than B1's wrapper moves the
    small blocks of the paper's programs to the floor: the decisions
    recomputed per executed block under ``gpu`` and ``calibrated``
    differ."""
    install_fit(SYNTHETIC_FIT)
    gpu, cal = make_cost_model("gpu"), make_cost_model("calibrated")
    rows = []
    with fresh_runtime(algorithm="greedy", cost_model="gpu",
                       backend="triton", device=CPU,
                       loop_fusion=False) as rt:
        ctx = rt.executor.lowering_context()
        orig = rt.executor.run_schedule

        def spy(schedule, buffers):
            for plan in schedule.blocks:
                if plan.has_work:
                    ops = [schedule.tape[i] for i in plan.op_indices]
                    rows.append(tuple(
                        select_lowering(ops, plan, ("triton", "torch"),
                                        ctx, m).backend
                        for m in (gpu, cal)))
            return orig(schedule, buffers)

        rt.executor.run_schedule = spy
        BENCHMARKS[name](*args)
    assert rows and all(a == "triton" for a, _ in rows)
    assert sum(1 for a, c in rows if a != c) >= 1


def test_install_fit_bumps_epoch_and_invalidates_cache():
    e0 = current_epoch()
    install_fit(CalibratedFit(launch_s={"torch": 1e-5}))
    assert current_epoch() == e0 + 1
    assert model_cache_token("calibrated") == ("calibrated_epoch", e0 + 1)
    assert model_cache_token("gpu") == ()

    def step():
        x = bh.random((512,))
        y = x * 2.0 + 1.0
        return float(y.sum().numpy())

    with fresh_runtime(algorithm="greedy", cost_model="calibrated",
                       device=CPU) as rt:
        step()   # first tape lacks the previous iteration's DELs
        step()
        step()
        assert rt.history[-1]["cached"], "identical tape must hit the cache"
        install_fit(CalibratedFit(launch_s={"torch": 5e-5}))
        step()
        assert not rt.history[-1]["cached"], (
            "a new fit must invalidate plans priced under the old epoch")
        step()
        assert rt.history[-1]["cached"]


def test_cost_token_sits_at_key_index_2():
    tape = TapeProgram(1, n_actions=6).record()
    k = tape_signature(tape, "greedy", "calibrated", backends=("triton",),
                       cost_token=("calibrated_epoch", 5))
    assert k[:3] == ("greedy", "calibrated", ("calibrated_epoch", 5))
    assert k[-1] == "greedy"


@pytest.mark.parametrize("seed", range(4))
def test_calibrated_runtime_bitwise_to_gpu_runtime(seed):
    """Decisions may move blocks between the kernel and the floor; the
    values of an exact program stay the same bits."""
    install_fit(SYNTHETIC_FIT)
    prog = TapeProgram(seed, n_actions=16, exact=True)
    want = prog.run(device=CPU, backend="triton", cost_model="gpu")
    got = prog.run(device=CPU, backend="triton", cost_model="calibrated")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The calibration loop
# ---------------------------------------------------------------------------

def test_calibrate_on_the_cpu_fits_both_backends(tmp_path):
    path = str(tmp_path / "profile.json")
    fit = calibrate(seeds=range(2), repeats=3, sizes=(64, 2048),
                    save=path, device=CPU)
    assert set(fit.launch_s) == {"torch", "triton"}
    assert all(v > 0 for v in fit.launch_s.values())
    assert fit.n_keys > 0 and fit.n_samples >= fit.n_keys
    assert make_cost_model("calibrated").fit == fit
    again = load_and_install(path)
    assert (again.launch_s, again.hbm_slope_s) == (fit.launch_s,
                                                   fit.hbm_slope_s)
    assert again.epoch == fit.epoch + 1


def test_calibrate_without_samples_raises():
    with pytest.raises(RuntimeError, match="no warm samples"):
        calibrate(seeds=(), sizes=(64,), device=CPU)


def test_card_sizes_span_launch_to_bandwidth_bound():
    """The default sizes run from 32 KiB to 32 MiB of float64 an array, so
    the fit sees launch-bound and bandwidth-bound blocks on the card."""
    assert CARD_SIZES == tuple(sorted(CARD_SIZES))
    assert CARD_SIZES[0] * 8 <= 32 * 1024 and CARD_SIZES[-1] * 8 >= 2 ** 25


def test_calibrate_needs_a_card_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: calibrate() would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate(seeds=range(1), sizes=(64,))
