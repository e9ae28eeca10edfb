"""The port's runtime around the kernels: functional writes keep SYNC
snapshots intact, the merge and executable caches replay plans, the stats
keep the reference's shape under the port's names, and the scheduler's
lower stage routes each block by the generator's claim."""

import numpy as np
import pytest

from repro_torch.core import lazy as bh
from repro_torch.core.lazy import fresh_runtime


@pytest.mark.parametrize("backend", ["torch", "triton"])
def test_partial_write_leaves_sync_snapshot_intact(backend):
    """A buffer the executor snapshotted for a SYNC is never written in
    place: a later read-modify-write of the same base makes a new tensor."""
    with fresh_runtime(backend=backend, device="cpu") as rt:
        x = bh.arange(8) * 1.0
        first = x.numpy()
        uid = x.view.base.uid
        snap = rt.executor.sync_store[uid]
        x[2:4] = 7.0
        x += 1.0
        second = x.numpy()
        np.testing.assert_array_equal(snap.numpy(), np.arange(8.0))
        np.testing.assert_array_equal(first, np.arange(8.0))
        want = np.arange(8.0)
        want[2:4] = 7.0
        np.testing.assert_array_equal(second, want + 1.0)
        second[:] = -1.0            # the host copy is the caller's own
        np.testing.assert_array_equal(x.numpy(), want + 1.0)


def test_aliasing_copy_then_update_does_not_leak():
    """``y = x.copy()`` may share storage with ``x`` on the floor; an
    in-place update of ``x`` must still leave ``y`` alone."""
    with fresh_runtime(device="cpu"):
        x = bh.asarray(np.arange(6.0))
        y = x.copy()
        bh.flush()
        x += 10.0
        x[0:2] = 0.0
        np.testing.assert_array_equal(y.numpy(), np.arange(6.0))


def test_stats_shape_and_caches():
    with fresh_runtime(backend="triton", device="cpu") as rt:
        for _ in range(3):
            a = bh.random((64,))
            b = (a * 2.0 + 1.0).sum()
            b.numpy()
            a.delete()
        st = rt.executor.stats
        assert set(st) >= {"blocks_run", "exec_cache_hits",
                           "exec_cache_misses", "triton_blocks",
                           "triton_fallback_blocks", "triton_fallbacks",
                           "backend_blocks", "backend_fallbacks"}
        assert st["triton_blocks"] >= 3 and st["exec_cache_hits"] >= 1
        assert dict(st["backend_blocks"])["triton"] == st["triton_blocks"]
        assert rt.cache.hits >= 1                  # merge cache replays
        assert any(h["cached"] for h in rt.history)
        assert "exec" in rt.history[-1]


def test_decline_is_counted_with_its_slug_and_runs_on_the_floor():
    with fresh_runtime(backend="triton", device="cpu") as rt:
        a = bh.asarray(np.arange(12.0).reshape(3, 4))
        b = bh.asarray(np.arange(12.0)[::-1].reshape(4, 3))
        mm = bh.matmul(a, b)                       # opaque -> "opcode"
        x = bh.asarray(np.arange(16.0))
        rev = x[::-1] * 2.0                        # -> "irregular_view"
        ok = x * 2.0 + 1.0
        np.testing.assert_array_equal(mm.numpy(), np.arange(12.0).reshape(
            3, 4) @ np.arange(12.0)[::-1].reshape(4, 3))
        np.testing.assert_array_equal(rev.numpy(), np.arange(16.0)[::-1] * 2)
        np.testing.assert_array_equal(ok.numpy(), np.arange(16.0) * 2 + 1)
        st = rt.executor.stats
        fb = st["triton_fallbacks"]
        assert fb["opcode"] >= 1 and fb["irregular_view"] >= 1
        assert st["triton_fallback_blocks"] == sum(fb.values())
        assert dict(st["backend_fallbacks"]["triton"]) == dict(fb)
        assert st["triton_blocks"] >= 1


def test_gpu_cost_model_runs_end_to_end():
    out = {}
    for cost_model in ("bohrium", "gpu"):
        with fresh_runtime(backend="triton", cost_model=cost_model,
                           device="cpu"):
            x = bh.random((300,))
            y = (bh.sin(x) * 0.3 - x * 0.01).sum()
            out[cost_model] = float(y)
    assert out["bohrium"] == pytest.approx(out["gpu"], rel=1e-12)


def test_module_api_routes_to_the_active_runtime():
    with fresh_runtime(device="cpu") as rt:
        assert bh.get_runtime() is rt
        z = bh.zeros((2, 3)) + bh.ones((2, 3))
        w = bh.where(z > 0.5, 2.0, 0.0)
        np.testing.assert_array_equal(w.numpy(), np.full((2, 3), 2.0))
        t = bh.take(bh.arange(5) * 2.0, bh.asarray(np.array([4.0, 0.0])))
        np.testing.assert_array_equal(t.numpy(), [8.0, 0.0])


def test_lowering_picks_the_first_claimant_in_preference_order():
    from types import SimpleNamespace

    from repro_torch.core.backends import LoweringContext, select_lowering
    from repro_torch.core.ir import BaseArray, Op, View
    n = 16
    a, b = BaseArray(n, np.dtype(np.float64)), BaseArray(n, np.dtype(np.float64))
    plan = SimpleNamespace(signature=None, op_indices=(0,))
    ctx = LoweringContext()
    fused = [Op("mul", View.contiguous(b, (n,)),
                (View.contiguous(a, (n,)), 2.0), new_bases=frozenset({b}))]
    reversed_read = [Op("copy", View.contiguous(b, (n,)),
                        (View(a, n - 1, (n,), (-1,)),),
                        new_bases=frozenset({b}))]
    d = select_lowering(fused, plan, ("triton", "torch"), ctx)
    assert (d.backend, d.declined) == ("triton", ())
    d = select_lowering(fused, plan, ("torch", "triton"), ctx)
    assert (d.backend, d.declined) == ("torch", ())
    d = select_lowering(reversed_read, plan, ("triton", "torch"), ctx)
    assert (d.backend, d.declined) == ("torch", (("triton", "irregular_view"),))
    with pytest.raises(RuntimeError, match="no backend claims"):
        select_lowering(reversed_read, plan, ("triton",), ctx)
