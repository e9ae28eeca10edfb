"""The device-time readers on a synthetic run: the idle share takes the
busy seconds of the traced steps over the same steps' device time outside
the profiler, and the decode readers leave the profiled batch out."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import harness
from bench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]


def _read(name, run):
    return harness.Layout(ROOT).module("metrics", name).read(run)


def _run():
    # two traced decode steps of 10 ms, each busy 8 ms in two kernels
    trace = Trace(kernels=[("a", 0.000, 0.005), ("b", 0.007, 0.010),
                           ("a", 0.020, 0.023), ("b", 0.025, 0.030)],
                  spans=[("bench.decode", 0.0, 0.010),
                         ("bench.decode", 0.020, 0.030)])
    batches = [{"decode_dev": [0.009, 0.009, 0.020], "gaps_dev": [1e-4, 3e-4]},
               {"decode_dev": [0.010, 0.010, 0.010], "gaps_dev": [5e-3, 5e-3],
                "profiled": True}]
    return SimpleNamespace(trace=trace, batches=batches)


def test_idle_share_reads_the_steps_outside_the_profiler():
    # busy 8 ms a traced step against 9 ms for steps 0 and 1 unprofiled
    assert _read("idle_share.decode", _run()) == pytest.approx(
        100 * (1 - 0.008 / 0.009))


def test_decode_readers_leave_the_profiled_batch_out():
    run = _run()
    assert _read("host_gap_ms.decode", run) == pytest.approx(0.2)
    assert _read("decode_step_ms", run) == pytest.approx(9.0)


def test_idle_share_needs_a_trace():
    run = _run()
    run.trace = None
    assert _read("idle_share.decode", run) is None
