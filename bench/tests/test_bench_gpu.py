"""On the card: one batch of each cell through the timed steps at its own
size, with its output check.  Skipped without a CUDA device; run on the
card with ``PYTHONPATH=src python -m pytest -q -m gpu
bench/tests/test_bench_gpu.py``."""

import json
import time
from pathlib import Path

import pytest

from bench import harness

pytestmark = pytest.mark.gpu
ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cuda, cell):
    r = harness.run_cell(harness.Layout(ROOT), cell, 12345, 0.0, False,
                         cuda, time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
