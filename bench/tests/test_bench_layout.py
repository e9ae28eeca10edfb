"""The harness finds a cell's files by name: a throwaway configuration,
traffic mix, limits file and metric in a temporary directory run with no
edit to the benchmark's code; and every name in ``BENCHMARK.json`` has its
files."""

import json
import re
import time
from pathlib import Path

import pytest
import torch

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _run(root, cell, traced, seed=7):
    lay = harness.Layout(root)
    return harness.run_cell(lay, cell, seed, 0.0, traced,
                            torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny-olmoe.tiny", "tiny-jamba.tiny"])
def test_throwaway_cell_runs_with_no_edit(tiny_root, cell):
    plain = _run(tiny_root, cell, False)
    assert set(plain["metrics"]) == {"output_tokens_per_s", "setup_s"}
    traced = _run(tiny_root, cell, True)
    # the traced run reads the throwaway metric; two batches at the least
    assert traced["metrics"]["tiny_requests"]["value"] == 4.0
    for r in (plain, traced):
        assert list(r)[-1] == "checks"
        assert r["checks"]["captures_in_window"]["value"] == 0
        assert r["attempted"] >= 2 and r["failed"] == 0


def test_same_seed_same_traffic(tiny_root32):
    a = _run(tiny_root32, "tiny-olmoe.tiny", False, seed=2 ** 31 + 5)
    b = _run(tiny_root32, "tiny-olmoe.tiny", False, seed=2 ** 31 + 5)
    assert a["checks"] == b["checks"]


def test_every_name_has_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    lay = harness.Layout(ROOT)
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert (lay.bench / "reference" / f"{c['name']}.py").is_file()
        assert (lay.bench / "work" / f"{c['name']}.py").is_file()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        lay.traffic(w["traffic"])
        check = lay.check(w["name"])
        assert check["block"] >= 1
        assert set(check["limits"]) == {"logit_rms_worst_block",
                                        "excess_gap"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"])
        assert (lay.bench / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            lay.cell(w)
