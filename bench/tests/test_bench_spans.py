"""The readers of the program's own spans and counters (``bench/spans.py``)
on a synthetic run, and the traced batch itself at the SMOKE sizes on the
CPU: it leaves no tracer behind, counts every decode token's pairs kept,
and an untraced run installs no tracer at all."""

import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench import harness, spans
from bench.tests.tiny import TRAFFIC

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["tiny-olmoe.tiny", "tiny-jamba.tiny"]


def _read(name, run):
    return harness.Layout(ROOT).module("metrics", name).read(run)


def _step(attn, moe, mamba=0.0):
    return {"dev_ms": attn + moe + mamba + 0.1, "spans": [
        ("model.embed", {}, 0.0, 0.05),
        ("layer.attn", {"layer": 0}, 0.05, attn / 2),
        ("layer.attn_local", {"layer": 1}, 0.1, attn / 2),
        ("layer.moe", {"layer": 0}, 0.2, moe),
        ("layer.mamba", {"layer": 2}, 0.3, mamba),
        ("model.head", {}, 0.4, 0.05)]}


def _run(on_card=True):
    rec = {"on_card": on_card,
           "prefill": _step(30.0, 50.0),
           "decode": [_step(2.0, 1.0, 0.5), _step(4.0, 3.0, 0.5),
                      _step(3.0, 9.0, 0.5)],
           "counters": {"prefill": {"moe.pairs_kept": 150, "moe.slots": 200},
                        "decode": {"moe.pairs_kept": 8, "moe.slots": 64},
                        "host": {}}}
    run = SimpleNamespace()
    setattr(run, spans.ATTR, rec)
    return run


def test_layer_readers_sum_a_step_and_take_the_median():
    run = _run()
    assert _read("attention_ms.decode", run) == pytest.approx(3.0)
    assert _read("moe_ms.decode", run) == pytest.approx(3.0)
    assert _read("mamba_ms.decode", run) == pytest.approx(0.5)
    assert _read("attention_ms.prefill", run) == pytest.approx(30.0)
    assert _read("moe_ms.prefill", run) == pytest.approx(50.0)


def test_slot_fill_readers():
    run = _run()
    assert _read("moe_slot_fill.decode", run) == pytest.approx(12.5)
    assert _read("moe_slot_fill.prefill", run) == pytest.approx(75.0)


def test_readers_return_none_without_their_numbers():
    off = _run(on_card=False)            # host times: no device metric
    assert _read("attention_ms.decode", off) is None
    assert _read("moe_slot_fill.decode", off) == pytest.approx(12.5)
    none = SimpleNamespace()
    setattr(none, spans.ATTR, None)      # a program without device spans
    for name in ("attention_ms.decode", "moe_ms.prefill",
                 "moe_slot_fill.decode", "mamba_ms.decode"):
        assert _read(name, none) is None
    dense = _run()
    getattr(dense, spans.ATTR)["counters"]["decode"] = {}
    assert _read("moe_slot_fill.decode", dense) is None


@pytest.mark.parametrize("cell", CELLS)
def test_traced_batch_on_the_cpu(tiny_root, cell):
    from repro_torch.core.obs import trace
    lay = harness.Layout(tiny_root)
    served = harness.setup(lay, cell, 7, torch.device("cpu"))
    run = harness.window(served, 0.0, False, None, 0.0)
    harness.output_check(lay, run)       # frees the window's steps
    rec = spans.recorded(run)
    assert trace.active() is None
    assert spans.recorded(run) is rec    # made once
    steps = TRAFFIC["new_tokens"] - 1
    assert len(rec["decode"]) == steps
    kinds = served.cfg.layer_pattern()
    want = sorted((f"layer.{k}", i) for i, pair in enumerate(kinds)
                  for k in pair)
    for s in rec["decode"] + [rec["prefill"]]:
        assert sorted((n, a["layer"]) for n, a, _, _ in s["spans"]
                      if n.startswith("layer.")) == want
    moe = sum(f == "moe" for _, f in kinds)
    dec = rec["counters"]["decode"]
    b, k = TRAFFIC["batch"], served.cfg.moe.top_k
    assert dec["moe.calls"] == moe * steps
    assert dec["moe.pairs_kept"] == dec["moe.pairs_chosen"] == \
        moe * steps * b * k


def test_untraced_run_installs_no_tracer(tiny_root, monkeypatch):
    from repro_torch.core.obs import trace

    def refuse(*a, **k):
        raise AssertionError("a tracer was installed in an untraced run")

    monkeypatch.setattr(trace, "enable", refuse)
    r = harness.run_cell(harness.Layout(tiny_root), CELLS[0], 5, 0.0, False,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"] and trace.active() is None
