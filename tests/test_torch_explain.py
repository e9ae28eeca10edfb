"""The port's explain report (``repro_torch.core.obs.explain``) and its CLI
(``tools/explain_torch.py``) against the JAX package's, on the CPU.

On ``tools/explain.py``'s demo program under ``bohrium`` the port's merge
log (the pair, the action, the priced saving, the reason) and each block's
op indices equal the reference's, and each backend verdict matches by
counterpart: ``triton`` where ``pallas`` claims, ``torch`` where ``xla``
does.  The one allowed difference is C3's ``vmem`` slug (ROADMAP): the
Pallas kernel declines a block whose row exceeds its VMEM budget, which
the Triton kernel claims.  The report's cache key must be the key the
port's scheduler made, so ``resident`` is true after a flush.
"""

import json
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

from repro.core.lazy import fresh_runtime as ref_fresh_runtime
from repro.core.obs import explain as ref_explain

from repro_torch.core import lazy as bh
from repro_torch.core.lazy import fresh_runtime
from repro_torch.core.obs import ExplainReport, explain
from repro_torch.core.tuning import CalibratedFit, clear_fit, install_fit

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools import explain as ref_tool  # noqa: E402
from tools import explain_torch  # noqa: E402

CPU = "cpu"
COUNTERPART = {"pallas": "triton", "xla": "torch"}


@pytest.fixture(autouse=True)
def _no_leaked_fit():
    clear_fit()
    yield
    clear_fit()


def _port_report(**kw):
    kw.setdefault("algorithm", "greedy")
    kw.setdefault("backend", ("triton", "torch"))
    with fresh_runtime(device=CPU, **kw) as rt:
        explain_torch.demo_program(rt)
        rep = explain(rt)
        executed = dict(rt.history[-1]["exec"]["backend_blocks"])
        resident = rep.cache["resident"]
        key_entries = len(rt.cache)
    return rep, executed, resident, key_entries


def _ref_report(**kw):
    kw.setdefault("algorithm", "greedy")
    kw.setdefault("backend", ("pallas", "xla"))
    with ref_fresh_runtime(**kw) as rt:
        ref_tool.demo_program(rt)
        return ref_explain(rt)


def _merges(report):
    return [asdict(m) for m in report.merges]


# ---------------------------------------------------------------------------
# held against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ("greedy", "linear",
                                       "greedy_reference"))
def test_merges_and_blocks_equal_reference(algorithm):
    rep = _port_report(algorithm=algorithm, cost_model="bohrium")[0]
    ref = _ref_report(algorithm=algorithm, cost_model="bohrium")
    assert _merges(rep) == _merges(ref)
    assert rep.rejected_merges() and rep.taken_merges()
    assert (rep.n_ops, rep.n_blocks, rep.cost) == (ref.n_ops, ref.n_blocks,
                                                   ref.cost)
    assert [b.op_indices for b in rep.blocks] == \
        [b.op_indices for b in ref.blocks]
    for b, r in zip(rep.blocks, ref.blocks):
        assert (b.opcodes, b.n_ops, b.ext_bytes, b.n_inputs, b.n_outputs,
                b.n_contracted) == (r.opcodes, r.n_ops, r.ext_bytes,
                                    r.n_inputs, r.n_outputs, r.n_contracted)


def test_backend_verdicts_match_by_counterpart():
    rep = _port_report(cost_model="bohrium")[0]
    ref = _ref_report(cost_model="bohrium")
    for b, r in zip(rep.blocks, ref.blocks):
        assert (b.backend is None) == (r.backend is None)
        if r.backend is None:
            continue
        theirs = {COUNTERPART[v.backend]: v for v in r.verdicts}
        assert [v.backend for v in b.verdicts] == ["triton", "torch"]
        for v in b.verdicts:
            w = theirs[v.backend]
            if w.reason == "vmem":          # C3: the Triton kernel claims it
                assert v.claimed
                continue
            assert (v.claimed, v.reason, v.dispatches, v.price, v.winner) \
                == (w.claimed, w.reason, w.dispatches, w.price, w.winner)
        assert b.backend == COUNTERPART[r.backend]
    matmul = rep.blocks[-1]
    assert matmul.opcodes == ("matmul",)
    assert [(v.backend, v.reason) for v in matmul.verdicts] == \
        [("triton", "opcode"), ("torch", None)]


def test_ilp_report_equals_reference():
    rep = _port_report(cost_model="bohrium", partition_backend="ilp")[0]
    ref = _ref_report(cost_model="bohrium", partition_backend="ilp")
    assert rep.partition_backend == "ilp"
    for k in ("status", "objective", "bound", "gap", "greedy_cost",
              "nodes", "edges"):
        assert rep.solver[k] == ref.solver[k], k
    assert [b.op_indices for b in rep.blocks] == \
        [b.op_indices for b in ref.blocks]
    assert _merges(rep) == _merges(ref)      # the warm start's merges


# ---------------------------------------------------------------------------
# the report itself
# ---------------------------------------------------------------------------

def test_requires_a_flush():
    with fresh_runtime(algorithm="greedy", device=CPU) as rt:
        with pytest.raises(ValueError):
            explain(rt)


@pytest.mark.parametrize("cost_model", ("bohrium", "gpu", "calibrated"))
def test_cache_key_is_the_schedulers(cost_model):
    """``resident`` is true right after the flush: the report probes the
    cache with the scheduler's own key (one entry, the flush's)."""
    if cost_model == "calibrated":
        install_fit(CalibratedFit(launch_s={"torch": 2e-6,
                                            "triton": 6e-5}))
    _, _, resident, entries = _port_report(cost_model=cost_model)
    assert entries == 1
    assert resident is True


def test_a_new_fit_leaves_the_flush_not_resident():
    install_fit(CalibratedFit(launch_s={"torch": 2e-6, "triton": 6e-5}))
    with fresh_runtime(algorithm="greedy", cost_model="calibrated",
                       backend=("triton", "torch"), device=CPU) as rt:
        explain_torch.demo_program(rt)
        assert explain(rt).cache["resident"] is True
        install_fit(CalibratedFit(launch_s={"torch": 3e-6,
                                            "triton": 6e-5}))
        assert explain(rt).cache["resident"] is False


def test_replay_does_not_perturb_cache_counters():
    with fresh_runtime(algorithm="greedy", device=CPU) as rt:
        explain_torch.demo_program(rt)
        h0, m0 = rt.cache.hits, rt.cache.misses
        explain(rt)
        assert (rt.cache.hits, rt.cache.misses) == (h0, m0)


def test_json_and_text_render():
    rep = _port_report()[0]
    assert isinstance(rep, ExplainReport)
    doc = json.loads(rep.to_json())
    assert doc["schema"] == "repro_explain_v1"
    assert doc["merges"] and doc["blocks"]
    assert {m["action"] for m in doc["merges"]} == {"merged", "rejected"}
    text = rep.format_text()
    assert "rejected" in text and "merge cache" in text
    assert "declined (opcode)" in text


@pytest.mark.parametrize("backend", (("triton", "torch"), ("torch",)))
def test_winners_match_executed_backends(backend):
    rep, executed, _, _ = _port_report(backend=backend, cost_model="gpu")
    replayed: dict = {}
    for b in rep.blocks:
        if b.backend:
            assert sum(v.winner for v in b.verdicts) == 1
            replayed[b.backend] = replayed.get(b.backend, 0) + 1
    assert replayed == {k: v for k, v in executed.items() if v}


def test_calibrated_prices_in_the_report():
    """Under an installed fit the verdicts carry the fitted per-backend
    prices, and the winners are still what the executor ran."""
    install_fit(CalibratedFit(launch_s={"torch": 2e-6, "triton": 6e-5},
                              hbm_slope_s={"torch": 3.5e-12,
                                           "triton": 3.1e-12},
                              hbm_s_per_byte=3.1e-12))
    rep, executed, _, _ = _port_report(cost_model="calibrated")
    work = [b for b in rep.blocks if b.backend]
    for b in work:
        for v in b.verdicts:
            if v.claimed:
                slope = 3.5e-12 if v.backend == "torch" else 3.1e-12
                launch = 2e-6 if v.backend == "torch" else 6e-5
                assert v.price == launch * v.dispatches + slope * b.ext_bytes
    assert sum(1 for b in work if b.backend == "torch") == \
        executed.get("torch", 0)


def test_loop_events_in_report():
    with fresh_runtime(algorithm="greedy", loop_threshold=2, loop_unroll=8,
                       device=CPU) as rt:
        x = bh.asarray(np.linspace(0.0, 1.0, 32))
        bh.flush()
        for _ in range(5):
            y = x * 0.5 + 0.1
            x.delete()
            x = y
            bh.flush()
        float(x.sum().numpy())
        rep = explain(rt)
    kinds = {e["event"] for e in rep.loop}
    assert {"arm", "defer", "drain"} <= kinds


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_json_on_the_cpu(capsys):
    assert explain_torch.main(["--device", "cpu", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema"] == "repro_explain_v1"
    assert doc["backends"] == ["triton", "torch"]
    assert any(m["action"] == "rejected" and m["saving"] > 0
               for m in doc["merges"])
    assert doc["cache"]["resident"] is True


def test_cli_text_with_ilp_on_the_cpu(capsys):
    assert explain_torch.main(["--device", "cpu", "--partition-backend",
                               "ilp", "--cost-model", "gpu"]) == 0
    out = capsys.readouterr().out
    assert "partition backend: ilp" in out and "solver:" in out


def test_cli_runs_on_the_card_unless_told():
    args = explain_torch.parse([])
    assert args.device is None and args.backend == "triton,torch"
