"""The port's ILP/anytime partition backend (``partition_backend="ilp"``,
``repro_torch.core.partition_ilp``) against the JAX package's, on the CPU.

* Under the paper models priced in elements (``bohrium``,
  ``max_contract``) the same seed's tape gives, in both packages, the same
  solver status, objective, bound, node and edge counts and block lists —
  the prices are the same numbers, so the search is the same search;
* under ``gpu`` the ILP equals the port's classic ``optimal`` wherever
  that is proved optimal, and is never worse than greedy over seeds and
  budgets, ``time_budget_s=0`` included;
* the acyclicity and fuse-forbidden constraints of the reference's
  ``tests/test_partition_ilp.py``;
* the backend is a distinct merge-cache identity, and an ILP-planned run
  is bitwise the greedy-planned and the unfused runs.
"""

import numpy as np
import pytest

from repro.core import partition as ref_partition
from repro.testing.tapegen import TapeProgram as RefTapeProgram

from repro_torch.core import lazy as bh
from repro_torch.core import partition
from repro_torch.core.cache import tape_signature
from repro_torch.core.ir import BaseArray, Op, View
from repro_torch.core.lazy import fresh_runtime
from repro_torch.testing.tapegen import TapeProgram
from test_torch_planning import to_port

CPU = "cpu"
ILP_STATS = ("ilp_status", "ilp_objective", "ilp_bound", "ilp_gap",
             "ilp_nodes", "ilp_edges", "greedy_cost")


def _tiny_tape(seed, n_actions=8):
    return TapeProgram(seed, n_actions=n_actions).record()


# ---------------------------------------------------------------------------
# the same search in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("model", ("bohrium", "max_contract"))
def test_ilp_equals_reference(seed, model):
    ref_tape = RefTapeProgram(seed, n_actions=8).record()
    tape = to_port(ref_tape)
    got = partition(tape, cost_model=model, partition_backend="ilp")
    want = ref_partition(ref_tape, cost_model=model,
                         partition_backend="ilp")
    for k in ILP_STATS:
        assert got.stats[k] == want.stats[k], k
    assert got.op_blocks() == want.op_blocks()
    assert got.cost == want.cost


@pytest.mark.parametrize("seed", range(6))
def test_port_recorded_tape_gives_the_reference_plan(seed):
    """The port's own ``TapeProgram`` records the tape the reference
    records (``tests/test_torch_tapegen.py``): its ILP plan is the
    reference's too."""
    got = partition(_tiny_tape(seed), cost_model="bohrium",
                    partition_backend="ilp")
    want = ref_partition(RefTapeProgram(seed, n_actions=8).record(),
                         cost_model="bohrium", partition_backend="ilp")
    assert got.stats["ilp_status"] == want.stats["ilp_status"]
    assert got.stats["ilp_objective"] == want.stats["ilp_objective"]
    assert got.op_blocks() == want.op_blocks()


# ---------------------------------------------------------------------------
# optimality & the never-worse-than-greedy warm start
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("model", ("gpu", "bohrium"))
def test_ilp_matches_classic_optimal(seed, model):
    # the dense gpu model's search exhausts 2000 nodes on half the seeds,
    # in about a second each; the same budget on both solvers
    tape = _tiny_tape(seed)
    r_opt = partition(tape, algorithm="optimal", cost_model=model,
                      node_budget=2000)
    r_ilp = partition(tape, cost_model=model, partition_backend="ilp",
                      node_budget=2000)
    if not r_opt.stats.get("proved_optimal", True):
        # search space too big for the node budget in BOTH solvers: only
        # the anytime contract is comparable here
        assert r_ilp.cost <= r_opt.cost + 1e-9 \
            or r_ilp.stats["ilp_status"] != "optimal"
        return
    assert r_ilp.stats["ilp_status"] == "optimal"
    assert r_ilp.cost == pytest.approx(r_opt.cost, rel=1e-12, abs=1e-12)
    assert r_ilp.stats["ilp_bound"] == pytest.approx(r_ilp.cost, rel=1e-12,
                                                     abs=1e-12)
    assert r_ilp.stats["ilp_gap"] == pytest.approx(0.0, abs=1e-12)


@pytest.mark.parametrize("budget", (None, 0.0, 0.05))
@pytest.mark.parametrize("seed", (11, 222, 3333, 4444))
def test_ilp_never_worse_than_greedy(seed, budget):
    """The anytime contract over seeds and budgets: greedy is the
    incumbent, so any cutoff — of the wall clock or, with no time budget,
    of 500 nodes — still returns a plan at most as costly."""
    tape = TapeProgram(seed, n_actions=14).record()
    r_g = partition(tape, algorithm="greedy", cost_model="gpu")
    r_i = partition(tape, cost_model="gpu", partition_backend="ilp",
                    time_budget_s=budget, node_budget=500)
    assert r_i.cost <= r_g.cost + 1e-12
    assert r_i.stats["greedy_cost"] == r_g.cost
    assert r_i.stats["ilp_bound"] <= r_i.cost + 1e-12
    assert r_i.state.is_legal()


# ---------------------------------------------------------------------------
# anytime cutoff behavior
# ---------------------------------------------------------------------------

def test_zero_time_budget_is_feasible_and_honest():
    tape = TapeProgram(3, n_actions=24).record()
    r = partition(tape, cost_model="gpu", partition_backend="ilp",
                  time_budget_s=0.0)
    g = partition(tape, algorithm="greedy", cost_model="gpu")
    assert r.stats["ilp_status"] in ("anytime", "budget-hit")
    assert r.stats["ilp_nodes"] == 0
    assert r.cost <= g.cost + 1e-12
    assert r.stats["ilp_gap"] >= 0.0
    assert r.stats["ilp_bound"] <= r.cost + 1e-12
    assert r.stats["ilp_wall_s"] >= 0.0


def test_node_budget_cutoff():
    tape = TapeProgram(5, n_actions=24).record()
    r = partition(tape, cost_model="gpu", partition_backend="ilp",
                  node_budget=1)
    assert r.stats["ilp_nodes"] <= 1
    assert r.stats["ilp_status"] in ("anytime", "budget-hit")
    g = partition(tape, algorithm="greedy", cost_model="gpu")
    assert r.cost <= g.cost + 1e-12


# ---------------------------------------------------------------------------
# constraint encoding (the reference's tests/test_partition_ilp.py cases)
# ---------------------------------------------------------------------------

def _cycle_trap_tape():
    """Three ops A→B→C where the ONLY weight edge is (A, C) — sharing the
    whole-array read of ``a`` — but contracting it strands B (domain
    (32,) ≠ (64,), fuse-forbidden with both) inside a dependency cycle
    A*→B→A*.  No legal merge exists; the optimum is three singletons."""
    a = BaseArray(64, np.dtype(np.float64))
    x = BaseArray(64, np.dtype(np.float64))
    y = BaseArray(32, np.dtype(np.float64))
    z = BaseArray(64, np.dtype(np.float64))
    av = View.contiguous(a, (64,))
    return [
        Op("mul", View.contiguous(x, (64,)), (av, 2.0),
           new_bases=frozenset({x})),
        Op("add", View.contiguous(y, (32,)), (View(x, 0, (32,), (1,)), 1.0),
           new_bases=frozenset({y})),
        Op("add", View.contiguous(z, (64,)),
           (av, View(y, 0, (64,), (0,))), new_bases=frozenset({z})),
    ]


@pytest.mark.parametrize("model", ("bohrium", "gpu"))
def test_acyclicity_rejects_the_only_weight_edge(model):
    tape = _cycle_trap_tape()
    r = partition(tape, cost_model=model, partition_backend="ilp")
    assert r.n_blocks == len(tape), "ilp merged across a dependency cycle"
    assert r.stats["ilp_status"] == "optimal"
    g = partition(tape, algorithm="greedy", cost_model=model)
    assert r.cost == g.cost


@pytest.mark.parametrize("seed", (1, 6, 7, 11))
def test_fuse_forbidden_keeps_a_matmul_alone(seed):
    """A matmul is fuse-forbidden with everything: the ILP never puts it
    in a shared block, and the tape still solves."""
    tape = TapeProgram(seed, n_actions=30).record()
    assert any(op.opcode == "matmul" for op in tape)
    r = partition(tape, cost_model="bohrium", partition_backend="ilp",
                  time_budget_s=2.0)
    assert r.state.is_legal()
    for blk in r.op_blocks():
        ops = [tape[i] for i in blk]
        if any(o.opcode == "matmul" for o in ops):
            assert sum(1 for o in ops if not o.is_system()) == 1


# ---------------------------------------------------------------------------
# runtime integration: cache identity, bitwise runs
# ---------------------------------------------------------------------------

def test_backend_is_part_of_the_cache_key():
    tape = _tiny_tape(1)
    kg = tape_signature(tape, "greedy", "gpu")
    ki = tape_signature(tape, "greedy", "gpu", partition_backend="ilp")
    assert kg != ki
    assert kg[:-1] == ki[:-1]
    assert (kg[-1], ki[-1]) == ("greedy", "ilp")


def test_greedy_and_ilp_plans_never_collide_in_the_merge_cache():
    """One runtime, the same tape structure planned by greedy then by the
    ILP: the ILP flush misses the cache and plans anew, and each backend
    then hits its own entry."""
    def step():
        x = bh.asarray(np.arange(256.0))
        y = bh.sin(x) * 0.5 + x * 0.25
        return float((y * y).sum().numpy())

    with fresh_runtime(algorithm="greedy", cost_model="gpu",
                       backend="triton", device=CPU,
                       loop_fusion=False) as rt:
        step()            # first tape lacks the previous step's DELs
        step()
        step()
        assert rt.history[-1]["cached"]
        rt.partition_backend = "ilp"
        rt.time_budget_s = 1.0
        got = step()
        assert not rt.history[-1]["cached"]
        assert rt.history[-1]["ilp_status"] in ("optimal", "anytime",
                                                "budget-hit")
        assert step() == got and rt.history[-1]["cached"]
        rt.partition_backend = "greedy"
        assert step() == got and rt.history[-1]["cached"]
        assert len(rt.cache) == 3      # first tape, greedy and ilp steady


@pytest.mark.parametrize("seed", (17, 3, 8))
def test_ilp_planned_run_is_bitwise(seed):
    prog = TapeProgram(seed, n_actions=20)
    ref = prog.run(device=CPU, algorithm="singleton", backend="torch")
    greedy = prog.run(device=CPU, algorithm="greedy", backend="triton",
                      cost_model="gpu")
    got = prog.run(device=CPU, algorithm="greedy", backend="triton",
                   cost_model="gpu", partition_backend="ilp",
                   time_budget_s=1.0)
    for want in (ref, greedy):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_gather_tape_ilp_planned_triton_vs_floor_bitwise():
    tbl = np.arange(128, dtype=np.float64) * 0.5
    ii = np.asarray([0, 3, 7, 11, 127, 64, 2, 9] * 8, dtype=np.float64)
    outs, stats = {}, {}
    for label, kw in (
            ("ref", dict(algorithm="singleton", backend="torch")),
            ("ilp", dict(algorithm="greedy", backend="triton",
                         cost_model="gpu", partition_backend="ilp"))):
        with fresh_runtime(device=CPU, **kw) as rt:
            t = bh.asarray(tbl)
            idx = bh.asarray(ii)
            g = bh.take(t, idx)
            o = bh.floor(g * 2.0) + 1.0
            outs[label] = o.numpy()
            stats[label] = rt.executor.stats.snapshot()
    np.testing.assert_array_equal(outs["ref"], outs["ilp"])
    assert stats["ilp"]["backend_blocks"].get("triton", 0) >= 1
