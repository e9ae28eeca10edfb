"""Sharded execution in the port (``core/dist`` on ``torch.distributed``,
the ``shard_map`` backend, ``Runtime(mesh=)``), held against the port's
single-device runs and the JAX package's 4-device mesh.

Four gloo ranks are spawned on the CPU (``testing.mesh.spawn``: a
``FileStore`` in a temporary directory, one thread a rank), once with the
torch floor and once with the triton stack (its kernels' plain versions
on the CPU).  Each rank runs ``tests/test_dist_fusion.py``'s window,
aligned and reduction programs and three benchmark programs under
``comm`` with ``greedy`` and ``singleton``, and ``check_dist`` on tapegen
seeds 0-7.  The reference runs the same programs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (as
``tests/test_dist_fusion.py`` does).  Results are held bitwise (the
aligned program's ``exp`` within one ulp of XLA's, the benchmark programs
within the reference's program tolerance, rtol = atol = 1e-9); the
collective and fabric-byte counts exactly.  A world of one is also set up
in this process, over gloo, and torn down at the end of the module.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro_torch.core import dist
from repro_torch.core import lazy as bh
from repro_torch.core.backends import get_backend
from repro_torch.core.dist import (DistBlockExecutor, ShardSpec, host_mesh,
                                   topology_key)
from repro_torch.core.executor import BlockExecutor
from repro_torch.core.ir import BaseArray, Op, View
from repro_torch.core.lazy import fresh_runtime
from repro_torch.testing import mesh as tmesh

ROOT = Path(__file__).resolve().parents[1]
N = 4
SEEDS = range(8)
BENCH = {"black_scholes": (2, 512), "game_of_life": (2, 32),
         "heat_equation": (2, 32)}
PROGS = ("window", "aligned", "reduction")


@pytest.fixture(scope="module")
def ranks():
    """backend -> each rank's suite result (two spawns of 4 ranks)."""
    return {
        "torch": tmesh.spawn(tmesh.mesh_suite, N, device="cpu",
                             backend="torch", seeds=SEEDS, benchmarks=BENCH),
        "triton": tmesh.spawn(tmesh.mesh_suite, N, device="cpu",
                              backend="triton", benchmarks=BENCH),
    }


REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    from repro.core import dist
    from repro.core import lazy as bh
    from repro.core.dist import host_mesh
    from repro.core.lazy import fresh_runtime
    from repro.testing.tapegen import TapeProgram
    from benchmarks.programs import BENCHMARKS
    from repro_torch.testing.mesh import PROGRAMS
    bench, seeds, out = eval(sys.argv[1]), eval(sys.argv[2]), sys.argv[3]
    mesh = host_mesh(4)
    res = {"runs": {}, "seeds": {}}
    todo = {k: (lambda f=f: f(bh, dist, 4)) for k, f in PROGRAMS.items()}
    for k, args in bench.items():
        todo[k] = lambda f=BENCHMARKS[k], a=args: f(*a).numpy()
    for k, fn in todo.items():
        res["runs"][k] = {}
        for alg in ("greedy", "singleton"):
            with fresh_runtime(cost_model="comm", algorithm=alg,
                               mesh=mesh, loop_fusion=False) as rt:
                got = np.asarray(fn())
                st = rt.executor.stats
                res["runs"][k][alg] = {
                    "out": got, "collectives": st["collectives"],
                    "interconnect_bytes": st["interconnect_bytes"],
                    "shard_map_blocks": st["shard_map_blocks"]}
    for s in seeds:
        res["seeds"][s] = TapeProgram(s, sharded=True, n_shards=4).run(
            algorithm="greedy", cost_model="comm", backend="xla", mesh=mesh)
    with open(out, "wb") as f:
        pickle.dump(res, f)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", REFERENCE, repr(BENCH),
                          repr(list(SEEDS)), str(out)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def world_of_one():
    """A mesh over a world of one in this process (gloo, in-memory store)."""
    started = not tdist.is_initialized()
    mesh = host_mesh(device="cpu")
    yield mesh
    if started:
        tdist.destroy_process_group()


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.tobytes()


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "triton"])
def test_ranks_agree_and_match_single_device(ranks, backend):
    """Every rank materializes the same arrays, each mesh run bitwise the
    mesh-less run (the suite raises otherwise)."""
    lead = ranks[backend][0]
    for other in ranks[backend][1:]:
        for name, modes in lead["runs"].items():
            for mode, run in modes.items():
                assert _bits(run["out"]) == \
                    _bits(other["runs"][name][mode]["out"])
    for name, modes in lead["runs"].items():
        for mode in ("greedy", "singleton"):
            assert _bits(modes[mode]["out"]) == _bits(modes["single"]["out"])


@pytest.mark.parametrize("algorithm", ["greedy", "singleton"])
@pytest.mark.parametrize("backend", ["torch", "triton"])
@pytest.mark.parametrize("name", PROGS + tuple(BENCH))
def test_mesh_run_matches_reference(ranks, reference, name, backend,
                                    algorithm):
    got = ranks[backend][0]["runs"][name][algorithm]
    want = reference["runs"][name][algorithm]
    if name in BENCH:
        np.testing.assert_allclose(got["out"], want["out"], rtol=1e-9,
                                   atol=1e-9)
    elif name == "aligned":                  # exp: libm against XLA's
        np.testing.assert_array_max_ulp(got["out"], want["out"], maxulp=1)
    else:
        assert _bits(got["out"]) == _bits(want["out"])
    for key in ("collectives", "interconnect_bytes", "shard_map_blocks"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("backend", ["torch", "triton"])
def test_fusion_elides_collectives_on_ranks(ranks, backend):
    win = ranks[backend][0]["runs"]["window"]
    fused, unfused = win["greedy"], win["singleton"]
    assert fused["shard_map_blocks"] > 0
    assert 0 < fused["interconnect_bytes"] < unfused["interconnect_bytes"]
    assert fused["collectives"] < unfused["collectives"]
    assert (fused["collectives"], unfused["collectives"]) == (1, 3)
    assert unfused["interconnect_bytes"] == 3 * (N - 1) * 64 * 8
    stack = win["greedy"]["backend_blocks"]
    assert set(stack) == ({"shard_map", "torch"} if backend == "torch"
                          else {"shard_map", "triton", "torch"})


@pytest.mark.parametrize("seed", SEEDS)
def test_check_dist_matches_reference(ranks, reference, seed):
    got = ranks["torch"][0]["seeds"][seed]
    want = reference["seeds"][seed]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits(g) == _bits(w)


# ---------------------------------------------------------------------------
# A world of one, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PROGS + tuple(BENCH))
def test_world_of_one_is_bitwise_no_mesh(world_of_one, name):
    from repro_torch.testing.programs import BENCHMARKS
    if name in BENCH:
        fn = lambda: BENCHMARKS[name](*BENCH[name]).numpy()  # noqa: E731
    else:
        fn = lambda: tmesh.PROGRAMS[name](bh, dist, 1)      # noqa: E731
    runs = [tmesh.run_once(fn, "cpu", False, backend=backend,
                           cost_model="comm", **kw)
            for backend in ("torch", "triton")
            for kw in ({"mesh": world_of_one}, {})]
    for run in runs[1:]:
        assert _bits(run["out"]) == _bits(runs[0]["out"])
    assert runs[0]["shard_map_blocks"] == runs[0]["collectives"] == 0


def test_world_of_one_plans_are_not_shared(world_of_one, tmp_path):
    """A plan made under the mesh is stored under its topology: a mesh-less
    runtime over the same plan store misses it, another mesh runtime hits
    it."""
    assert topology_key(world_of_one) == (("dev", 1), "cpu")

    def run(**kw):
        with fresh_runtime(device="cpu", cost_model="comm",
                           plan_store=str(tmp_path), loop_fusion=False,
                           **kw) as rt:
            tmesh.window(bh, dist, 1)
            reg = rt.executor.metrics
            return (reg.counter("cache.plan_store.hit").get(),
                    reg.counter("cache.plan_store.write").get(),
                    rt.executor.topology_key())
    hits, writes, topo = run(mesh=world_of_one)
    assert hits == 0 and writes > 0 and topo == (("dev", 1), "cpu")
    hits, writes, topo = run()
    assert hits == 0 and writes > 0 and topo == ()
    hits, _, _ = run(mesh=world_of_one)
    assert hits > 0


def test_world_of_one_stack_and_stats(world_of_one):
    ex = BlockExecutor(device="cpu", backend="triton", mesh=world_of_one)
    assert ex.backends == ("shard_map", "triton", "torch")
    assert ex.n_dev == 1 and ex.axis == "dev"
    st = ex.stats.snapshot()
    assert st["shard_map_blocks"] == st["collectives"] == 0
    assert st["interconnect_bytes"] == 0.0
    plain = BlockExecutor(device="cpu", backend="triton")
    assert plain.backends == ("triton", "torch")
    assert "collectives" not in plain.stats.snapshot()
    assert DistBlockExecutor(device="cpu").mesh is not None


def test_executor_refuses_a_mesh_of_another_device():
    fake = SimpleNamespace(device_type="cuda", mesh_dim_names=("dev",),
                           size=lambda: 1)
    with pytest.raises(ValueError, match="cuda mesh"):
        BlockExecutor(device="cpu", mesh=fake)


def test_host_mesh_refuses_more_ranks_than_the_world(world_of_one):
    with pytest.raises(ValueError, match="the world has 1"):
        host_mesh(2, device="cpu")
    assert dist.world_size() == 1


def test_shard_map_claims_and_cache_token(world_of_one):
    """The backend declines what it cannot run with the reference's slugs,
    and its executable-cache token changes with placement."""
    ex = BlockExecutor(device="cpu", mesh=world_of_one)
    ctx = ex.lowering_context()
    be = get_backend("shard_map")
    b = BaseArray(8, np.dtype(np.float64))
    o = BaseArray(8, np.dtype(np.float64))
    ops = [Op("mul", View.contiguous(o, (8,)), (View.contiguous(b, (8,)), 2.0),
              new_bases=frozenset({o}))]
    assert be.claims(ops, None, ctx) == "placement"      # all replicated
    t1 = be.cache_token(ops, None, ctx)
    b.shard_spec = ShardSpec.for_dim((8,), 0, "dev", 4)
    assert be.claims(ops, None, ctx) == "placement"      # 4 shards, 1 rank
    assert be.cache_token(ops, None, ctx) != t1
    b.shard_spec = ShardSpec.for_dim((8,), 0, "dev", 1)
    assert be.claims(ops, None, BlockExecutor(
        device="cpu").lowering_context()) == "no_mesh"
    shifted = [Op("mul", View.contiguous(o, (7,)), (View(b, 1, (7,), (1,)),
                                                    2.0))]
    b.shard_spec = ShardSpec.for_dim((8,), 0, "dev", 1)
    assert be.claims(shifted, None, ctx) == "irregular_view"
    red = [Op("reduce_sum", View.contiguous(o, ()),
              (View.contiguous(b, (8,)),), axis=None)]
    assert be.claims(red, None, ctx) == "opcode"
    assert be.claims([], None, ctx) == "system_only"


def test_mesh_turns_loop_fusion_off(world_of_one):
    with fresh_runtime(device="cpu", mesh=world_of_one, loop_threshold=2,
                       cost_model="comm") as rt:
        x = bh.asarray(np.arange(64.0))
        for _ in range(6):
            x = x * 0.5 + 1.0
            bh.flush()
        x.numpy()
        assert not any(h.get("loop_deferred") for h in rt.history)
        assert any(e.get("reason") == "mesh-active"
                   for e in rt._loop.events)


def test_sharded_requests_run_solo(world_of_one):
    """A tape with placement annotations never joins a batch."""
    from repro_torch.core.lazy import Runtime
    from repro_torch.core.serve import Server
    srv = Server(Runtime(device="cpu", mesh=world_of_one, loop_fusion=False,
                         cost_model="comm"), window_s=0.05)
    data = np.arange(64.0)

    def fn():
        x = bh.asarray(data)
        dist.shard(x, n=4)
        return x[1:] * 2.0 + x[:-1]
    got = [srv.submit(t, fn) for t in ("a", "b")]
    for g in got:
        np.testing.assert_array_equal(g, data[1:] * 2.0 + data[:-1])
    assert srv.metrics.counter("serve.singles").get() == 2
    assert srv.metrics.counter("serve.batched_requests").get() == 0


def test_partition_spec_placements_and_shard_tree(world_of_one):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed import PartitionSpec, shard_tree
    assert PartitionSpec(None, "dev").placements(world_of_one) == [Shard(1)]
    assert PartitionSpec().placements(world_of_one) == [Replicate()]
    tree = {"w": torch.arange(12.0).reshape(3, 4), "b": {"g": torch.ones(4)}}
    out = shard_tree(tree, {"w": PartitionSpec("dev"),
                            "b": {"g": PartitionSpec()}}, world_of_one)
    assert torch.equal(out["w"].full_tensor(), tree["w"])
    assert torch.equal(out["b"]["g"].full_tensor(), tree["b"]["g"])


def test_profiler_records_no_fabric_off_nccl(world_of_one):
    from repro_torch.core.tuning.profile import fabric_measured
    assert not fabric_measured(world_of_one)
    assert not fabric_measured(None)
