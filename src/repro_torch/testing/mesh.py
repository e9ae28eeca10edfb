"""Programs and a rank launcher for the mesh (``core/dist``): the
reference's distributed test programs, a suite one rank of a process group
runs, and :func:`spawn`, which starts the ranks over gloo.

The three programs are ``tests/test_dist_fusion.py``'s, sized by
``size``: ``window`` (three shifted windows of a sharded vector: one
allgather a read site, one collective once fused), ``aligned`` (an
elementwise chain over a sharded vector: shard-local, no collective) and
``reduction`` (a sum over the sharded axis: one allgather).  Each takes
the lazy module and the dist module it runs on (``bh``, ``dist``), so the
same body records the same tape in either package.

:func:`mesh_suite` runs on every rank (SPMD): each program under
``cost_model="comm"`` with ``greedy`` and ``singleton`` on a mesh of every
rank and once without a mesh, the benchmark programs it is given the same
way, and :func:`~repro_torch.testing.tapegen.check_dist` on tapegen seeds;
it returns the results, each run's executor stats and its warm wall.

:func:`spawn` starts ``n`` ranks of a job over gloo with a ``FileStore``
in a temporary directory (no network), each with one CPU thread; a rank
that raises fails the call.  On the card every rank uses device 0, so
gloo stages each collective through host memory (``dist.mesh.all_gather``):
a functional check of the multi-rank path, not a fabric measurement.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np


def window(bh, dist, n: int, size: Optional[int] = None):
    size = size or 64
    x = bh.asarray(np.arange(size, dtype=np.float64))
    dist.shard(x, n=n)
    w = size - 4
    zs = [x[i:w + i] * float(i + 1) for i in range(3)]
    return (zs[0] + zs[1] + zs[2]).numpy()


def aligned(bh, dist, n: int, size: Optional[int] = None):
    x = bh.asarray(np.linspace(0.0, 2.0, size or 8 * n))
    dist.shard(x, n=n)
    y = bh.exp(x) * 0.5 + bh.sqrt(x + 1.0)
    return y.numpy()


def reduction(bh, dist, n: int, size: Optional[int] = None):
    x = bh.asarray(np.arange(float(size or 32 * n)))
    dist.shard(x, n=n)
    return np.asarray((x * x).sum().numpy())


PROGRAMS: Dict[str, Callable] = {"window": window, "aligned": aligned,
                                 "reduction": reduction}

#: the executor stats the suite keeps from each run
STATS = ("shard_map_blocks", "collectives", "interconnect_bytes",
         "blocks_run")


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_once(fn, device, warm: bool, **runtime_kw) -> dict:
    """One program in a fresh runtime: the result and the executor stats of
    one run; with ``warm``, of a second run in the same runtime, with its
    wall."""
    from ..core.executor import stats_delta
    from ..core.lazy import fresh_runtime
    with fresh_runtime(device=device, loop_fusion=False,
                       **runtime_kw) as rt:
        before = rt.executor.snapshot_stats()
        out = fn()
        wall = None
        if warm:
            _sync(device)
            before = rt.executor.snapshot_stats()
            t0 = time.perf_counter()
            out = fn()
            _sync(device)
            wall = time.perf_counter() - t0
        st = stats_delta(before, rt.executor.stats)
    return {"out": np.asarray(out), "wall_s": wall,
            "backend_blocks": dict(st["backend_blocks"]),
            **{k: st.get(k, 0) for k in STATS}}


def mesh_suite(size: Optional[int] = None, device="cpu", backend="torch",
               seeds: Sequence[int] = (), seed_size: int = 64,
               benchmarks: Optional[Dict[str, tuple]] = None,
               keep_outputs: bool = True, warm: bool = False) -> dict:
    """Every rank of the process group runs this (SPMD).  For each program
    of :data:`PROGRAMS` (and each ``benchmarks`` entry, name -> args of
    ``testing.programs.BENCHMARKS``): ``greedy`` and ``singleton`` under
    ``comm`` on a mesh of every rank, and ``greedy`` with no mesh; each
    mesh run must equal the mesh-less one bitwise.  Then ``check_dist`` on
    ``seeds`` (``seed_size`` elements, the torch floor), keeping its mesh
    outputs.  Returns ``{"runs": {name: {mode: run}}, "seeds": {seed:
    outputs}}``; without ``keep_outputs`` the runs keep no arrays."""
    from ..core import dist
    from ..core import lazy as bh
    from ..core.dist import host_mesh
    from .programs import BENCHMARKS
    from .tapegen import check_dist
    mesh = host_mesh(device=device)
    n = dist.world_size()
    todo = {name: (lambda f=f: f(bh, dist, n, size))
            for name, f in PROGRAMS.items()}
    for name, args in (benchmarks or {}).items():
        todo[name] = lambda f=BENCHMARKS[name], a=args: f(*a).numpy()
    runs: Dict[str, dict] = {}
    for name, fn in todo.items():
        modes = {}
        for mode, kw in (("greedy", dict(algorithm="greedy", mesh=mesh)),
                         ("singleton", dict(algorithm="singleton",
                                            mesh=mesh)),
                         ("single", dict(algorithm="greedy"))):
            modes[mode] = run_once(fn, device, warm, backend=backend,
                                   cost_model="comm", **kw)
        want = modes["single"]["out"]
        for mode in ("greedy", "singleton"):
            got = modes[mode]["out"]
            if got.dtype != want.dtype or got.shape != want.shape or \
                    got.tobytes() != want.tobytes():
                raise AssertionError(f"{name} [{mode} on a mesh of {n}] "
                                     "differs from the single-device run")
        if not keep_outputs:
            for run in modes.values():
                run.pop("out")
        runs[name] = modes
    outs = {seed: check_dist(seed, size=seed_size, device=device)
            for seed in seeds}
    return {"runs": runs, "seeds": outs if keep_outputs else {},
            "n_seeds": len(outs)}


def _rank(rank: int, world: int, store: str, out_dir: str, device: str,
          job: Callable, kwargs: dict) -> None:
    import torch
    import torch.distributed as tdist
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(store, world),
                             rank=rank, world_size=world,
                             timeout=datetime.timedelta(seconds=300))
    try:
        res = job(device=device, **kwargs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        tdist.destroy_process_group()


def spawn(job: Callable, n: int, device: str = "cpu", **kwargs) -> list:
    """Run ``job(device=device, **kwargs)`` on ``n`` ranks over gloo (a
    ``FileStore`` in a temporary directory) and return each rank's result,
    in rank order.  A rank that raises fails the call (the others are
    terminated)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(n, os.path.join(tmp, "store"), tmp, device,
                              job, kwargs), nprocs=n, join=True)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
