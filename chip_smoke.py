"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

For every Benchpress program of ``repro_torch.testing.programs`` (and the
quickstart's velocity-update block) at ``CHIP_SIZES`` — every array 128 MiB
of float64 — the script:

1. runs the program through the lazy runtime with ``backend="triton"`` and
   with ``backend="torch"`` (the floor), twice each in one runtime, and
   times the second (warm) run of each;
2. requires the two backends to agree: bitwise for programs built only
   from correctly rounded ops, else within ``rtol=atol=1e-9`` (the
   reference's own program tolerance);
3. requires at least one fused-block kernel launch and no block declined
   with the ``error`` slug;
4. holds every distinct claimed block's kernel against its plain torch
   version on the block's own CUDA inputs (same tolerance);
5. times the program's largest block (most elements x ops): the kernel
   (its launches captured once in a CUDA graph with the arguments bound
   beforehand, so no host work is timed) against its plain version, each
   by CUDA events around back-to-back calls, median of 10, and against its
   bound — the larger of the bytes it must move over the H100's 3.35e12
   B/s and its arithmetic operations over the non-FMA rate of their type.

It then measures the per-block launch cost the ``gpu`` cost model uses,
prints a ``kernels`` JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failure raises (exit code 1).  The
Triton kernels are generated and compiled under ``build/`` as the run
needs them.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate (data sheet)
#: peak non-tensor-core operation rates of an H100 SXM by type.  The data
#: sheet's FP64 34 and FP32 67 TFLOP/s count an FMA as two operations; the
#: kernels launch with FMA contraction off, so one operation issues per
#: lane and cycle: half those rates.  Other types take the float32 rate.
PEAK_OPS_PER_S = {"float64": 17e12, "float32": 33.5e12}
TOL = dict(rtol=1e-9, atol=1e-9)
#: programs whose every op is correctly rounded and whose reductions (if
#: any) sum exact integers: the fused kernel must match the floor bit for bit
EXACT = {"game_of_life", "heat_equation", "sor", "water_ice", "shallow_water",
         "gauss_elimination", "lu_factorization", "stencil_27pt",
         "lattice_boltzmann", "monte_carlo_pi"}


def cuda_ms(fn, reps: int = 10, burst: int = 5) -> float:
    """Device time of one call of ``fn``: CUDA events around ``burst``
    back-to-back calls, divided by ``burst``; the median of ``reps`` such
    samples, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / burst)
    return statistics.median(times)


def kernel_ms(kernel, store, rvals, device) -> float:
    """Device time of one launch of a block's kernel and its combine
    passes: arguments bound first, the launches captured in a CUDA graph,
    and the graph replayed under :func:`cuda_ms`."""
    run, _ = kernel.prepare(store, rvals, device)
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    return cuda_ms(graph.replay)


def max_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    both_nan = np.isnan(got) & np.isnan(want)
    d = np.where(both_nan, 0.0, np.abs(got - want))
    return float(d.max()) if d.size else 0.0


def check_close(got, want, what: str, exact: bool) -> float:
    got, want = np.asarray(got), np.asarray(want)
    err = max_err(got, want)
    if exact:
        if not np.array_equal(got, want, equal_nan=True):
            raise AssertionError(f"{what}: not bitwise equal (max err {err})")
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    return err


class BlockRecorder:
    """Remembers, per distinct block signature, the generated kernel and the
    inputs of its first call (buffers are never written in place, so the
    tensors stay valid)."""

    def __init__(self, codegen):
        self.codegen = codegen
        self.calls = {}
        self._orig = codegen.FusedBlockKernel.__call__

    def __enter__(self):
        calls, orig = self.calls, self._orig

        def spy(kernel, *bufs_and_salts):
            calls.setdefault(id(kernel), (kernel, bufs_and_salts))
            return orig(kernel, *bufs_and_salts)

        self.codegen.FusedBlockKernel.__call__ = spy
        return self

    def __exit__(self, *exc):
        self.codegen.FusedBlockKernel.__call__ = self._orig


def run_program(name: str, args, fn, codegen, lazy) -> dict:
    out, warm_s, stats = {}, {}, {}
    for backend in ("triton", "torch"):
        with lazy.fresh_runtime(backend=backend) as rt:
            runs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = np.asarray(fn(*args))
                torch.cuda.synchronize()
                runs.append((res, time.perf_counter() - t0))
            out[backend] = [r for r, _ in runs]
            warm_s[backend] = runs[1][1]
            stats[backend] = rt.executor.stats.snapshot()
    exact = name in EXACT
    err = 0.0
    for k in range(2):
        err = max(err, check_close(out["triton"][k], out["torch"][k],
                                   f"{name} run {k}: triton vs torch", exact))
        if not np.all(np.isfinite(out["triton"][k])):
            raise AssertionError(f"{name}: non-finite result")
    st = stats["triton"]
    if "error" in st["triton_fallbacks"]:
        raise AssertionError(f"{name}: a block was declined with 'error'")
    return {"stats": st, "warm_s": warm_s, "err": err, "exact": exact}


def hold_blocks(name: str, calls: dict, codegen) -> dict:
    """Kernel vs plain on every distinct claimed block; times the largest."""
    worst = 0.0
    largest = None
    for kernel, bufs_and_salts in calls.values():
        got = kernel(*bufs_and_salts)
        want = kernel.plain(*bufs_and_salts)
        for g, w in zip(got, want):
            worst = max(worst, check_close(
                g.cpu().numpy(), w.cpu().numpy(),
                f"{name}: kernel vs plain on block {kernel.plan.domain}",
                exact=False))
        size = (kernel.plan.N * len(kernel.plan.nodes),
                codegen.block_bytes(kernel.plan))
        if largest is None or size > largest[0]:
            largest = (size, kernel, bufs_and_salts)
    _, kernel, bufs_and_salts = largest
    nbytes = codegen.block_bytes(kernel.plan)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(n_ops / PEAK_OPS_PER_S.get(dt, PEAK_OPS_PER_S["float32"])
                 for dt, n_ops in codegen.block_ops(kernel.plan).items()) * 1e3
    *bufs, salts = bufs_and_salts
    store = dict(zip(kernel.plan.inputs, bufs))
    dev = bufs[0].device if bufs else torch.device("cuda")
    rvals = kernel.draw_random(salts, dev)
    ms = kernel_ms(kernel, store, rvals, dev)
    plain_ms = cuda_ms(lambda: codegen.plain_slots(kernel.plan, store, rvals,
                                                   dev))
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "domain": kernel.plan.domain, "n_blocks": len(calls)}


def launch_cost_s(lazy, codegen) -> float:
    """Host time of one warm fused-block wrapper call on a tiny block
    (launch plus wrapper bookkeeping) — the ``gpu`` model's ``launch_s``."""
    from repro_torch.core.ir import BaseArray, Op, View
    n = 1024
    a, o = BaseArray(n, np.float64), BaseArray(n, np.float64)
    ops = [Op("mul", View.contiguous(o, (n,)), (View.contiguous(a, (n,)),
                                                2.0),
              new_bases=frozenset({o}))]
    fn, _, _ = codegen.build_block_kernel(ops, device=torch.device("cuda"))
    buf = torch.ones(n, dtype=torch.float64, device="cuda")
    for _ in range(10):
        fn(buf, ())
    torch.cuda.synchronize()
    reps = 500
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(buf, ())
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import lazy
    from repro_torch.kernels.fused_block import codegen
    from repro_torch.testing.programs import BENCHMARKS, CHIP_SIZES, quickstart

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    programs = dict(BENCHMARKS, quickstart=quickstart)
    launches = 0
    worst = 0.0
    overall = None
    for name, fn in programs.items():
        args = CHIP_SIZES[name]
        t0 = time.perf_counter()
        with BlockRecorder(codegen) as rec:
            codegen.LAUNCHES["fused_block"] = 0
            res = run_program(name, args, fn, codegen, lazy)
            n_launch = codegen.LAUNCHES["fused_block"]
        if n_launch == 0:
            raise AssertionError(f"{name}: no fused-block kernel launched")
        launches += n_launch
        blk = hold_blocks(name, rec.calls, codegen)
        worst = max(worst, blk["max_abs_err"])
        if overall is None or blk["bound_ms"] > overall["bound_ms"]:
            overall = blk
        st = res["stats"]
        run = st["triton_blocks"] + st["triton_fallback_blocks"]
        print(f"PROGRAM {name} args={args} blocks={run} "
              f"triton={st['triton_blocks']}/{run} "
              f"declines={dict(st['triton_fallbacks'])} launches={n_launch} "
              f"warm_ms triton={res['warm_s']['triton'] * 1e3:.3f} "
              f"torch={res['warm_s']['torch'] * 1e3:.3f} "
              f"{'bitwise' if res['exact'] else 'max_abs_err'}="
              f"{res['err']:.3g} distinct_blocks={blk['n_blocks']} "
              f"kernel_vs_plain_err={blk['max_abs_err']:.3g} | largest "
              f"block {blk['domain']}: kernel_ms={blk['ms']:.4f} "
              f"plain_ms={blk['plain_ms']:.4f} bytes={blk['bytes']} "
              f"bound_ms={blk['bound_ms']:.4f} ({blk['bound_by']}) "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        torch.cuda.empty_cache()
    launch_s = launch_cost_s(lazy, codegen)
    print(f"LAUNCH_COST fused_block wrapper call at n=1024: "
          f"{launch_s * 1e6:.2f} us", flush=True)
    kernels = {"kernels": [{
        "name": "fused_block",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_block/codegen.py",
        "replaces": "src/repro/kernels/fused_block/codegen.py:475",
        "launches": launches,
        "max_abs_err": worst,
        "ms": overall["ms"],
        "plain_ms": overall["plain_ms"],
        "bound_ms": overall["bound_ms"],
        "bound_by": overall["bound_by"],
        "library_ms": None,
    }]}
    print(json.dumps(kernels))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
