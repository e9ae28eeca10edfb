"""What one float64 libdevice call costs the fused-block kernel (B1) on one
GPU, against the one operation its bound counts for it.

    PYTHONPATH=src python3 tools/b1_libdevice.py [--out FILE]

B1's bound (``codegen.block_ops``) counts every node as one operation per
element, a libdevice ``log``, ``exp``, ``erf`` or ``fmod`` and a float64
division included, at the card's float64 rate (``chip_smoke.
PEAK_OPS_PER_S``, 17e12/s: the data sheet's FMA-counted 34 TFLOP/s
halved).  This script times, over 2**24 float64 elements, one Triton pass
of each of those functions (plus a plain copy, and the ``mod`` by a power
of two that replaces ``fmod`` there) and a pass that chains 32 calls per
element; the difference, over 31 calls and 2**24 elements, is one call's
cost.  It prints each as ns per element (the whole card's time for 2**24
calls, over 2**24) and as float64 operations at 17e12/s — how many of the
bound's operations one call is worth.  A chain step also does the
chain's own one or two cheap operations (a negation, an add or a
multiply), named in each line.

Then it runs black_scholes and leibnitz_pi at ``CHIP_SIZES`` on the
``triton`` backend, takes each program's largest block as
``chip_smoke.py`` does, and prints its kernel time against the bound as
counted (each call one operation) and with each call weighted by its
measured cost.  Timing: the launches in a CUDA graph, 5 replays between
CUDA events, median of 10 (``chip_smoke.graph_ms``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

N = 2 ** 24
REPS = 32
BLOCK = 1024
#: function -> (one chain step on x, the chain's extra operations, first
#: input's range).  Each keeps x finite and in the function's working
#: range; fmod and mod by 2 take x·2**23 + 1 so the exponent gap is
#: leibnitz_pi's (indices up to 2**24 over 2.0)
FUNCS = {
    "copy": ("x", "none", (0.5, 1.5)),
    "div": ("1.0000001 / x", "none", (0.5, 1.5)),
    "log": ("libdevice.log(x) + 1.5", "one add", (0.5, 1.5)),
    "exp": ("libdevice.exp(-x)", "one negation", (0.5, 1.5)),
    "erf": ("libdevice.erf(x)", "none", (0.5, 1.5)),
    "fmod": ("libdevice.fmod(x * 8388608.0, two) + 1.0", "a multiply, an add",
             (0.5, 1.5)),
    "mod_pow2": ("_mod_pow2(x * 8388608.0, two, half, big) + 1.0",
                 "a multiply, an add", (0.5, 1.5)),
}


def _source(name: str, expr: str, reps: int) -> str:
    from repro_torch.kernels.fused_block.codegen import _HELPERS
    steps = "\n".join(f"    x = {expr}" for _ in range(reps)) \
        if name != "copy" else ""
    return "\n".join([
        "import triton", "import triton.language as tl",
        "from triton.language.extra import libdevice", _HELPERS,
        "@triton.jit",
        "def k(X, Y, n, BLOCK: tl.constexpr):",
        "    i = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)",
        "    m = i < n",
        "    x = tl.load(X + i, mask=m, other=1.0)",
        # float64 constants: libdevice.fmod takes two operands of one type
        "    two = tl.full((BLOCK,), 2.0, tl.float64)",
        "    half = tl.full((BLOCK,), 0.5, tl.float64)",
        "    big = tl.full((BLOCK,), 9007199254740992.0, tl.float64)",
        steps,
        "    tl.store(Y + i, x, mask=m)", ""])


def time_funcs() -> dict:
    from chip_smoke import PEAK_OPS_PER_S, graph_ms
    from repro_torch.kernels.fused_block.codegen import _load_module
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (expr, extra, (lo, hi)) in FUNCS.items():
        x = lo + (hi - lo) * torch.rand(N, generator=gen, device="cuda",
                                        dtype=torch.float64)
        y = torch.empty_like(x)
        ms = {}
        for reps in (1, REPS):
            mod = _load_module(_source(name, expr, reps))
            ms[reps] = graph_ms(lambda: mod.k[(N // BLOCK,)](
                x, y, N, BLOCK=BLOCK, num_warps=4, enable_fp_fusion=False))
        call_s = (ms[REPS] - ms[1]) * 1e-3 / (REPS - 1)
        row = {"pass_ms": ms[1], "chain_ms": ms[REPS], "chain_extra": extra,
               "ns_per_element": call_s / N * 1e9,
               "float64_ops": call_s * PEAK_OPS_PER_S["float64"] / N}
        out[name] = row
        print(f"LIBDEVICE {name}: one pass over 2**24 float64 = "
              f"{ms[1]:.4f} ms, a chain of {REPS} = {ms[REPS]:.4f} ms; one "
              f"call {row['ns_per_element']:.6f} ns per element = "
              f"{row['float64_ops']:.2f} float64 operations at 17e12/s "
              f"(chain step also does: {extra})", flush=True)
    return out


#: block opcode -> measured function whose cost weights it
WEIGHTED = {"div": "div", "reciprocal": "div", "log": "log", "exp": "exp",
            "erf": "erf", "sigmoid": "exp", "mod": "fmod"}


def reweigh(costs: dict) -> dict:
    """The largest block of black_scholes and leibnitz_pi: kernel time,
    the bound as counted, and the bound with each call weighted by its
    measured cost (a ``mod`` by a power of two at ``mod_pow2``'s)."""
    import chip_smoke as cs
    from repro_torch.core import lazy
    from repro_torch.kernels.fused_block import codegen
    from repro_torch.kernels.fused_block.codegen import _pow2_divisor
    from repro_torch.testing.programs import BENCHMARKS, CHIP_SIZES
    out = {}
    for prog in ("black_scholes", "leibnitz_pi"):
        with cs.BlockRecorder(codegen.FusedBlockKernel) as rec:
            with lazy.fresh_runtime(backend="triton", loop_fusion=False):
                np.asarray(BENCHMARKS[prog](*CHIP_SIZES[prog]))
        kernel, bufs_and_salts, _ = max(
            rec.calls.values(), key=lambda c: cs.block_size(c[0], codegen))
        plan = kernel.plan
        ms = cs.kernel_ms(kernel, *cs._block_inputs(kernel, bufs_and_salts))
        bound = cs.block_bound(kernel, codegen)
        ops = dict(codegen.block_ops(plan))
        dts = codegen._operand_dtypes(plan)
        extra = 0.0
        for node in plan.nodes:
            fn = WEIGHTED.get(node.opcode)
            if fn is None or np.dtype(node.out_dtype) != np.float64:
                continue
            if node.opcode == "mod":
                raw = [(None, x) if tag == "lit" else
                       ("x", dts[x] if tag == "op"
                        else np.dtype(plan.nodes[x].out_dtype))
                       for tag, x in node.terms]
                if _pow2_divisor("mod", raw) is not None:
                    fn = "mod_pow2"
            extra += (costs[fn]["float64_ops"] - 1) * plan.N
        ops["float64"] = ops.get("float64", 0) + extra
        weighted_ms = max(bound["bytes"] / cs.HBM_BYTES_PER_S,
                          max(n / cs.PEAK_OPS_PER_S.get(
                              t, cs.PEAK_OPS_PER_S["float32"])
                              for t, n in ops.items())) * 1e3
        out[prog] = {"domain": plan.domain, "kernel_ms": ms,
                     "bound_ms": bound["bound_ms"],
                     "weighted_bound_ms": weighted_ms,
                     "nodes": [n.opcode for n in plan.nodes]}
        print(f"REWEIGH {prog} largest block {plan.domain} nodes "
              f"{[n.opcode for n in plan.nodes]}: kernel_ms={ms:.4f} "
              f"bound_ms (a call = 1 operation)={bound['bound_ms']:.4f} "
              f"kernel/bound={ms / bound['bound_ms']:.2f}; bound_ms (each "
              f"call at its measured cost)={weighted_ms:.4f} kernel/bound="
              f"{ms / weighted_ms:.2f}", flush=True)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b1_libdevice: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    costs = time_funcs()
    blocks = reweigh(costs)
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"card": smi.stdout.strip(), "funcs": costs, "blocks": blocks},
            indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
