"""Time the Mamba-scan kernel (B5) in each layout on one GPU.

    python3 tools/mamba_layouts.py [--sass] [--out FILE]
    python3 tools/mamba_layouts.py --src OLD/src --label parent

On ``chip_smoke.py``'s Jamba-v0.1 case (B 2, T 4096, d_inner 8192,
d_state 16, float32, inputs drawn the same way from seed 0) the script
times the kernel in layouts it does not ship — lanes a channel x states a
lane (16 x 1, 8 x 2, 4 x 4, 2 x 8, 1 x 16) by the channels a thread holds
(1, 2, 4) and a block holds — and its own (4 x 4, 2 channels a thread, 64
a block).  Each (channels a thread, channels a block) is a copy of
``src/repro_torch/csrc/mamba_scan.cu`` with its ``GROUP``, ``CHANNELS``
and instances changed, plus a function that reports a launch's
occupancy, built into ``build/mamba_layouts/`` (one ``nvcc`` each, all at
once, with the package's flags).  Each layout is timed as a CUDA graph of
one launch replayed between CUDA events (median of 10), held against the
plain version by ``chip_smoke.py``'s per-element rule, beside the
launch's occupancy (the tile of steps, shared memory and registers a
block, blocks an SM holds and blocks in the grid) and the bound
(``chip_smoke._bound``).  The package's own ``ops.mamba`` is timed too,
and where it takes a state, its served form (a zero float32 state in,
the final state out).
With ``--src`` it times that tree's ``ops.mamba`` only, so a parent and
this tree can be timed in turns in one call.  ``--sass`` disassembles
the copies (``cuobjdump -sass``) and counts, in each float32 instance,
the instructions from its first to its last ``MUFU.EX2`` (the unrolled
step loop) by opcode.  Prints one JSON line tagged ``MAMBA_LAYOUTS`` and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import inspect
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mamba_layouts"

#: (lanes, states a lane, channels a thread, channels a block) at d_state
#: 16: lanes x states a lane 16 x 1, 8 x 2, 4 x 4, 2 x 8 and 1 x 16 by the
#: channels a thread holds (1, 2 or 4) and a block holds
LAYOUTS = [(16, 1, 1, 32), (8, 2, 1, 32), (4, 4, 1, 32), (4, 4, 1, 128),
           (2, 8, 1, 64), (1, 16, 1, 32), (1, 16, 1, 128), (8, 2, 2, 64),
           (4, 4, 2, 64), (4, 4, 2, 128), (2, 8, 2, 64), (2, 8, 2, 128),
           (16, 1, 4, 128), (8, 2, 4, 128), (4, 4, 4, 128), (4, 4, 4, 256)]
SHAPE = (2, 4096, 8192, 16)

#: what a copy adds: steps a tile, shared memory bytes a block, registers a
#: thread, blocks an SM can hold (the occupancy calculator's), blocks in
#: the grid, for a launch of L lanes x SPL states
INFO = r"""
extern "C" int mamba_layout_info(int dtype, int B, int Tn, int Di, int Ds,
                                 int L, int SPL, int* info) {
  return with_type(dtype, SPL, [&](auto t, auto s) {
    using T = decltype(t);
    constexpr int S = decltype(s)::value;
    Plan p;
    int err = plan<T, S>(B, Di, Ds, L, &p);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, mamba_fwd<T, S>);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mamba_fwd<T, S>, L * CHANNELS / GROUP, p.smem);
    if (err != cudaSuccess) return err;
    info[0] = p.g.TC;
    info[1] = int(p.smem);
    info[2] = attr.numRegs;
    info[3] = per_sm;
    info[4] = int(p.grid.x * p.grid.y);
    return int(cudaSuccess);
  });
}
"""


def sources(src: str) -> dict:
    """A copy of the kernel's source for each (channels a thread, channels
    a block) of :data:`LAYOUTS`, with the instances its layouts take."""
    cases = re.search(r"  switch \(SPL\) \{\n(.*?)  \}\n", src, re.S)
    if not cases:
        raise RuntimeError("the source has no switch (SPL)")
    spls = collections.defaultdict(set)
    for _, spl, group, channels in LAYOUTS:
        spls[group, channels].add(spl)
    from tools.mamba_ablations import variant
    out = {}
    for (group, channels), want in spls.items():
        text = variant(src, [
            ("constexpr int GROUP = 2;", f"constexpr int GROUP = {group};"),
            ("constexpr int CHANNELS = 64;",
             f"constexpr int CHANNELS = {channels};"),
            (cases.group(1), "".join(
                f"    case {s}: return f(T(), I<{s}>());\n"
                for s in sorted(want)))])
        out[f"group{group}_channels{channels}"] = text + INFO
    return out


def _inputs():
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)
    bsz, t, di, ds = SHAPE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return (randn(bsz, t, di), F.softplus(randn(bsz, t, di)) * 0.1,
            randn(bsz, t, ds), randn(bsz, t, ds),
            -F.softplus(randn(di, ds)) - 0.2, randn(di))


def _sass(lib: Path) -> dict:
    """Per float32 instance of ``mamba_fwd``: opcodes from its first to its
    last ``MUFU.EX2``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.splitlines()[0].strip()
        m = re.search(r"mamba_fwdIfLi(\d+)ELi(\d+)E", name)  # <T, SPL, K>
        if not m:
            continue
        ops = [re.sub(r"^@!?U?P\w+\s+", "", ln.split("*/", 1)[1].strip())
               .split(" ")[0].rstrip(";")
               for ln in part.splitlines()
               if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
        ex2 = [i for i, op in enumerate(ops) if op == "MUFU.EX2"]
        span = ops[ex2[0]:ex2[-1] + 1] if ex2 else []
        counts = collections.Counter(op.split(".")[0] for op in span)
        out[f"group{m.group(2)}_spl{m.group(1)}"] = {
            "instructions": len(ops), "loop_span": len(span),
            "mufu_ex2": len(ex2),
            "per_ex2": round(len(span) / max(len(ex2), 1), 3),
            "by_opcode": dict(counts.most_common(14))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None)
    ap.add_argument("--label", default="change")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mamba_layouts: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, args.src or str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.mamba_scan import kernel as mk
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.ref import reference_mamba
    ins = _inputs()
    bsz, t, di, ds = SHAPE
    nbytes = (3 * bsz * t * di + 2 * bsz * t * ds + di * ds + di) * 4
    bound_ms, bound_by = cs._bound(nbytes, mk.mamba_ops(bsz, t, di, ds))
    plain = reference_mamba(*ins)
    out = {"label": args.label, "src": args.src or str(ROOT / "src"),
           "bound_ms": bound_ms, "bound_by": bound_by, "rows": []}

    def measure(run, **extra):
        err, share = cs._hold(run(), plain, 0.0, cs.MODEL_TOL["mamba_scan"])
        row = {**extra, "ms": cs.graph_ms(run), "max_abs_err": err,
               "allowance_share": share}
        row["kernel_over_bound"] = row["ms"] / bound_ms
        out["rows"].append(row)
        print(f"MAMBA layout {extra}: {row}", flush=True)

    measure(lambda: ops.mamba(*ins, 64), layout="default")
    if "state" in inspect.signature(ops.mamba).parameters:
        # the served form: a float32 state in (zeros, so y is the same) and
        # the final state out
        h0 = torch.zeros(ins[4].shape, device="cuda").expand(
            ins[0].shape[0], *ins[4].shape).contiguous()
        measure(lambda: ops.mamba(*ins, 64, state=h0, return_state=True),
                layout="default, state in and out")
    if not args.src:
        from tools.mamba_ablations import build
        libs = build(OUT, sources(
            (cuda_build.CSRC_DIR / "mamba_scan.cu").read_text()))
        y = torch.empty_like(ins[0])
        for lanes, spl, group, channels in LAYOUTS:
            lib = ctypes.CDLL(str(libs[f"group{group}_channels{channels}"]))
            info = (ctypes.c_int * 5)()
            lib.mamba_layout_info.argtypes = [ctypes.c_int] * 7 \
                + [ctypes.c_void_p]
            cuda_build.check(lib.mamba_layout_info(
                0, bsz, t, di, ds, lanes, spl, ctypes.addressof(info)),
                "layout")
            occ = dict(zip(("tile_steps", "smem_bytes", "registers",
                            "blocks_per_sm", "grid_blocks"), info))
            occ["warps_per_sm"] = min(
                occ["blocks_per_sm"], -(-occ["grid_blocks"] // 132)) \
                * (lanes * channels // group) // 32
            fn = lib.repro_mamba_scan_fwd
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
                + [ctypes.c_void_p]

            def run(fn=fn, lanes=lanes, spl=spl):
                # no initial state and no final one (h0, hT null)
                cuda_build.check(fn(
                    *[z.data_ptr() for z in ins], None, None, y.data_ptr(),
                    0, bsz, t, di, ds, lanes, spl,
                    torch.cuda.current_stream().cuda_stream), "mamba_scan")
                return y

            measure(run, lanes=lanes, spl=spl, group=group,
                    channels=channels, **occ)
        out["default"] = mk.layout(ds)
        if args.sass:
            out["sass"] = {name: _sass(lib) for name, lib in libs.items()}
            print(f"MAMBA sass {out['sass']}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print("MAMBA_LAYOUTS " + line, flush=True)
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
