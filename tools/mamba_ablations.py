"""Find what holds the Mamba-scan kernel (B5) above its bound, on one GPU.

    python3 tools/mamba_ablations.py

Builds textual variants of ``src/repro_torch/csrc/mamba_scan.cu``, each
with one part of the work taken out, into libraries of their own under
``build/mamba_ablations/`` (one ``nvcc`` each, all at once, with the
package's flags), and times each on ``chip_smoke.py``'s Jamba-v0.1 case
(B 2, T 4096, d_inner 8192, d_state 16, float32) in the kernel's own
layout (4 lanes x 4 states, 2 channels a thread, 64 a block): a CUDA
graph-free launch through ctypes, CUDA events around 3 launches, median
of 5.  The variants compute wrong results on purpose (nothing checks
them): only their times mean anything.

* ``base``: the kernel as it is;
* ``noexp``: the decay without its ``ex2`` (no SFU work);
* ``nobc``: B_t and C_t not read from shared memory;
* ``noepi``: no tile epilogue (the lanes' sums and y's stores);
* ``noload``: no tile loaded after the first two;
* ``scanonly``: neither epilogue nor loads — the scan alone;
* ``scanonly_noexp``, ``scanonly_nobc``: the scan alone, less one more;
* ``noscan``: the loads and the epilogue without the scan.

It also measures the card's special-function and FMA rates with a
microbenchmark (8 independent ``ex2.approx`` or FFMA chains a thread,
528 to 1056 blocks of 256 threads), the rates ``chip_smoke._bound`` takes
from the data sheet.  Prints one JSON line tagged ``MAMBA_ABLATIONS`` and
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "mamba_ablations"
SHAPE = (2, 4096, 8192, 16)
#: the kernel's layout at d_state 16 (kernels/mamba_scan/kernel.py:layout)
LANES, SPL = 4, 4

EXP = ("fmaf(ex2(cur.dt[k] * a2[k][j])", "fmaf((cur.dt[k] * a2[k][j])")
BC = ("    load_vec<T, SPL>(bs, b);\n    load_vec<T, SPL>(cs, c);",
      "    for (int j = 0; j < SPL; ++j) { b[j] = x[0]; c[j] = dt[0]; }")
EPI = ("    for (int r = lane; r < n; r += g.L)\n",
       "    for (int r = lane; r < 0; r += g.L)\n")
LOAD = ("      if (nt < ntiles)\n        load_tile(",
        "      if (false && nt < ntiles)\n        load_tile(")
SCAN = ("    for (int r = 0; r < n; ++r) {\n      Step<T, K, SPL> nxt;",
        "    for (int r = 0; r < 0; ++r) {\n      Step<T, K, SPL> nxt;")
VARIANTS = {
    "base": [], "noexp": [EXP], "nobc": [BC], "noepi": [EPI],
    "noload": [LOAD], "scanonly": [EPI, LOAD],
    "scanonly_noexp": [EPI, LOAD, EXP], "scanonly_nobc": [EPI, LOAD, BC],
    "noscan": [SCAN],
}

MICRO = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
template <bool SFU>
__global__ void chains(float* out, int iters) {
  float v[8];
  for (int k = 0; k < 8; ++k) v[k] = threadIdx.x * 1e-3f + k * 1e-4f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = SFU ? ex2(v[k]) * -0.5f : fmaf(v[k], 0.999f, 1e-3f);
  }
  float s = 0.f;
  for (int k = 0; k < 8; ++k) s += v[k];
  if (s == 1234.5f) out[threadIdx.x] = s;
}
extern "C" int micro(int sfu, int blocks, int iters, float* out, void* st) {
  if (sfu) chains<true><<<blocks, 256, 0, (cudaStream_t)st>>>(out, iters);
  else chains<false><<<blocks, 256, 0, (cudaStream_t)st>>>(out, iters);
  return cudaGetLastError();
}
"""


def variant(src: str, subs) -> str:
    """``src`` with each ``(old, new)`` of ``subs`` replaced; raises if the
    source has no ``old``."""
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"the source has no {old!r}")
        src = src.replace(old, new)
    return src


def build(out: Path, sources: dict) -> dict:
    """Compile each ``name: CUDA source`` into ``out/<name>.so`` with the
    package's flags, one ``nvcc`` each, all at once.  Returns the
    libraries' paths by name."""
    from repro_torch.kernels import cuda_build
    nvcc = cuda_build.find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-shared", "-I",
             str(cuda_build.CSRC_DIR), "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
    return {name: out / f"{name}.so" for name in sources}


def main() -> int:
    if not torch.cuda.is_available():
        print("mamba_ablations: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import cuda_build
    src = (cuda_build.CSRC_DIR / "mamba_scan.cu").read_text()
    libs = build(OUT, {"micro": MICRO, **{
        name: variant(src, subs) for name, subs in VARIANTS.items()}})
    stream = torch.cuda.current_stream().cuda_stream
    out = {"micro": {}, "ms": {}}
    lib = ctypes.CDLL(str(libs["micro"]))
    lib.micro.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    buf = torch.empty(256, device="cuda")
    for sfu, what in ((1, "ex2_per_s"), (0, "ffma_per_s")):
        rates = []
        for blocks in (132 * 4, 132 * 8):
            ms = cs.cuda_ms(lambda: lib.micro(sfu, blocks, 4096,
                                              buf.data_ptr(), stream),
                            reps=5, burst=2)
            rates.append(blocks * 256 * 4096 * 8 / (ms * 1e-3))
        out["micro"][what] = max(rates)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bsz, t, di, ds = SHAPE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    ins = (randn(bsz, t, di), F.softplus(randn(bsz, t, di)) * 0.1,
           randn(bsz, t, ds), randn(bsz, t, ds),
           -F.softplus(randn(di, ds)) - 0.2, randn(di))
    y = torch.empty_like(ins[0])
    for name in VARIANTS:
        fn = ctypes.CDLL(str(libs[name])).repro_mamba_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]

        def run():
            # no initial state and no final one (h0, hT null)
            err = fn(*[z.data_ptr() for z in ins], None, None, y.data_ptr(),
                     0, bsz, t, di, ds, LANES, SPL, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        out["ms"][name] = cs.cuda_ms(run, reps=5, burst=3)
        print(f"MAMBA ablation {name}: {out['ms'][name]:.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    print("MAMBA_ABLATIONS " + json.dumps(out), flush=True)
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
