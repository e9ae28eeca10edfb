"""Sweep the tile shape of the flash-attention kernel (B3) on one GPU.

    PYTHONPATH=src python3 tools/flash_shapes.py [--out FILE]

``src/repro_torch/csrc/flash_attention.cu`` gives each instance a tile
shape — warps a block (16 query rows each) and key rows a tile — in its
``Shape`` table.  This script builds a copy of the source once per
candidate pair of shapes for the float32 D 128 and bfloat16 D 256
instances (one ``nvcc`` each, all at once, with the package's flags)
into libraries of its own under ``build/flash_shapes/``,
and times each on ``chip_smoke.py``'s two B3 cases — a Qwen1.5-4B prefill
(float32, D 128) and a Gemma2-9B local layer (bfloat16, D 256) — as a
CUDA graph of one launch replayed between CUDA events (median of 10), each
held against the plain version by ``chip_smoke.py``'s per-element rule.
It prints one line per variant and case with the ``-Xptxas -v`` report of
the instance, and writes the rows as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: (warps, key rows) of the float32 D 128 and the bfloat16 D 256 instance,
#: built together, one library per pair
VARIANTS = [((4, 32), (4, 16)), ((8, 32), (8, 32)), ((4, 16), (8, 16)),
            ((8, 64), (4, 32))]


def build(variants, out_dir: Path) -> list:
    from repro_torch.kernels import cuda_build
    nvcc = cuda_build.find_nvcc()
    src = cuda_build.CSRC_DIR / "flash_attention.cu"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (f32, bf) in enumerate(variants):
        lib = out_dir / f"flash_{i}.so"
        text = src.read_text()
        for key, shape in (("float, 128", f32), ("bf16, 256", bf)):
            text, n = re.subn(rf"Shape<{key}> : ShapeOf<\d+, \d+>",
                              f"Shape<{key}> : ShapeOf<{shape[0]}, "
                              f"{shape[1]}>", text)
            if n != 1:
                raise RuntimeError(f"no Shape<{key}> entry in {src}")
        copy = out_dir / f"flash_{i}.cu"
        copy.write_text(text)
        cmd = [nvcc, *cuda_build.NVCC_FLAGS, "-shared", "-I",
               str(cuda_build.CSRC_DIR), "-o", str(lib), str(copy)]
        jobs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    built = []
    for lib, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{text}")
        built.append((lib, text))
    return built


def ptxas_lines(text: str, dtype: torch.dtype, d: int) -> str:
    """The registers/spill lines of the (dtype, D) instance, found by its
    mangled template arguments."""
    mangled = ("If" if dtype == torch.float32 else "I13__nv_bfloat16") + \
        f"Li{d}E"
    lines = text.splitlines()
    keep = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and mangled in line:
            keep += [x.strip() for x in lines[i + 1:i + 4]
                     if "Used" in x or "spill" in x]
    return " | ".join(keep)


def time_library(lib_path: Path, log: str, cases, plain, shapes) -> list:
    """Time the launcher of the library at ``lib_path`` on each case (a
    ``chip_smoke._model_cases`` entry) and hold it against ``plain``;
    ``shapes`` maps the dtype to the (warps, key rows) it was built with."""
    import chip_smoke as cs
    from repro_torch.kernels import cuda_build
    fn = ctypes.CDLL(str(lib_path)).repro_flash_attention_fwd
    fn.argtypes = [cuda_build._CTYPES[c] for c in "ppppiiiiiiifiiiifp"]
    fn.restype = ctypes.c_int
    rows = []
    for case, want in zip(cases, plain):
        q, k, v, causal, window, softcap = case["args"]
        shape = shapes[q.dtype]
        out = torch.empty_like(q)
        b, hq, sq, d = q.shape

        def run():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), cuda_build.DTYPE_CODES[q.dtype], b, hq,
                     k.shape[1], sq, k.shape[2], d, 1.0 / math.sqrt(d),
                     int(causal), int(window is not None), window or 0,
                     int(softcap is not None), softcap or 0.0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        run()
        torch.cuda.synchronize()
        rtol = cs.BF16_RTOL if q.dtype == torch.bfloat16 else 0.0
        err, share = cs._hold(out, want, rtol, cs.MODEL_TOL["flash_attention"])
        ms = cs.graph_ms(run)
        row = {"library": lib_path.name, "case": case["label"],
               "warps": shape[0], "key_rows": shape[1],
               "query_rows": 16 * shape[0], "ms": ms, "max_abs_err": err,
               "share": share, "ptxas": ptxas_lines(log, q.dtype, d)}
        rows.append(row)
        print(f"FLASH_SHAPE {row['library']} {row['case']}: "
              f"warps={shape[0]} query_rows={16 * shape[0]} "
              f"key_rows={shape[1]} ms={ms:.4f} max_abs_err={err:.3g} "
              f"share={share:.3g} ptxas: {row['ptxas']}", flush=True)
    return rows


def flash_cases():
    """chip_smoke.py's two B3 cases and their plain versions."""
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention.ref import reference_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [c for c in cs._model_cases(gen) if c["kernel"] ==
             "flash_attention"]
    plain = [reference_attention(*c["args"][:3], causal=c["args"][3],
                                 window=c["args"][4], softcap=c["args"][5])
             for c in cases]
    return cases, plain


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_shapes: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "flash_shapes" /
                                         "flash_shapes.json"))
    args = ap.parse_args()
    cases, plain = flash_cases()
    built = build(VARIANTS, ROOT / "build" / "flash_shapes")
    rows = []
    for (f32, bf), (lib_path, log) in zip(VARIANTS, built):
        rows += time_library(lib_path, log, cases, plain,
                             {torch.float32: f32, torch.bfloat16: bf})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
