"""The readings that a cell's output-check limit is set from, at the
cell's own size, in one process:

    python3 bench/control.py --workload <cell> --seeds 1 2 ... [--control 1 2 3] [--dump DIR]

For each seed: set-up as a run makes it, one batch of the cell's traffic
through the timed steps, then the output check's readings of the sampled
requests (``check.py``: the lower readings, from the program).  For each
``--control`` seed besides: the control, the reference in float8
(``reference/common.py:FP8``) put in the program's place on the same
prompts and served tokens (the upper reading).  One JSON line a seed:
for the program and the control, ``correct`` and the checks as the
harness's own comparison decides them at the cell's limits, the worst
block at other block lengths, the pooled median, the widest gap
and the share of served tokens not the reference's first choice.  With
``--dump`` each seed's per-position readings (``rms`` and ``gap``,
``(requests, positions)``) go to ``DIR/<cell>.<seed>.npz`` besides.  It
needs the card, as a run does."""

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: block lengths whose worst block is printed beside the cell's own
BLOCKS = (4, 8, 16, 32, 64, 128, 256)


def _summary(harness, check, layout, run, r) -> dict:
    checks = harness.compare(layout, run, r)
    rms = r["rms"]
    return {"correct": harness.correct(checks),
            "checks": {k: v for k, (v, _) in checks.items()},
            "worst_block": {b: check.worst_block(rms, b) for b in BLOCKS
                            if b <= rms.shape[1]},
            "logit_rms_median": float(np.median(rms)),
            "logit_rms_max": float(rms.max()),
            "widest_gap": float(r["gap"].max()),
            "off_share": float((r["gap"] > 0).mean())}


def main(argv) -> int:
    import argparse
    import gc
    import json

    import torch

    from bench import check, harness
    from bench.reference.common import FP8
    ap = argparse.ArgumentParser(prog="bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--dump", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench/control.py: needs a CUDA device", file=sys.stderr)
        return 2
    layout, dev = harness.Layout(ROOT), torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        phases = {}
        served = harness.setup(layout, args.workload, seed, dev, phases)
        run = harness.window(served, 0.0, False, None, 0.0)
        t1 = time.perf_counter()
        readings = {"program": harness.sampled_readings(layout, run)}
        line = {"workload": args.workload, "seed": seed,
                "setup_phases_s": phases,
                "program": _summary(harness, check, layout, run,
                                    readings["program"])}
        line["check_s"] = time.perf_counter() - t1
        if seed in args.control:
            readings["control"] = harness.sampled_readings(layout, run,
                                                           control=FP8)
            line["control"] = _summary(harness, check, layout, run,
                                       readings["control"])
        if args.dump is not None:
            args.dump.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(
                args.dump / f"{args.workload}.{seed}.npz",
                **{f"{who}_{k}": r[k] for who, r in readings.items()
                   for k in ("rms", "gap")})
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del served, run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
