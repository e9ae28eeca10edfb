"""Fusion-decision explain CLI for the PyTorch port (the counterpart of
``tools/explain.py``).

Runs the same small demo program on the port's lazy runtime and prints the
:mod:`repro_torch.core.obs.explain` report for its flush: per-block
composition, every merge the WSP partitioner took or rejected (with the
priced saving), every backend's claim/decline verdict per block, cache
provenance and the loop-fuser log.

    PYTHONPATH=src python -m tools.explain_torch             # on the card
    PYTHONPATH=src python -m tools.explain_torch --device cpu --json
    python3 tools/explain_torch.py --algorithm linear --backend torch

The runtime runs on the CUDA card unless given ``--device cpu``.  The demo
program exercises the interesting decision paths: a fusible elementwise
chain (merges taken), a shifted-view in-place update (a Def. 12
fuse-forbidden edge the partitioner must reject, priced), a reduction and
a matmul, which the ``triton`` backend declines with its ``opcode`` slug.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def demo_program(rt):
    """Record + flush the demo tape (``tools/explain.py``'s program)."""
    import numpy as np

    from repro_torch.core import lazy as bh

    x = bh.asarray(np.linspace(0.0, 1.0, 1024))
    y = bh.asarray(np.linspace(1.0, 2.0, 1024))
    # fusible chain: these should merge into one block
    z = x * 0.5 + bh.sin(y) * 0.25
    w = z + x * y
    # shifted in-place update: reads t[:-1] while writing x[1:] — Def. 12
    # forbids fusing this with the producer, so the partitioner must
    # reject a priced merge here
    t = w * 2.0
    x[1:] = t[:-1]
    out = x + w
    # a matmul block: opaque to the triton generator, so with the default
    # triton,torch preference the report shows a per-backend decline reason
    a = bh.asarray(np.arange(64.0).reshape(8, 8))
    mm = bh.matmul(a, a)
    rt.flush()
    return out, mm


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="tools.explain_torch",
        description="Explain the port runtime's fusion/lowering decisions")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report")
    ap.add_argument("--algorithm", default="greedy",
                    help="WSP algorithm (default: greedy)")
    ap.add_argument("--cost-model", default="bohrium",
                    help="cost model (default: bohrium)")
    ap.add_argument("--backend", default="triton,torch",
                    help="comma-separated lowering backend preference "
                         "order (default: triton,torch)")
    ap.add_argument("--partition-backend", default="greedy",
                    choices=("greedy", "ilp"),
                    help="partition solver (default: greedy)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace):
    """Run the demo under ``args``; returns the report and the backend
    counts the executor ran its flush on
    (``history[-1]["exec"]["backend_blocks"]``)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.core.lazy import fresh_runtime
    from repro_torch.core.obs import explain

    backends = tuple(b for b in args.backend.split(",") if b)
    with fresh_runtime(algorithm=args.algorithm,
                       cost_model=args.cost_model, backend=backends,
                       partition_backend=args.partition_backend,
                       device=args.device) as rt:
        demo_program(rt)
        report = explain(rt)
        executed = dict(rt.history[-1]["exec"]["backend_blocks"])
    return report, executed


def main(argv=None) -> int:
    args = parse(argv)
    report, _ = run(args)
    print(report.to_json() if args.json else report.format_text())
    return 0


if __name__ == "__main__":
    sys.exit(main())
