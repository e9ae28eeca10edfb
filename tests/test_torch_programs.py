"""The 15 Benchpress programs and the quickstart's velocity-update block run
through the port (``device="cpu"``, on the torch floor and on the triton
backend, whose fused-block kernel takes its plain version on the CPU) and
through the JAX package (``backend="xla"``, ``loop_fusion=False``), at
``tests/test_codegen.py``'s ``SCALED`` sizes.  Results agree within
``rtol=atol=1e-9`` (the reference's own program tolerance: XLA on the CPU
contracts multiply-adds into FMAs and sums in another order).

Every block the port's triton backend dispatched is also translated back to
the reference IR: the port claims it exactly when the reference's
``block_lower_reason`` does, and declines it with the same slug.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import lazy as rbh
from repro.core.lazy import fresh_runtime as ref_fresh_runtime
from repro.kernels.fused_block.codegen import block_lower_reason as ref_reason

from repro_torch.core.lazy import fresh_runtime
from repro_torch.testing.programs import BENCHMARKS, quickstart
from test_codegen import SCALED
from test_torch_planning import to_reference

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks.programs import BENCHMARKS as REF_BENCHMARKS  # noqa: E402


def ref_quickstart(iters=1, n=100_000):
    for _ in range(iters):
        x = rbh.random((n,))
        v = rbh.random((n,))
        force = rbh.sin(x) * 0.3 - x * 0.01
        v += force * 0.5
        x += v * 0.5
        ke = (v * v).sum() * 0.5
        force.delete()
        rbh.sync(ke)
    return ke


CASES = list(SCALED) + [("quickstart", (1, 5000))]
PORT = dict(BENCHMARKS, quickstart=quickstart)
REF = dict(REF_BENCHMARKS, quickstart=ref_quickstart)


def _record_blocks(rt):
    """Wrap the runtime's executor so every dispatched schedule's blocks
    are kept as ``(ops, lowering decision)``."""
    seen = []
    run = rt.executor.run_schedule

    def spy(schedule, buffers):
        for plan in schedule.blocks:
            if plan.has_work:
                seen.append(([schedule.tape[i] for i in plan.op_indices],
                             plan.lowering))
        return run(schedule, buffers)

    rt.executor.run_schedule = spy
    return seen


@pytest.mark.parametrize("name,args", CASES, ids=[c[0] for c in CASES])
def test_program_matches_reference(name, args):
    with ref_fresh_runtime(algorithm="greedy", backend="xla",
                           loop_fusion=False):
        want = np.asarray(REF[name](*args))
    for backend in ("torch", "triton"):
        with fresh_runtime(algorithm="greedy", backend=backend,
                           device="cpu", loop_fusion=False) as rt:
            blocks = _record_blocks(rt)
            got = np.asarray(PORT[name](*args))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9,
                                   err_msg=f"{name} on {backend}")
        if backend == "triton":
            st = rt.executor.stats
            assert st["triton_blocks"] + st["triton_fallback_blocks"] \
                == len(blocks)
            for ops, decision in blocks:
                slug = ref_reason(to_reference(ops))
                claimed = decision.backend == "triton"
                assert claimed == (slug is None), (name, slug)
                if not claimed:
                    assert decision.reason_for("triton") == slug
