"""The ``triton`` lowering backend — one generated Triton kernel per block
(the port's counterpart of the reference's ``pallas`` backend).

Wraps the fused-block generator (``kernels.fused_block.codegen``): a
claimed block becomes ONE Triton kernel over its canonical ``(R, C)``
domain, with contracted temporaries held in registers (plus a small
combine kernel for cross-program reductions).  ``claims`` is the
generator's DEL-insensitive analysis (``block_lower_reason``), so the
reason slugs in the fallback stats are exactly ``codegen.REASONS`` and the
claim matches what the ``gpu`` cost model priced during partitioning.

On CPU tensors the built function evaluates the block's plan with plain
torch ops; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .base import LoweringBackend, LoweringContext, codegen_lower_reason


class TritonBackend(LoweringBackend):
    name = "triton"

    def claims(self, ops: Sequence, plan, ctx: LoweringContext) -> Optional[str]:
        return codegen_lower_reason(ops, plan)

    def build(self, ops: Sequence, plan, ctx: LoweringContext):
        from ...kernels.fused_block.codegen import build_block_kernel
        fn, ins, outs = build_block_kernel(ops, seed=ctx.seed,
                                           device=ctx.device)
        assert tuple(ins) == plan.inputs and tuple(outs) == plan.outputs
        return fn
