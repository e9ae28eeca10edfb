"""The ``torch`` lowering backend — the always-available floor (the port's
counterpart of the reference's ``xla`` backend).

Wraps ``executor.make_block_fn``: one PyTorch call per op of the block,
with every view lowered to a reshape/slice, a strided view or an index
gather.  It claims every block, so it is the terminal fallback of every
policy.

A block the Triton generator cannot express as ONE kernel runs here; the
``gpu`` cost model prices such a block at 2 dispatches
(``cost._KernelAlignment``, the reference's rule for its XLA floor).
"""

from __future__ import annotations

from typing import Optional, Sequence

from .base import LoweringBackend, LoweringContext


class TorchFloorBackend(LoweringBackend):
    name = "torch"

    def claims(self, ops: Sequence, plan, ctx: LoweringContext) -> Optional[str]:
        return None                      # the floor expresses every block

    def build(self, ops: Sequence, plan, ctx: LoweringContext):
        from ..executor import make_block_fn
        fn, ins, outs = make_block_fn(ops, seed=ctx.seed, device=ctx.device)
        assert tuple(ins) == plan.inputs and tuple(outs) == plan.outputs
        return fn
