"""Hand-written-kernel lowering claimants for LM blocks — the port of
``repro/core/backends/lm.py``.

Three backends — ``flash_attention``, ``rmsnorm``, ``mamba_scan`` — each
*claim* a fusion block when (a) its op-pattern matcher
(``kernels.<name>.block.match``) recognizes the block's opcode shape and
(b) the row-replay generator (``kernels.fused_block.rowblock``, kernel B2)
can express it as one row-tiled Triton kernel.  Blocks outside the pattern
decline with the matcher's slug (``no_softmax`` / ``no_rmsnorm`` /
``no_scan``); pattern-shaped blocks the generator cannot express decline
with its reason, so fallback stats separate "not mine" from "mine but
inexpressible".

Selection takes the first claimant in preference order
(``backends.base.select_lowering``).  The reference prices claimants per
dispatch; every claimant here costs one dispatch, as does the generic
``triton`` backend when it also claims, so the reference's tie-break by
preference order gives the same choice: a matched block always runs the
row-replay kernel.

On CPU tensors the built function runs the kernel's plain version (the
floor's torch ops at domain shape); on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

from .base import LoweringBackend, LoweringContext

_ROW_MEMO: "OrderedDict[Tuple, Optional[str]]" = OrderedDict()
_ROW_MEMO_CAP = 4096


def rowblock_lower_reason(ops: Sequence, plan) -> Optional[str]:
    """Memoized row-replay expressibility, keyed like
    :func:`repro_torch.core.backends.base.codegen_lower_reason` on the plan's
    structural signature — all three claimants consult it during one
    selection, so the second and third lookups are free."""
    key = getattr(plan, "signature", None)
    if key is not None and key in _ROW_MEMO:
        _ROW_MEMO.move_to_end(key)
        return _ROW_MEMO[key]
    from ...kernels.fused_block.rowblock import rowblock_lower_reason as raw
    reason = raw(ops)
    if key is not None:
        _ROW_MEMO[key] = reason
        if len(_ROW_MEMO) > _ROW_MEMO_CAP:
            _ROW_MEMO.popitem(last=False)
    return reason


class _RowKernelBackend(LoweringBackend):
    """Shared machinery: matcher screen, then row-replay claim + build."""

    def _match(self, ops: Sequence) -> Optional[str]:
        raise NotImplementedError

    def claims(self, ops: Sequence, plan, ctx: LoweringContext) -> Optional[str]:
        reason = self._match(ops)
        if reason is not None:
            return reason
        return rowblock_lower_reason(ops, plan)

    def build(self, ops: Sequence, plan, ctx: LoweringContext):
        from ...kernels.fused_block.rowblock import build_rowblock_kernel
        fn, ins, outs = build_rowblock_kernel(ops, seed=ctx.seed,
                                              device=ctx.device)
        assert tuple(ins) == plan.inputs and tuple(outs) == plan.outputs
        return fn


class FlashAttentionBackend(_RowKernelBackend):
    name = "flash_attention"

    def _match(self, ops: Sequence) -> Optional[str]:
        from ...kernels.flash_attention.block import match
        return match(ops)


class RMSNormBackend(_RowKernelBackend):
    name = "rmsnorm"

    def _match(self, ops: Sequence) -> Optional[str]:
        from ...kernels.rmsnorm.block import match
        return match(ops)


class MambaScanBackend(_RowKernelBackend):
    name = "mamba_scan"

    def _match(self, ops: Sequence) -> Optional[str]:
        from ...kernels.mamba_scan.block import match
        return match(ops)


#: preference order of the ``backend="lm"`` stack: specific claimants
#: first (most selective matcher wins ties), generic codegen, torch floor
LM_STACK: Tuple[str, ...] = ("flash_attention", "rmsnorm", "mamba_scan",
                             "triton", "torch")
