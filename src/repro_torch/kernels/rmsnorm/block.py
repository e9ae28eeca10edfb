"""Op-pattern matcher for the ``rmsnorm`` lowering claimant.

Recognizes the rmsnorm scale chain the lazy transformer records.  The WSP
fuse rule ends a block at a reduction (its output is consumed through a
broadcast view), so a full rmsnorm partitions into a variance block and
the normalize block:

    [add (residual)] -> mul (x*x) -> reduce_sum        [generic sum block]
    div (mean) -> add (eps) -> rsqrt -> mul -> mul     [claimed here]

The claim anchors on ``rsqrt`` — the one opcode that is unmistakably a
normalization — so plain sum-of-squares blocks (which any tape can
contain) stay with the generic backends and claimant stats attribute only
real norm work.

Pure opcode screen; structural expressibility is the row-replay codegen's
job (see ``flash_attention.block`` for the split rationale).  ``exp`` /
``where`` / ``reduce_max`` / ``sigmoid`` are rejected so softmax, scan
and glu blocks never land here — preference order between claimants then
never decides correctness, only stats attribution.

A copy of ``repro/kernels/rmsnorm/block.py``, so the port claims the
same blocks.
"""

from __future__ import annotations

from typing import Optional, Sequence

_ALLOWED = {"add", "sub", "mul", "div", "rsqrt", "sqrt", "square",
            "reciprocal", "reduce_sum", "copy"}
_REQUIRED = {"rsqrt", "mul"}


def match(ops: Sequence) -> Optional[str]:
    """``None`` when the block is rmsnorm-shaped, else ``"no_rmsnorm"``."""
    seen = {op.opcode for op in ops if not op.is_system()}
    if not seen <= _ALLOWED:
        return "no_rmsnorm"
    if not _REQUIRED <= seen:
        return "no_rmsnorm"
    return None
