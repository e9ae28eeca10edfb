"""Op-pattern matcher for the ``mamba_scan`` lowering claimant.

Recognizes the elementwise gate/decay chains a selective-scan layer
records around its recurrence — ``exp`` of the (negative) dt*A decay
times state plus input-gated update, optionally reduced over the state
axis for the output projection:

    exp (decay) -> mul (state carry) -> mul (dt*B*x update) -> add
        [-> reduce_sum (C contraction)]

Pure opcode screen; structural expressibility is the row-replay codegen's
job (see ``flash_attention.block`` for the split rationale).  Softmax
blocks are excluded by forbidding ``where``/``reduce_max`` (a masked
softmax always carries both), rmsnorm by forbidding ``rsqrt``, glu gates
by forbidding ``sigmoid``.

A copy of ``repro/kernels/mamba_scan/block.py``, so the port claims the
same blocks.
"""

from __future__ import annotations

from typing import Optional, Sequence

_ALLOWED = {"exp", "add", "sub", "mul", "div", "neg", "reduce_sum", "copy"}
_REQUIRED = {"exp", "add"}


def match(ops: Sequence) -> Optional[str]:
    """``None`` when the block is scan-shaped, else ``"no_scan"``."""
    work = [op.opcode for op in ops if not op.is_system()]
    seen = set(work)
    if not seen <= _ALLOWED:
        return "no_scan"
    if not _REQUIRED <= seen:
        return "no_scan"
    if work.count("mul") < 2:                  # decay*state AND gated update
        return "no_scan"
    if work.count("reduce_sum") > 1:
        return "no_scan"
    return None
