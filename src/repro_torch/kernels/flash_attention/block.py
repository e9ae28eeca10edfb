"""Op-pattern matcher for the ``flash_attention`` lowering claimant.

Recognizes the masked-softmax blocks the lazy transformer's attention
records between the score and PV matmuls.  Matmuls are opaque singleton
blocks and the WSP fuse rule ends a block at a reduction (a reduction's
output is consumed through a broadcast view, i.e. under a different
iteration domain), so the softmax chain partitions into exactly two
claimable reduction blocks plus a trailing normalize:

    scale (mul|div) -> where(mask, sc, -inf) -> reduce_max   [block A]
    sub -> exp -> reduce_sum                                 [block B]
    div                                                      [left generic]

The matcher claims A (``where`` + ``reduce_max``) and B (``sub`` +
``exp`` + ``reduce_sum``); the single-op ``div`` carries no attention
signature and stays with the generic backends.

The matcher is a pure opcode screen — cheap enough to run on every block
during the lower stage.  Structural expressibility (domains, views,
trailing-axis reductions) is checked afterwards by the row-replay
codegen's analysis (``rowblock_lower_reason``); this screen only answers
"does this block LOOK like part of a masked softmax?", so the backend's
decline stats separate "not my pattern" (``no_softmax``) from "my pattern
but not expressible" (a ``codegen.REASONS`` slug).

The claimant lowers through the row-replay generator
(``kernels/fused_block/rowblock.py``), never through a flash-attention
body: the claim boundary — which blocks this backend owns — is what this
module defines.  A copy of ``repro/kernels/flash_attention/block.py``, so
the port claims the same blocks.
"""

from __future__ import annotations

from typing import Optional, Sequence

#: every opcode the softmax pieces may contain (scale + mask + the
#: max/exp/sum chain, plus copies the frontend may interleave)
_ALLOWED = {"mul", "div", "where", "sub", "add", "neg", "exp",
            "reduce_max", "reduce_sum", "copy", "maximum"}
#: block A: masked running-max over scores
_MASKED_MAX = {"where", "reduce_max"}
#: block B: SHIFTED exponentials (the max subtraction is required — a bare
#: exp+sum is a scan shape, which belongs to ``mamba_scan``) + normalizer
_EXP_SUM = {"sub", "exp", "reduce_sum"}


def match(ops: Sequence) -> Optional[str]:
    """``None`` when the block is softmax-shaped, else ``"no_softmax"``."""
    seen = {op.opcode for op in ops if not op.is_system()}
    if not seen <= _ALLOWED:
        return "no_softmax"
    if not (_MASKED_MAX <= seen or _EXP_SUM <= seen):
        return "no_softmax"
    return None
