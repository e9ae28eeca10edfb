"""Public claim-or-floor wrapper around the fused-block generator.

``fused_block_fn`` returns the generated kernel's executable when the
analysis claims the block, else the torch floor (``make_block_fn``) with
the decline slug — an explicit, reported choice, as the scheduler's lower
stage makes it.  A build or launch failure of a claimed block raises.  The
runtime dispatches through the ``triton`` backend instead; this facade is
the standalone entry point for tests and scripts."""

from __future__ import annotations

from typing import Sequence

from ...core.device import resolve_device
from ...core.executor import make_block_fn
from ...core.ir import Op
from .codegen import block_lower_reason, build_block_kernel


def fused_block_fn(ops: Sequence[Op], *, seed: int = 0, device=None):
    """Returns ``(fn, input_uids, output_uids, reason)``; ``fn(*bufs,
    salts)`` follows the ``make_block_fn`` calling convention either way,
    on ``device`` (the CUDA card unless given).
    ``reason`` is ``None`` when the generator claims the block, else its
    ``codegen.REASONS`` slug and ``fn`` is the torch floor."""
    device = resolve_device(device)
    reason = block_lower_reason(ops)
    if reason is None:
        fn, ins, outs = build_block_kernel(ops, seed=seed, device=device)
    else:
        fn, ins, outs = make_block_fn(ops, seed=seed, device=device)
    return fn, ins, outs, reason
