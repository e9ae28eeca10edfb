"""Facade with the reference's historical entry point (``repro/kernels/
fused_block/kernel.py``): ``build_fused_kernel`` with the salt-less calling
convention, over :func:`~repro_torch.kernels.fused_block.codegen
.build_block_kernel`."""

from __future__ import annotations

from typing import Sequence

from ...core.ir import Op
from .codegen import (FusedBlockUnsupported, block_lower_reason,  # noqa: F401
                      build_block_kernel)


def build_fused_kernel(ops: Sequence[Op], *, device=None):
    """Compile a WSP block into one generated kernel (legacy signature),
    on ``device`` (the CUDA card unless given).

    Returns ``(fn, input_uids, output_uids)`` with ``fn(*flat_bufs) ->
    tuple(flat_out_bufs)``.  Raises :class:`FusedBlockUnsupported` (with a
    ``reason`` slug) for blocks the generator cannot express."""
    fn, ins, outs = build_block_kernel(ops, device=device)

    def saltless(*bufs):
        return fn(*bufs, ())

    return saltless, ins, outs
