"""Plain-torch oracle for the fused-block kernel: execute the block's ops
one by one, materializing every intermediate at full base size (NO fusion,
NO contraction) — the ⊥ partition's execution, for whole-base elementwise
blocks (the port's copy of ``repro/kernels/fused_block/ref.py``)."""

from __future__ import annotations

from typing import Dict

import torch

from ...core.device import resolve_device
from ...core.executor import apply_op, block_io, torch_dtype
from ...core.ir import View


def reference_block(ops, *bufs, device=None):
    """Execute a block unfused; returns the same outputs as the kernel, on
    ``device`` (by default its buffers' device, else the CUDA card)."""
    if device is None:
        device = bufs[0].device if bufs else resolve_device()
    work = [op for op in ops if not op.is_system()]
    inputs, outputs, _ = block_io(ops)
    env: Dict[int, torch.Tensor] = dict(zip(inputs, bufs))
    meta = {}
    for op in work:
        for v in (*op.in_views(), *op.out_views()):
            meta[v.base.uid] = (v.base.size, v.base.dtype)
    for u, (size, dt) in meta.items():
        if u not in env:
            env[u] = torch.zeros(size, dtype=torch_dtype(dt), device=device)
    for op in work:
        vals = [env[v.base.uid] if isinstance(v, View) else v
                for v in op.inputs]
        out = apply_op(op.opcode, vals)
        size, dt = meta[op.out.base.uid]
        env[op.out.base.uid] = torch.broadcast_to(
            out.to(device=device, dtype=torch_dtype(dt)), (size,)).reshape(-1)
    return tuple(env[u] for u in outputs)
