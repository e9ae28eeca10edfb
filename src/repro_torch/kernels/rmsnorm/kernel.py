"""Fused residual-add + RMSNorm + scale in Triton — kernel B4, the Hopper
port of ``repro/kernels/rmsnorm/kernel.py:fused_add_rmsnorm``.

**What bounds it.**  One row reduction and one elementwise pass: a few
operations per element, far below the H100's operations-per-byte ratio,
so its least time is its bytes over the device-memory rate — ``x`` and
``residual`` read once, ``y`` and ``h`` written once, ``gamma`` read once.

**Design.**  One program owns ``BR`` whole rows, each held in one
``(BR, next_pow2(D))`` tile with the padded columns masked (the shape of
the row-replay kernel B2), so the sum of squares finishes in registers and
``h`` never makes a second trip through device memory.  ``h = x + r`` is
formed in float32 and stored once as the new residual; ``y`` is computed
from that float32 ``h``, not from ``h`` rounded to ``x.dtype`` (the two
differ in bfloat16).  ``plus_one`` scales by ``1 + gamma`` (gemma2).
Inputs are read through their row and column strides, so nothing is padded
or copied first (the TPU kernel padded the rows).  Launched with FMA
contraction off and libdevice's ``rsqrt``, as B2 is.

On CPU tensors :func:`fused_add_rmsnorm` runs the plain version
(``ref.py``); on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ...core.device import kernel_device
from ..fused_block.codegen import _load_module, _next_pow2
from .ref import reference_add_rmsnorm

TILE_ELEMS = 8192            # target elements of one (BR, BD) tile
MAX_ROW = 65536              # widest padded row one program holds

#: launches of the kernel (one per call on CUDA tensors); reset it to 0 to
#: count the launches of one run
LAUNCHES = {"rmsnorm": 0}

_SOURCE = '''
import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def add_rmsnorm_kernel(x_ptr, r_ptr, g_ptr, y_ptr, h_ptr, n_rows, d, d_f,
                       sx_row, sx_col, sr_row, sr_col, sg, eps,
                       PLUS_ONE: tl.constexpr, BR: tl.constexpr,
                       BD: tl.constexpr):
    rows = tl.program_id(0) * BR + tl.arange(0, BR)[:, None]
    cols = tl.arange(0, BD)[None, :]
    mask = (rows < n_rows) & (cols < d)
    rows = rows.to(tl.int64)
    x = tl.load(x_ptr + rows * sx_row + cols * sx_col, mask=mask, other=0.0)
    r = tl.load(r_ptr + rows * sr_row + cols * sr_col, mask=mask, other=0.0)
    h = x.to(tl.float32) + r.to(tl.float32)
    tl.store(h_ptr + rows * d + cols, h.to(h_ptr.dtype.element_ty), mask=mask)
    var = tl.div_rn(tl.sum(h * h, axis=1), d_f)
    inv = libdevice.rsqrt(var + eps)
    g = tl.load(g_ptr + cols * sg, mask=cols < d, other=0.0).to(tl.float32)
    if PLUS_ONE:
        g = g + 1.0
    y = h * inv[:, None] * g
    tl.store(y_ptr + rows * d + cols, y.to(y_ptr.dtype.element_ty), mask=mask)
'''


def fused_add_rmsnorm(x: torch.Tensor, residual: torch.Tensor,
                      gamma: torch.Tensor, *, eps: float = 1e-6,
                      plus_one: bool = False, block_rows: int = 128):
    """x, residual: ``(..., N, D)``; gamma: ``(D,)``.  Returns ``(y, h)``
    in ``x.dtype``: the normed rows and the new residual ``x + residual``.
    ``block_rows`` caps the rows one program owns."""
    if residual.shape != x.shape or gamma.shape != x.shape[-1:]:
        raise ValueError(f"shapes x {tuple(x.shape)}, residual "
                         f"{tuple(residual.shape)}, gamma {tuple(gamma.shape)}")
    device = kernel_device({"x": x, "residual": residual, "gamma": gamma},
                           "rmsnorm")
    if device is None:
        return reference_add_rmsnorm(x, residual, gamma, eps=eps,
                                     plus_one=plus_one)
    return _launch(x, residual, gamma, eps, plus_one, block_rows)


def _launch(x, residual, gamma, eps, plus_one, block_rows):
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            residual.dtype != x.dtype or gamma.dtype not in (torch.float32,
                                                              torch.bfloat16):
        raise TypeError(f"rmsnorm: the kernel takes float32 or bfloat16 x "
                        f"and residual of one dtype, got {x.dtype}, "
                        f"{residual.dtype}, gamma {gamma.dtype}")
    d = x.shape[-1]
    bd = _next_pow2(d)
    if bd > MAX_ROW or block_rows < 1:
        raise ValueError(f"rmsnorm: rows of {d} columns (at most {MAX_ROW}) "
                         f"and block_rows {block_rows} (at least 1)")
    # (rows, D) views: torch raises if the strides need a copy for that
    x2, r2 = x.view(-1, d), residual.view(-1, d)
    n = x2.shape[0]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    h = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if n == 0 or d == 0:
        return y, h
    br = max(1, min(_next_pow2(block_rows + 1) // 2, TILE_ELEMS // bd,
                    _next_pow2(n)))
    num_warps = min(16, max(4, br * bd // 1024))
    mod = _load_module(_SOURCE)
    with torch.cuda.device(x.device):
        mod.add_rmsnorm_kernel[(-(-n // br),)](
            x2, r2, gamma, y, h, n, d, float(d), x2.stride(0), x2.stride(1),
            r2.stride(0), r2.stride(1), gamma.stride(0), eps,
            PLUS_ONE=plus_one, BR=br, BD=bd, num_warps=num_warps,
            enable_fp_fusion=False)
    LAUNCHES["rmsnorm"] += 1
    return y, h
