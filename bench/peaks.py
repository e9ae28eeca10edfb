"""The H100's peaks and the least-time arithmetic: frozen copies of
``chip_smoke.py``'s constants (NVIDIA's data sheet, SXM part, dense rates
at 700 W) and of its ``_bound``.  A multiply-add counts as two FLOPs
against :data:`BF16_FLOPS`; elementwise float32 work and exponentials on
the CUDA cores count one operation a lane and cycle, as chip_smoke's
kernels launch with FMA contraction off."""

from __future__ import annotations

#: bf16 tensor-core rate, FLOP/s (a multiply-add is two)
BF16_FLOPS = 989e12
#: device-memory rate, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: float32 operations a second on the CUDA cores (one a lane a cycle)
F32_OPS_PER_S = 33.5e12
#: special-function results (MUFU ex2) a second: 16 a clock an SM, 132 SMs
#: at 1.98 GHz
SFU_OPS_PER_S = 132 * 16 * 1.98e9
#: float32 operations of an exponential computed on the FMA pipe instead
EXP2_FMA_OPS = 7


def least_seconds(*, flops: float = 0.0, nbytes: float = 0.0,
                  f32_ops: float = 0.0, exps: float = 0.0) -> float:
    """The least time of a piece of work on one H100: the larger of its
    tensor-core FLOPs over :data:`BF16_FLOPS`, its bytes over
    :data:`HBM_BYTES_PER_S` and its CUDA-core work; exponentials split at
    best between the SFU and the FMA pipe beside the float32 operations
    (chip_smoke's ``_bound``)."""
    times = [flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S,
             f32_ops / F32_OPS_PER_S]
    if exps:
        times.append((f32_ops + EXP2_FMA_OPS * exps)
                     / (F32_OPS_PER_S + EXP2_FMA_OPS * SFU_OPS_PER_S))
    return max(times)
