"""Flash attention in CUDA C++ — kernel B3, the Hopper port of
``repro/kernels/flash_attention/kernel.py:flash_attention``.

The kernel is ``src/repro_torch/csrc/flash_attention.cu`` (its header says
what bounds it and how it is laid out): FlashAttention-2's design on
Hopper's tensor cores (``mma.sync``; float32 in the 3xTF32 form, bfloat16
with P split into hi + lo), one block per (query head, batch, query tile)
looping over double-buffered ``cp.async`` key/value tiles, online softmax
in the float32 accumulators, GQA, causal and sliding-window masks and
logit soft-capping, ragged edges masked by index with no padding copies.
It is built by :mod:`..cuda_build` at first use.

It runs as the custom operator ``torch.ops.repro_torch.flash_attention``
(:func:`attention_op`), whose implementation the dispatcher picks by the
tensors' device: the kernel on CUDA tensors (it launches or raises), the
plain version (``ref.py``) on CPU tensors, and on fake or ``meta`` tensors
a fake one that makes the output's shape, dtype and strides and, on fake
CUDA tensors, refuses what the kernel refuses, so a trace of the card's
step passes through it (``launch/dryrun.py``).  Its operation count
(:func:`attention_ops`) is both its FLOP formula for
``torch.utils.flop_counter`` and the work ``chip_smoke.py``'s bound reads.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from ...core.device import op_device
from .. import cuda_build
from .ref import reference_attention

HEAD_DIMS = (32, 64, 128, 256)      # the head widths the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)

#: launches of the kernel (one per call on CUDA tensors); reset it to 0 to
#: count the launches of one run
LAUNCHES = {"flash_attention": 0}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: ``(B, Hq, Sq, D)``; k, v: ``(B, Hkv, Sk, D)`` with ``Hq % Hkv ==
    0``.  Returns ``(B, Hq, Sq, D)`` in ``q.dtype``.  The TPU kernel's
    ``block_q``/``block_k`` have no counterpart: the card's tiles follow
    from the dtype and ``D`` (64 or 128 queries by 32 or 64 keys)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[1] % k.shape[1]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    op_device({"q": q, "k": k, "v": v}, "flash_attention")
    return attention_op(q, k, v, bool(causal),
                        None if window is None else int(window),
                        None if softcap is None else float(softcap),
                        float(scale))


def _refuse(q, k, v, softcap) -> None:
    """Raise for what the kernel does not take (on the card and in a fake
    trace of it): inputs not contiguous or not of one dtype of
    :data:`DTYPES`, a head dim outside :data:`HEAD_DIMS`, no keys, a
    softcap that is not positive."""
    cuda_build.require({"q": q, "k": k, "v": v}, DTYPES, "flash_attention")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[3]} (the "
                         f"kernel is built for {HEAD_DIMS})")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: no keys")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap {softcap} (must be > 0)")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, window: Optional[int], softcap: Optional[float],
                 scale: float) -> torch.Tensor:
    """The operator; on CPU tensors the plain version."""
    return reference_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale).contiguous()


@attention_op.register_kernel("cuda")
def _launch(q, k, v, causal, window, softcap, scale):
    _refuse(q, k, v, softcap)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             "aligned (the kernel copies 16-byte pieces)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    cuda_build.launch(
        "repro_flash_attention_fwd", "ppppiiiiiiifiiiifp",
        [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
         cuda_build.DTYPE_CODES[q.dtype], b, hq, hkv, sq, sk, d, float(scale),
         int(bool(causal)), int(window is not None),
         0 if window is None else int(window), int(softcap is not None),
         0.0 if softcap is None else float(softcap)], q.device)
    LAUNCHES["flash_attention"] += 1
    return out


@attention_op.register_fake
def _fake(q, k, v, causal, window, softcap, scale):
    if q.device.type == "cuda":
        _refuse(q, k, v, softcap)
    return q.new_empty(q.shape)


def attention_pairs(sq: int, sk: int, causal: bool,
                    window: Optional[int]) -> int:
    """The (query, key) pairs the kernel computes for one (batch, head):
    each query's unmasked keys, or all ``sk`` keys for a query with none
    (the kernel visits every key there)."""
    qp = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk, qp + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, qp - window + 1) if window is not None else 0
    per_row = hi - lo
    return int(np.where(per_row > 0, per_row, sk).sum())


def attention_ops(q_shape, k_shape, causal: bool, window: Optional[int],
                  softcap: Optional[float]) -> dict:
    """The operations of one call: ``macs``, its 2·D multiply-adds per
    computed (query, key) pair (QKᵀ and PV, on the tensor cores), and
    ``float32``, the softmax's elementwise work per pair (max, subtract,
    exp, sum; the softcap's divide, tanh and multiply)."""
    b, hq, sq, d = q_shape
    pairs = attention_pairs(sq, k_shape[2], causal, window) * b * hq
    return {"macs": 2 * d * pairs,
            "float32": (4 + (3 if softcap is not None else 0)) * pairs}


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def attention_flops(q_shape, k_shape, v_shape, causal, window, softcap,
                    scale, *, out_shape=None, **kw) -> int:
    """FLOPs of one call: two a multiply-add (as ``FlopCounterMode`` counts
    a matmul's), one an elementwise operation."""
    ops = attention_ops(q_shape, k_shape, causal, window, softcap)
    return 2 * ops["macs"] + ops["float32"]
