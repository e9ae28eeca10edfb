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

On CPU tensors :func:`flash_attention` runs the plain version
(``ref.py``); on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...core.device import kernel_device
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
    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    ins = {"q": q, "k": k, "v": v}
    device = kernel_device(ins, "flash_attention")
    if device is None:
        return reference_attention(q, k, v, **opts)
    cuda_build.require(ins, DTYPES, "flash_attention")
    return _launch(q, k, v, device, **opts)


def _launch(q, k, v, device, *, causal, window, softcap, scale):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} (the kernel is "
                         f"built for {HEAD_DIMS})")
    if sk == 0:
        raise ValueError("flash_attention: no keys")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap {softcap} (must be > 0)")
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
         0.0 if softcap is None else float(softcap)], device)
    LAUNCHES["flash_attention"] += 1
    return out
