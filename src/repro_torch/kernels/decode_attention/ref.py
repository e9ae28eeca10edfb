"""Plain PyTorch version of decode attention: the direct model's one-token
attention step over its KV cache as ``models/layers.py:attention`` computed
it before the kernel (the port of the JAX package's decode branch of
``repro/models/layers.py:attention``), unchanged: both caches widened to
float32, the scores divided by ``sqrt(hd)`` with a correctly rounded
divide, soft-capped, masked by position, a shifted softmax over the whole
cache and its product with the values."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: shifted exponentials over
    their sum."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def valid_keys(idx: torch.Tensor, t: int, *, ring: bool,
               window: Optional[int]) -> torch.Tensor:
    """``(1, t)`` bools: the cache slots the token at ``idx`` attends to.
    A ring (a ``window``-deep local cache) holds exactly the last
    ``window`` positions once full: its filled slots.  A linear cache:
    positions up to ``idx``, and past ``idx - window`` where there is a
    window."""
    kpos = torch.arange(t, device=idx.device)[None, :]
    if ring:
        return kpos < torch.clamp(idx + 1, max=t)
    qpos = idx + torch.arange(1, device=idx.device)[:, None]
    mask = torch.ones((1, t), dtype=torch.bool, device=idx.device)
    mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def reference_decode_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, idx: torch.Tensor, *,
                               ring: bool = False,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None
                               ) -> torch.Tensor:
    """q ``(B, 1, H, hd)``; k, v ``(B, T, Hkv, hd)`` caches holding the
    token's own key and value at its slot; ``idx`` its position (a 0-d
    integer tensor).  Query head ``h`` reads KV head ``h // (H // Hkv)``.
    Returns ``(B, 1, H, hd)`` in ``q.dtype``."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    valid = valid_keys(idx, t, ring=ring, window=window)
    qg = q.transpose(1, 2).reshape(b, kvh, h // kvh, s, hd)
    # a correctly rounded divide, as jnp's (a CUDA divide by a host
    # scalar multiplies by its reciprocal), by a tensor filled on the
    # device (no host copy, so the step can be captured)
    sqrt_hd = torch.full((), math.sqrt(hd), dtype=torch.float32,
                         device=q.device)
    sc = torch.einsum("bkgqd,btkd->bkgqt", qg.to(torch.float32),
                      k.to(torch.float32)) / sqrt_hd
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    sc = torch.where(valid[None, None, None], sc, NEG_INF)
    o = torch.einsum("bkgqt,btkd->bkgqd", softmax(sc), v.to(torch.float32))
    return o.reshape(b, h, s, hd).transpose(1, 2).to(q.dtype)
