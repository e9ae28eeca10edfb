"""Model building blocks — the dense subset of ``repro/models/layers.py``
that the lazy LM lane admits (``lazy_transformer.validate_config``): RMSNorm,
RoPE, causal multi-head attention with a KV cache for prefill and decode,
and the SwiGLU MLP.  Pure functions over dictionaries of tensors, in the
reference's layouts (``x`` is ``(B, S, D)``, q/k/v ``(B, S, H, hd)``,
caches ``(B, T, H, hd)``), so the tests compare like with like.

No sliding window, ring buffer, softcap, qk-norm, bias, GQA or
cross-attention: those configurations are refused before they get here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .config import ModelConfig

Params = Dict[str, torch.Tensor]
NEG_INF = -1e30


def _init(gen: torch.Generator, shape, dtype: torch.dtype, device,
          scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * s).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype: torch.dtype, device) -> Params:
    return {"g": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, *, eps=1e-6,
            plus_one=True) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    g = p["g"].to(torch.float32) + (1.0 if plus_one else 0.0)
    return (xf * inv * g).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, half: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 cos/sin tables ``(..., 1, half)`` for ``positions`` (``(B, S)``
    or ``(S,)``), on the positions' device — shared by the direct model and
    the lazy transformer's adopted constants."""
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    cos, sin = rope_tables(positions, half, theta)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pd = getattr(torch, cfg.param_dtype)
    return {
        "wq": _init(gen, (d, h * hd), pd, device),
        "wk": _init(gen, (d, kv * hd), pd, device),
        "wv": _init(gen, (d, kv * hd), pd, device),
        "wo": _init(gen, (h * hd, d), pd, device),
    }


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: shifted exponentials over
    their sum."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _dense_attn(q, k, v, *, causal: bool, scale: float) -> torch.Tensor:
    """Plain masked attention over (B, S, H, hd) q and (B, T, H, hd) k/v."""
    s, t = q.shape[1], k.shape[1]
    sc = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                      k.to(torch.float32)) * scale
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        pos = torch.arange(max(s, t), device=q.device)
        mask &= pos[None, :t] <= pos[:s, None]
    sc = torch.where(mask[None, None], sc, NEG_INF)
    o = torch.einsum("bhst,bthd->bshd", _softmax(sc), v.to(torch.float32))
    return o.to(q.dtype)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[Dict] = None, causal: bool = True):
    """Returns ``(out, new_cache)``.  ``cache = {"k", "v", "idx"}`` writes
    the fresh k/v at ``idx``: a prompt (``s > 1``, ``idx == 0``) attends over
    its own k/v, one token attends over the whole cache, masked by
    position."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = torch.einsum("bsd,dh->bsh", x, p["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = torch.einsum("bsd,dh->bsh", x, p["wk"].to(x.dtype)).reshape(b, s, kvh, hd)
    v = torch.einsum("bsd,dh->bsh", x, p["wv"].to(x.dtype)).reshape(b, s, kvh, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        idx = int(cache["idx"])
        ck, cv = cache["k"].clone(), cache["v"].clone()
        ck[:, idx:idx + s] = k.to(ck.dtype)
        cv[:, idx:idx + s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "idx": cache["idx"] + s}
    if cache is None or s > 1:
        o = _dense_attn(q, k, v, causal=causal, scale=1.0 / math.sqrt(hd))
    else:
        t = ck.shape[1]
        valid = (torch.arange(t, device=x.device)[None, :]
                 <= idx + torch.arange(s, device=x.device)[:, None])
        qg = q.transpose(1, 2).reshape(b, kvh, h // kvh, s, hd)
        # a correctly rounded divide, as jnp's (a CUDA divide by a host
        # scalar multiplies by its reciprocal)
        sqrt_hd = torch.tensor(math.sqrt(hd), dtype=torch.float32,
                               device=x.device)
        sc = torch.einsum("bkgqd,btkd->bkgqt", qg.to(torch.float32),
                          ck.to(torch.float32)) / sqrt_hd
        sc = torch.where(valid[None, None, None], sc, NEG_INF)
        o = torch.einsum("bkgqt,btkd->bkgqd", _softmax(sc),
                         cv.to(torch.float32))
        o = o.reshape(b, h, s, hd).transpose(1, 2).to(x.dtype)
    out = torch.einsum("bsh,hd->bsd", o.reshape(b, s, h * hd),
                       p["wo"].to(x.dtype))
    return out, new_cache


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    pd = getattr(torch, cfg.param_dtype)
    return {"w_gate": _init(gen, (d, f), pd, device),
            "w_up": _init(gen, (d, f), pd, device),
            "w_down": _init(gen, (f, d), pd, device)}


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    t = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
    return torch.einsum("bsf,fd->bsd", t * torch.sigmoid(t) * u,
                        p["w_down"].to(x.dtype))
