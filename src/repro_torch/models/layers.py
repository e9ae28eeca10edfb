"""Model building blocks — the subset of ``repro/models/layers.py`` that
the port's models run: RMSNorm, RoPE, causal multi-head attention with a KV
cache for prefill and decode, the SwiGLU MLP, and the RWKV6 mixer (token
shift, data-dependent decay, the recurrence through kernels B6/B7, per-head
group norm and gate) with its carried state.  Pure functions over
dictionaries of tensors, in the reference's layouts (``x`` is ``(B, S,
D)``, q/k/v ``(B, S, H, hd)``, caches ``(B, T, H, hd)``, RWKV states ``(B,
H, N, N)``), so the tests compare like with like.

No sliding window, ring buffer, softcap, qk-norm, bias, GQA, cross-attention,
MoE or Mamba: those configurations are refused before they get here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.rwkv6_scan import ops as rwkv_ops
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
        # the write index stays on the device (no host read), so a decode
        # step can be captured in a CUDA graph
        idx = cache["idx"]
        at = (idx + torch.arange(s, device=x.device)).long()
        ck = cache["k"].index_copy(1, at, k.to(cache["k"].dtype))
        cv = cache["v"].index_copy(1, at, v.to(cache["v"].dtype))
        new_cache = {"k": ck, "v": cv, "idx": cache["idx"] + s}
    if cache is None or s > 1:
        o = _dense_attn(q, k, v, causal=causal, scale=1.0 / math.sqrt(hd))
    else:
        t = ck.shape[1]
        valid = (torch.arange(t, device=x.device)[None, :]
                 <= idx + torch.arange(s, device=x.device)[:, None])
        qg = q.transpose(1, 2).reshape(b, kvh, h // kvh, s, hd)
        # a correctly rounded divide, as jnp's (a CUDA divide by a host
        # scalar multiplies by its reciprocal), by a tensor filled on the
        # device (no host copy, so the step can be captured in a CUDA graph)
        sqrt_hd = torch.full((), math.sqrt(hd), dtype=torch.float32,
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


# ---------------------------------------------------------------------------
# RWKV6 mixer (Finch: data-dependent per-channel decay)
# ---------------------------------------------------------------------------

def init_rwkv(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d = cfg.d_model
    n = cfg.rwkv.head_dim
    heads = d // n
    pd = getattr(torch, cfg.param_dtype)
    lora = max(32, d // 32)
    return {
        "mix": _init(gen, (5, d), pd, device, scale=0.02),   # r,k,v,w,g lerp
        "wr": _init(gen, (d, d), pd, device),
        "wk": _init(gen, (d, d), pd, device),
        "wv": _init(gen, (d, d), pd, device),
        "wg": _init(gen, (d, d), pd, device),
        "wo": _init(gen, (d, d), pd, device),
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "w_a": _init(gen, (d, lora), pd, device, scale=0.02),  # decay LoRA
        "w_b": _init(gen, (lora, d), pd, device, scale=0.02),
        "u": _init(gen, (heads, n), pd, device, scale=0.1),    # bonus
        "ln_g": torch.ones((d,), dtype=pd, device=device),
    }


def rwkv_mixer(p: Params, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[Dict] = None, in_place: bool = False):
    """Returns ``(out, new_state)``; ``state`` (prefill and decode) is
    ``{"last": (B, d), "wkv": (B, H, N, N)}``: the token before ``x`` (for
    the shift) and the float32 recurrence state.  With ``in_place`` (a
    decode token) kernel B6 writes the new wkv state into ``state["wkv"]``
    itself, and that is returned."""
    b, s, d = x.shape
    n = cfg.rwkv.head_dim
    heads = d // n
    if state is None:
        prev = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev = torch.cat([state["last"][:, None].to(x.dtype), x[:, :-1]],
                         dim=1)
    mix = torch.sigmoid(p["mix"].to(torch.float32))
    xm = [x * m + prev * (1 - m) for m in (mix[i].to(x.dtype)
                                           for i in range(5))]
    r = torch.einsum("bsd,de->bse", xm[0], p["wr"].to(x.dtype))
    k = torch.einsum("bsd,de->bse", xm[1], p["wk"].to(x.dtype))
    v = torch.einsum("bsd,de->bse", xm[2], p["wv"].to(x.dtype))
    # data-dependent decay (low-rank), in float32: (x w_a) w_b, the order
    # the reference's einsum contracts in
    lo = torch.einsum("bsd,dl->bsl", xm[3].to(torch.float32),
                      p["w_a"].to(torch.float32))
    wlog = p["w0"].to(torch.float32) + torch.einsum(
        "bsl,le->bse", lo, p["w_b"].to(torch.float32))
    w = torch.exp(-torch.exp(wlog))                     # (B,S,d) in (0,1)
    gl = torch.einsum("bsd,de->bse", xm[4], p["wg"].to(x.dtype))
    g = gl * torch.sigmoid(gl)

    def split(z):
        return z.reshape(b, s, heads, n).transpose(1, 2).reshape(
            b * heads, s, n)

    u = p["u"].to(torch.float32)
    wkv = None if state is None else state["wkv"]
    o, st = _rwkv_heads(split(r), split(k), split(v), split(w), u, b, heads,
                        state=wkv, return_state=state is not None,
                        out_state=wkv if in_place else None)
    new_state = None
    if state is not None:
        new_state = {"last": x[:, -1].to(state["last"].dtype), "wkv": st}
    o = o.reshape(b, heads, s, n).transpose(1, 2).reshape(b, s, d)
    # per-head group norm
    oh = o.reshape(b, s, heads, n).to(torch.float32)
    oh = oh * torch.rsqrt(torch.mean(oh * oh, dim=-1, keepdim=True) + 1e-6)
    o = (oh.reshape(b, s, d) * p["ln_g"].to(torch.float32)).to(x.dtype)
    out = torch.einsum("bsd,de->bse", o * g, p["wo"].to(x.dtype))
    return out, new_state


def _rwkv_heads(rh, kh, vh, wh, u, b, heads, state=None,
                return_state=False, out_state=None):
    """The RWKV6 recurrence over all ``B·H`` rows in ONE op call, row
    ``b·H + h`` taking the bonus ``u[h]``: a prompt or a whole sequence in
    chunks (kernel B7), one decode token (``S == 1``) as a step of the
    token recurrence (kernel B6).  ``state``: the initial ``(B, H, N, N)``
    wkv or None.  ``out_state`` (serving a decode token in place): a
    ``(B, H, N, N)`` float32 tensor, which may be ``state``, that B6
    writes the final state into.  Returns ``(o, final state as (B, H, N,
    N) or None)``."""
    s, n = rh.shape[1], rh.shape[2]
    s0 = None if state is None else state.reshape(b * heads, n, n)
    ins = (rh.contiguous(), kh.contiguous(), vh.contiguous(),
           wh.contiguous(), u)
    if out_state is not None:
        o, _ = rwkv_ops.rwkv6(*ins, state=s0,
                              out_state=out_state.reshape(b * heads, n, n))
        return o, out_state
    op = rwkv_ops.rwkv6 if s == 1 else rwkv_ops.rwkv6_chunked
    out = op(*ins, state=s0, return_state=return_state)
    if not return_state:
        return out, None
    o, st = out
    return o, st.reshape(b, heads, n, n)
