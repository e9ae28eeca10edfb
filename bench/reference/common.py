"""The plain float32 forward pass that the per-configuration references
(``reference/<config>.py``) share: a decoder of attention or Mamba mixers,
each followed by a SwiGLU MLP or a top-k MoE layer, in plain PyTorch.  It
imports nothing of the program under test and takes only what the
benchmark made: the weights it drew (bf16 tensors, widened here) and the
token rows it served.

It follows the port's semantics where they depart from the published
models (each configuration file lists its departures): capacity-limited
top-k routing with renormalised gates in groups of the prompt, RMSNorm
with eps 1e-6, RoPE on attention, no padding mask.  It runs the sampled
requests together (they have one length) over their whole sequences (the
padded prompt and the served tokens), layer by layer, so the KV caches
and the Mamba state the program carries are worked out again as a causal
pass.

Every product goes through a :class:`Precision`: :data:`FLOAT32` computes
in float32 with TF32 off; :data:`FP8` rounds both operands of every
product to float8 e4m3 (a per-tensor scale) first: the control that has
to fail the comparison."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

#: the port's RMSNorm eps (``models/layers.py:rmsnorm``'s default)
RMS_EPS = 1e-6
#: the port's MoE capacity factor and routing group (``models/config.py``,
#: ``models/layers.py:MOE_GROUP_TOKENS``)
CAPACITY_FACTOR = 1.25
GROUP_TOKENS = 512
#: elements of the (K, H, block, T) score tensor of one attention block
ATTN_BLOCK_ELEMENTS = 1 << 29
#: tokens a scan chunk, whose decays and inputs are made at once
SCAN_CHUNK = 64


class Precision:
    """How a product's operands are rounded before a float32 product."""

    name = "float32"

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float32)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)

    def einsum(self, eq: str, *ops) -> torch.Tensor:
        return torch.einsum(eq, *(self.round(o) for o in ops))


class Fp8(Precision):
    """Each operand scaled by its largest magnitude to float8 e4m3's range,
    rounded there and scaled back: an fp8 product in float32 arithmetic."""

    name = "float8_e4m3"
    MAX = 448.0

    def round(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        scale = x.abs().amax().clamp_min(1e-30) / self.MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


FLOAT32 = Precision()
FP8 = Fp8()


@dataclass(frozen=True)
class Spec:
    """A configuration's widths and layer kinds, read from its published
    keys by its reference file."""
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    kinds: Tuple[Tuple[str, str], ...]          # (mixer, ffn) per layer
    d_ff: int = 0
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    rope_theta: float = 10000.0
    mamba: Optional[dict] = field(default=None)  # d_state, d_conv, expand, dt_rank


def set_float32_products() -> None:
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rmsnorm(x, g):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + RMS_EPS) \
        * g.to(torch.float32)


def silu(x):
    return x * torch.sigmoid(x)


def rope(x, pos, theta):
    """x: (T, H, D), the halves rotated (the port's ``layers.rope``)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos[:, None].to(torch.float32) * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(w, h, sp: Spec, prec: Precision):
    """Causal grouped-query attention with RoPE over the whole sequences:
    ``h`` is ``(K, T, d)``."""
    kk, t = h.shape[:2]
    hq, kv, hd = sp.n_heads, sp.n_kv_heads, sp.head_dim
    pos = torch.arange(t, device=h.device)
    q = rope(prec.mm(h, w["wq"]).view(kk, t, hq, hd), pos, sp.rope_theta)
    k = rope(prec.mm(h, w["wk"]).view(kk, t, kv, hd), pos, sp.rope_theta)
    v = prec.mm(h, w["wv"]).view(kk, t, kv, hd)
    k = k.repeat_interleave(hq // kv, dim=2)
    v = v.repeat_interleave(hq // kv, dim=2)
    out = torch.empty((kk, t, hq, hd), dtype=torch.float32, device=h.device)
    block = max(1, ATTN_BLOCK_ELEMENTS // (kk * hq * t))
    for s in range(0, t, block):
        e = min(t, s + block)
        sc = prec.einsum("bqhd,bkhd->bhqk", q[:, s:e], k[:, :e]) \
            / math.sqrt(hd)
        qpos = torch.arange(s, e, device=h.device)[:, None]
        mask = torch.arange(e, device=h.device)[None, :] <= qpos
        p = torch.softmax(torch.where(mask, sc, -math.inf), dim=-1)
        out[:, s:e] = prec.einsum("bhqk,bkhd->bqhd", p, v[:, :e])
    return prec.mm(out.reshape(kk, t, hq * hd), w["wo"])


def mlp(w, h, prec: Precision):
    return prec.mm(silu(prec.mm(h, w["w_gate"])) * prec.mm(h, w["w_up"]),
                   w["w_down"])


def moe(w, h, sp: Spec, prec: Precision, prompt_len: int, routes=None):
    """Top-k routing in float32 with renormalised gates; each row's prompt
    routes in groups of ``min(prompt_len, 512)`` tokens where each expert
    keeps its first ``int(1.25 · group · k / e) + 1`` tokens in token order
    and drops the rest; every later (decode) token routes alone, so none
    drops.  ``h`` is ``(K, T, d)``; ``routes``, where given, gets the
    ``(K, T, k)`` experts each token chose."""
    kk, t, d = h.shape
    e, k = sp.n_experts, sp.top_k
    probs = torch.softmax(prec.mm(h, w["router"]), dim=-1)
    gv, idx = torch.topk(probs, k, dim=-1)
    if routes is not None:
        routes.append(idx)
    gv = gv / gv.sum(-1, keepdim=True).clamp_min(1e-9)
    chosen = torch.zeros((kk, t, e), device=h.device).scatter_(2, idx, 1.0)
    gate = torch.zeros((kk, t, e), device=h.device).scatter_(2, idx, gv)
    keep = chosen.clone()
    s = prompt_len
    s_g = min(s, GROUP_TOKENS)
    cap = int(CAPACITY_FACTOR * s_g * k / e) + 1
    c = chosen[:, :s].reshape(kk, s // s_g, s_g, e)
    pos = torch.cumsum(c, dim=2) - c
    keep[:, :s] = (c * (pos < cap)).reshape(kk, s, e)
    hf, keep, gate = h.reshape(kk * t, d), keep.reshape(-1, e), \
        gate.reshape(-1, e)
    y = torch.zeros_like(hf)
    for j in range(e):
        rows = torch.nonzero(keep[:, j]).flatten()
        if rows.numel() == 0:
            continue
        x = hf[rows]
        a = silu(prec.mm(x, w["w_gate"][j])) * prec.mm(x, w["w_up"][j])
        y[rows] += gate[rows, j, None] * prec.mm(a, w["w_down"][j])
    return y.reshape(kk, t, d)


def scan(x, dt, b, c, a, d):
    """The selective scan over whole sequences from a zero state: ``h_t =
    exp(dt_t · a) ⊙ h_{t-1} + (dt_t x_t) ⊗ B_t``, ``y_t = h_t C_t + d ⊙
    x_t``; x, dt ``(K, T, d_inner)``, b, c ``(K, T, d_state)``, a
    ``(d_inner, d_state)``.  Token by token, the decays and inputs of
    :data:`SCAN_CHUNK` tokens made at once."""
    kk, t, di = x.shape
    h = torch.zeros((kk, di, b.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for s in range(0, t, SCAN_CHUNK):
        e = min(t, s + SCAN_CHUNK)
        decay = torch.exp(dt[:, s:e, :, None] * a)               # (K, L, di, n)
        u = (dt[:, s:e] * x[:, s:e])[..., None] * b[:, s:e, None, :]
        hs = torch.empty_like(u)
        for i in range(e - s):
            h = torch.addcmul(u[:, i], decay[:, i], h, out=hs[:, i])
        ys.append(torch.einsum("bldn,bln->bld", hs, c[:, s:e])
                  + d * x[:, s:e])
    return torch.cat(ys, dim=1)


def mamba(w, h, sp: Spec, prec: Precision):
    """The Mamba mixer of the port (``layers.mamba_mixer``): in_proj, the
    causal depthwise conv from zero inputs, SiLU, x_proj to dt, B and C,
    dt through dt_proj and softplus, the scan, the SiLU gate, out_proj.
    ``h`` is ``(K, T, d)``."""
    m = sp.mamba
    kk, t = h.shape[:2]
    di = m["expand"] * sp.d_model
    dtr, n, kc = m["dt_rank"], m["d_state"], m["d_conv"]
    xz = prec.mm(h, w["in_proj"])
    xi, z = xz[..., :di], xz[..., di:]
    xpad = torch.cat([torch.zeros((kk, kc - 1, di), device=h.device), xi],
                     dim=1)
    cw = w["conv_w"].to(torch.float32)
    conv = w["conv_b"].to(torch.float32) + sum(
        xpad[:, i:i + t] * cw[i] for i in range(kc))
    xc = silu(conv)
    proj = prec.mm(xc, w["x_proj"])
    pre = prec.mm(proj[..., :dtr], w["dt_proj"]) \
        + w["dt_bias"].to(torch.float32)
    dt = torch.logaddexp(pre, torch.zeros_like(pre))
    y = scan(xc, dt, proj[..., dtr:dtr + n], proj[..., dtr + n:],
             -torch.exp(w["a_log"].to(torch.float32)),
             w["d"].to(torch.float32))
    return prec.mm(y * silu(z), w["out_proj"])


def logits_at(sp: Spec, weights: dict, tokens: torch.Tensor, prompt_len: int,
              at: List[int], prec: Precision = FLOAT32,
              routes: Optional[list] = None) -> torch.Tensor:
    """``(K, len(at), vocab)`` float32 logits at positions ``at`` of ``K``
    requests' sequences ``tokens`` ``(K, T)`` (each its padded prompt of
    ``prompt_len`` tokens, then its served tokens): ``weights`` holds
    ``embed``, ``final_norm``, ``lm_head`` and ``layers``, one dict a
    layer.  ``routes``, where given, gets each MoE layer's ``(K, T, k)``
    chosen experts, in layer order."""
    x = weights["embed"][tokens.long()].to(torch.float32)
    for lw, (mixer, ffn) in zip(weights["layers"], sp.kinds):
        h = rmsnorm(x, lw["norm1"]["g"])
        x = x + (attention(lw["mixer"], h, sp, prec) if mixer == "attention"
                 else mamba(lw["mixer"], h, sp, prec))
        h = rmsnorm(x, lw["norm2"]["g"])
        x = x + (moe(lw["ffn"], h, sp, prec, prompt_len, routes)
                 if ffn == "moe"
                 else mlp(lw["ffn"], h, prec))
    x = rmsnorm(x[:, torch.as_tensor(at, dtype=torch.long, device=x.device)],
                weights["final_norm"]["g"])
    return prec.mm(x, weights["lm_head"])
