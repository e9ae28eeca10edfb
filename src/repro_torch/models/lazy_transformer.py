"""The transformer's forward/prefill/decode paths traced through the lazy
runtime — the port of ``repro/models/lazy_transformer.py``.

``LazyTransformer`` wraps a parameter tree (``models.transformer``'s
structure, torch tensors) and re-expresses each entry point as ONE lazy
tape: every call records the full step — embedding gather, per-layer
rmsnorm / attention / SwiGLU chains, final norm, unembed — and the terminal
``materialize`` flushes it through the whole pipeline (trace → graph →
partition → schedule → lower → execute).  Under the default
``backend="lm"`` stack the masked-softmax blocks lower through the
``flash_attention`` claimant and the rmsnorm scale blocks through the
``rmsnorm`` claimant, both onto the row-replay kernel (B2); the other
elementwise blocks go to the fused-block kernel (B1) and the matmuls and
the embedding gather to the torch floor.

The recording follows the reference's recipes, each of which fixes the
bits a block computes:

* the RoPE cos/sin tables are adopted constants, computed once per
  position set with torch in float32 on the runtime's device, the same
  way as the direct model (``layers.rope_tables``);
* the ``(1+g)`` norm scale is precomputed in float32 before adoption;
* scalar scales enter as Python float literals, which the executor rounds
  to the operand's float32 (jnp's weak typing); prefill MULTIPLIES scores
  by ``1/sqrt(hd)`` while decode DIVIDES by ``sqrt(hd)``, mirroring the two
  paths of ``layers.attention``;
* the masked-softmax ``-1e30`` fill is an adopted float32 array, never a
  Python scalar (``where`` would promote a scalar operand to float64);
* reduction results are consumed through
  ``r.reshape(..., 1).broadcast_to(domain)`` — the stride-0 form the
  row-replay kernel reads as a reduced column.

The results agree with the direct model within float32 rounding, not bit
for bit: the direct model's fused torch kernels (``mean``, ``softmax``-like
reductions, einsum) sum in other orders.

Supported configs are the dense decoder-only subset (all-attention layer
pattern, MHA, SwiGLU, float32, no qk-norm/bias/softcap, untied lm_head);
:func:`validate_config` raises for anything else rather than silently
diverging from the direct model.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import lazy as bh
from ..core.lazy import LazyArray, Runtime
from .config import ModelConfig
from .layers import rope_tables

Params = Dict[str, Any]


def validate_config(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``cfg`` is in the supported subset."""
    unit, _ = cfg.scan_groups()
    bad = [m for m, f in unit if m != "attn" or f != "mlp"]
    if bad:
        raise ValueError(f"lazy transformer supports attn+mlp layers only, "
                         f"pattern unit has {unit}")
    checks = [
        (cfg.n_kv_heads == cfg.n_heads, "GQA (n_kv_heads < n_heads)"),
        (cfg.act == "silu", f"act={cfg.act!r}"),
        (str(cfg.dtype) == "float32", f"dtype={cfg.dtype!r}"),
        (str(cfg.param_dtype) == "float32",
         f"param_dtype={cfg.param_dtype!r}"),
        (not cfg.qkv_bias, "qkv_bias"),
        (not cfg.qk_norm, "qk_norm"),
        (not cfg.attn_softcap, "attn_softcap"),
        (not cfg.final_softcap, "final_softcap"),
        (not cfg.tie_embeddings, "tie_embeddings"),
        (cfg.n_encoder_layers == 0, "encoder layers"),
        (cfg.moe is None, "moe"),
    ]
    for ok, what in checks:
        if not ok:
            raise ValueError(f"lazy transformer does not support {what}")


class LazyTransformer:
    """One model instance bound to one lazy :class:`Runtime`.

    Parameters are group-sliced out of the stacked ``params["groups"]``
    tree and adopted into the runtime ONCE at construction (device to
    device; adoption records no bytecode); every later ``forward`` /
    ``prefill`` / ``decode`` call traces pure compute.  KV caches live as
    runtime buffers across flushes — decode steps update them with window
    copies, the host tracks only the integer write index.

    Without a ``runtime`` one is made with ``backend="lm"`` on the CUDA card
    (``device="cpu"`` among ``runtime_kw`` runs it on the CPU).
    """

    def __init__(self, params: Params, cfg: ModelConfig, *,
                 runtime: Optional[Runtime] = None, **runtime_kw):
        validate_config(cfg)
        self.cfg = cfg
        if runtime is None:
            kw = dict(algorithm="greedy", cost_model="bohrium",
                      backend="lm", loop_fusion=False)
            kw.update(runtime_kw)
            runtime = Runtime(**kw)
        self.rt = runtime
        adopt = self.rt.adopt
        plus = 1.0 if cfg.norm_plus_one else 0.0

        def norm_g1(g: torch.Tensor) -> LazyArray:
            return adopt(g.to(torch.float32) + plus)

        self.embed = adopt(params["embed"])
        self.lm_head = adopt(params["lm_head"])
        self.final_g1 = norm_g1(params["final_norm"]["g"])
        unit, n_groups = cfg.scan_groups()
        self.layers: List[Dict[str, LazyArray]] = []
        for g in range(n_groups):
            for i in range(len(unit)):
                lp = params["groups"][f"l{i}"]
                mx, ffn = lp["mixer"], lp["ffn"]
                self.layers.append({
                    "norm1_g1": norm_g1(lp["norm1"]["g"][g]),
                    "norm2_g1": norm_g1(lp["norm2"]["g"][g]),
                    **{k: adopt(mx[k][g]) for k in ("wq", "wk", "wv", "wo")},
                    **{k: adopt(ffn[k][g])
                       for k in ("w_gate", "w_up", "w_down")},
                })
        # masked-softmax fill: an adopted f32 ARRAY — `where` with a Python
        # scalar operand would compute the result in float64
        self._neg = adopt(np.full((1, 1, 1, 1), -1e30, np.float32))
        self._rope_cache: Dict[Tuple, Tuple[LazyArray, LazyArray]] = {}
        self._mask_cache: Dict[Tuple, LazyArray] = {}
        #: per-layer (k, v) cache arrays after prefill, layer order
        self.caches: List[Tuple[LazyArray, LazyArray]] = []
        self._idx = 0                     # host-tracked decode position

    # -- adopted constants ------------------------------------------------

    def _rope_consts(self, positions: np.ndarray) -> Tuple[LazyArray, LazyArray]:
        """cos/sin tables shaped (1, s, 1, half) for (1, s) positions."""
        key = ("rope",) + tuple(int(p) for p in positions.ravel())
        hit = self._rope_cache.get(key)
        if hit is not None:
            return hit
        pos = torch.as_tensor(np.asarray(positions), device=self.rt.device)
        cos, sin = rope_tables(pos, self.cfg.hd // 2, self.cfg.rope_theta)
        consts = (self.rt.adopt(cos), self.rt.adopt(sin))
        self._rope_cache[key] = consts
        return consts

    def _causal_mask(self, s: int) -> LazyArray:
        key = ("causal", s)
        if key not in self._mask_cache:
            m = np.arange(s)[None, :] <= np.arange(s)[:, None]
            self._mask_cache[key] = self.rt.adopt(m.reshape(1, 1, s, s))
        return self._mask_cache[key]

    def _decode_mask(self, idx: int, tt: int) -> LazyArray:
        key = ("decode", idx, tt)
        if key not in self._mask_cache:
            m = np.arange(tt)[None, :] <= np.asarray([[idx]])
            self._mask_cache[key] = self.rt.adopt(m.reshape(1, 1, 1, tt))
        return self._mask_cache[key]

    # -- building blocks --------------------------------------------------

    def _proj(self, x: LazyArray, w: LazyArray) -> LazyArray:
        b, s, d = x.shape
        return bh.matmul(x.reshape(b * s, d), w).reshape(b, s, w.shape[1])

    def _rmsnorm(self, x: LazyArray, g1: LazyArray) -> LazyArray:
        b, s, d = x.shape
        var = (x * x).sum(axis=-1)                       # (b, s)
        var_b = var.reshape(b, s, 1).broadcast_to((b, s, d))
        inv = bh.rsqrt(var_b / float(d) + 1e-6)
        return x * inv * g1.reshape(1, 1, d).broadcast_to((b, s, d))

    def _rope(self, x: LazyArray, cos: LazyArray, sin: LazyArray) -> LazyArray:
        half = x.shape[-1] // 2
        tgt = x.shape[:-1] + (half,)
        x1, x2 = x[:, :, :, :half], x[:, :, :, half:]
        c, s_ = cos.broadcast_to(tgt), sin.broadcast_to(tgt)
        return bh.concatenate([x1 * c - x2 * s_, x2 * c + x1 * s_], axis=-1)

    def _softmax_rows(self, sc: LazyArray, mask: LazyArray) -> LazyArray:
        """where(mask, sc, -inf) -> max -> exp -> sum -> div over the last
        axis — the flash_attention claimant's blocks (with the scale op that
        fuses in front of them)."""
        b, h, s, t = sc.shape
        scm = bh.where(mask.broadcast_to(sc.shape), sc, self._neg)
        m = scm.max(axis=-1)
        e = bh.exp(scm - m.reshape(b, h, s, 1).broadcast_to(scm.shape))
        z = e.sum(axis=-1)
        return e / z.reshape(b, h, s, 1).broadcast_to(e.shape)

    def _qkv(self, lp, h: LazyArray, positions: np.ndarray):
        b, s, _ = h.shape
        nh, hd = self.cfg.n_heads, self.cfg.hd
        cos, sin = self._rope_consts(positions)
        q = self._proj(h, lp["wq"]).reshape(b, s, nh, hd)
        k = self._proj(h, lp["wk"]).reshape(b, s, nh, hd)
        v = self._proj(h, lp["wv"]).reshape(b, s, nh, hd)
        return self._rope(q, cos, sin), self._rope(k, cos, sin), v

    def _attn_out(self, lp, pr: LazyArray, v_t: LazyArray) -> LazyArray:
        b, nh = pr.shape[0], pr.shape[1]
        s, hd = pr.shape[2], v_t.shape[-1]
        o = bh.matmul(pr, v_t)                           # (b, nh, s, hd)
        o = o.transpose(0, 2, 1, 3).reshape(b, s, nh * hd)
        return self._proj(o, lp["wo"])

    def _attention_dense(self, lp, h: LazyArray, s: int) -> LazyArray:
        hd = self.cfg.hd
        q, k, v = self._qkv(lp, h, np.arange(s)[None])
        sc = bh.matmul(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 3, 1))
        pr = self._softmax_rows(sc * float(1.0 / math.sqrt(hd)),
                                self._causal_mask(s))
        return self._attn_out(lp, pr, v.transpose(0, 2, 1, 3))

    def _attention_prefill(self, lp, h: LazyArray, ck, cv):
        """Dense causal attention over the FRESH k/v (the cache write is
        pure data movement, exactly like ``layers.attention`` prefill)."""
        b, s, _ = h.shape
        hd = self.cfg.hd
        q, k, v = self._qkv(lp, h, np.arange(s)[None])
        ck[:, 0:s] = k
        cv[:, 0:s] = v
        sc = bh.matmul(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 3, 1))
        pr = self._softmax_rows(sc * float(1.0 / math.sqrt(hd)),
                                self._causal_mask(s))
        return self._attn_out(lp, pr, v.transpose(0, 2, 1, 3))

    def _attention_decode(self, lp, h: LazyArray, ck, cv, idx: int):
        """One-token attention over the whole cache, emptiness-masked by
        position (``layers.attention`` decode divides by sqrt(hd))."""
        hd = self.cfg.hd
        q, k, v = self._qkv(lp, h, np.asarray([[idx]]))
        ck[:, idx:idx + 1] = k
        cv[:, idx:idx + 1] = v
        tt = ck.shape[1]
        sc = bh.matmul(q.transpose(0, 2, 1, 3), ck.transpose(0, 2, 3, 1))
        pr = self._softmax_rows(sc / float(math.sqrt(hd)),
                                self._decode_mask(idx, tt))
        return self._attn_out(lp, pr, cv.transpose(0, 2, 1, 3))

    def _layer(self, lp, x: LazyArray, attend) -> LazyArray:
        h = self._rmsnorm(x, lp["norm1_g1"])
        x = x + attend(lp, h)
        h = self._rmsnorm(x, lp["norm2_g1"])
        t = self._proj(h, lp["w_gate"])
        u = self._proj(h, lp["w_up"])
        f = self._proj((t * bh.sigmoid(t)) * u, lp["w_down"])
        return x + f

    def _embed_tokens(self, tokens: np.ndarray) -> LazyArray:
        b, s = tokens.shape
        d = self.cfg.d_model
        idx = self.rt.adopt(np.asarray(tokens, np.int32).reshape(-1))
        x = bh.take(self.embed, idx, axis=0).reshape(b, s, d)
        if self.cfg.norm_plus_one:          # gemma convention
            x = x * float(math.sqrt(d))
        return x

    def _unembed(self, x: LazyArray) -> LazyArray:
        b, s, d = x.shape
        return bh.matmul(x.reshape(b * s, d), self.lm_head).reshape(b, s, -1)

    # -- entry points (one flush each) ------------------------------------

    def forward(self, tokens: np.ndarray) -> np.ndarray:
        """Training/eval logits ``(b, s, vocab)``."""
        tokens = np.asarray(tokens)
        with self.rt.activate():
            x = self._embed_tokens(tokens)
            s = tokens.shape[1]
            for lp in self.layers:
                x = self._layer(lp, x, lambda lp_, h: self._attention_dense(
                    lp_, h, s))
            x = self._rmsnorm(x, self.final_g1)
            return self._unembed(x).numpy()

    def prefill(self, tokens: np.ndarray, max_seq: int) -> np.ndarray:
        """Run the prompt; returns last-position logits (b, 1, vocab) and
        leaves per-layer KV caches live in the runtime (``self.caches``)."""
        tokens = np.asarray(tokens)
        b, s = tokens.shape
        kvh, hd = self.cfg.n_kv_heads, self.cfg.hd
        with self.rt.activate():
            x = self._embed_tokens(tokens)
            self.caches = []
            for lp in self.layers:
                ck, cv = (self.rt.adopt(torch.zeros(
                    (b, max_seq, kvh, hd), device=self.rt.device))
                    for _ in range(2))
                x = self._layer(
                    lp, x, lambda lp_, h, ck=ck, cv=cv:
                    self._attention_prefill(lp_, h, ck, cv))
                self.caches.append((ck, cv))
            x = self._rmsnorm(x, self.final_g1)
            last = x[:, s - 1:s]
            logits = self._unembed(last).numpy()
        self._idx = s
        return logits

    def decode(self, tokens: np.ndarray) -> np.ndarray:
        """One decode step for (b, 1) tokens after :meth:`prefill`; updates
        the caches, returns (b, 1, vocab) logits."""
        tokens = np.asarray(tokens)
        assert self.caches, "call prefill() before decode()"
        assert tokens.shape[1] == 1, tokens.shape
        idx = self._idx
        with self.rt.activate():
            x = self._embed_tokens(tokens)
            for lp, (ck, cv) in zip(self.layers, self.caches):
                x = self._layer(
                    lp, x, lambda lp_, h, ck=ck, cv=cv:
                    self._attention_decode(lp_, h, ck, cv, idx))
            x = self._rmsnorm(x, self.final_g1)
            logits = self._unembed(x).numpy()
        self._idx = idx + 1
        return logits

    def cache_numpy(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Materialize the per-layer (k, v) caches (test/debug helper)."""
        with self.rt.activate():
            return [(k.numpy(), v.numpy()) for k, v in self.caches]
