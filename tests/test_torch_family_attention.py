"""Attention, feature by feature, against the JAX package on the CPU:
``models.layers.attention`` against ``repro.models.layers.attention`` for
QKV bias, qk-norm, GQA, MHA, logit softcap, sliding windows (a prompt
below, at and above the window into a ring-buffer cache, decode steps
over more than the window, a cache shorter than the window) and
cross-attention; ``_chunked_attn`` and ``_dense_attn`` against the
reference's, and kernel B3's plain version against both; the GeGLU MLP.
The inputs come from ``np.random.default_rng``, the weights are the JAX
package's own, with its zero-initialised biases and gains drawn
(``test_torch_families._draw``).  Tolerances as in
``tests/test_torch_families.py``: 1e-4 of the largest magnitude in
float32 (measured at most 1.1e-6), 0.1 in bfloat16 (measured at most
0.015); the attention forms alone, in float32, 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models.config import ModelConfig as RefConfig

from repro_torch.kernels.flash_attention.ref import reference_attention
from repro_torch.models import layers as PL
from test_torch_families import DTYPES, F32, TOL, _draw, _np, _rel
from test_torch_lm import to_port_config


# ---------------------------------------------------------------------------
# attention, feature by feature
# ---------------------------------------------------------------------------

_ATTN_BASE = RefConfig(name="attn_tiny", family="dense", n_layers=1,
                       d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                       d_ff=64, vocab_size=32, remat=False)
#: feature -> (config changes, local, prompt length, cache depth, decode
#: steps, cross-attention source length)
_FEATURES = {
    "bias": (dict(qkv_bias=True), False, 12, 24, 4, None),
    "qk_norm": (dict(qk_norm=True), False, 12, 24, 4, None),
    "gqa4": (dict(n_kv_heads=1), False, 12, 24, 4, None),
    "mha": (dict(n_kv_heads=4), False, 12, 24, 4, None),
    "softcap": (dict(attn_softcap=2.0), False, 12, 24, 4, None),
    "window_prefill_below": (dict(sliding_window=8, attn_softcap=5.0), True,
                             5, 8, 11, None),
    "window_prefill_at": (dict(sliding_window=8), True, 8, 8, 10, None),
    "window_prefill_above": (dict(sliding_window=8, qk_norm=True), True,
                             13, 8, 10, None),
    "window_cache_shorter": (dict(sliding_window=8), True, 3, 6, 3, None),
    "cross": (dict(qkv_bias=True), False, 12, None, 0, 13),
}


def _attn_layer(cfg, seed):
    p, _ = JL.init_attention(jax.random.PRNGKey(seed), cfg)
    return _draw(jax.tree.map(np.asarray, p), np.random.default_rng(seed),
                 True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("feature", list(_FEATURES))
def test_attention_matches_reference(feature, dtype):
    """``attention`` against ``JL.attention``: the cacheless form (a
    forward pass, or cross-attention onto an encoder output), then a
    prompt into a cache and decode steps (a ring over more than ``window``
    steps for the local layers), outputs and caches."""
    kw, local, s, depth, steps, src = _FEATURES[feature]
    cfg = dataclasses.replace(_ATTN_BASE, dtype=dtype, **kw)
    pcfg = to_port_config(cfg)
    p = _attn_layer(cfg, 3)
    pp = {k: torch.from_numpy(v) for k, v in p.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    kv = None if src is None else rng.standard_normal(
        (2, src, cfg.d_model)).astype(np.float32)
    cd = cfg.compute_dtype
    tol = TOL[dtype]

    def ref(p, x, cache, kv):
        return JL.attention(p, x, cfg, local=local, cache=cache, kv_src=kv,
                            causal=True)

    def port(x, cache=None, kv=None):
        return PL.attention(pp, torch.from_numpy(x).to(pcfg.compute_dtype),
                            pcfg, local=local, cache=cache,
                            kv_src=None if kv is None
                            else torch.from_numpy(kv), causal=True)

    jref = jax.jit(ref)
    want, _ = jref(p, jnp.asarray(x).astype(cd), None,
                   None if kv is None else jnp.asarray(kv))
    got, _ = port(x, kv=kv)
    _rel(got, _np(want), tol)
    if depth is None:
        return
    hd, kvh = cfg.hd, cfg.n_kv_heads
    jc = {"k": jnp.zeros((2, depth, kvh, hd), cd),
          "v": jnp.zeros((2, depth, kvh, hd), cd),
          "idx": jnp.zeros((), jnp.int32)}
    pc = {"k": torch.zeros((2, depth, kvh, hd), dtype=pcfg.compute_dtype),
          "v": torch.zeros((2, depth, kvh, hd), dtype=pcfg.compute_dtype),
          "idx": torch.zeros((), dtype=torch.int32)}
    want, jc = jref(p, jnp.asarray(x).astype(cd), jc, None)
    got, pc = port(x, pc)
    _rel(got, _np(want), tol)
    jdec = jax.jit(lambda p, x, c, pos: JL.attention(
        p, x, cfg, local=local, cache=c, positions=pos))
    for t in range(steps):
        tok = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        pos = s + t
        want, jc = jdec(p, jnp.asarray(tok).astype(cd), jc,
                        jnp.full((1, 1), pos, jnp.int32))
        got, pc = PL.attention(pp, torch.from_numpy(tok).to(
            pcfg.compute_dtype), pcfg, local=local, cache=pc,
            positions=torch.full((1, 1), pos, dtype=torch.int32))
        _rel(got, _np(want), tol)
        assert int(pc["idx"]) == int(jc["idx"]) == pos + 1
        for key in ("k", "v"):
            assert pc[key].dtype == pcfg.compute_dtype
            _rel(pc[key], _np(jc[key]), tol)


@pytest.mark.parametrize("causal,window,softcap,t", [
    (True, None, None, 20), (True, 6, 3.0, 20), (False, None, 2.0, 13),
    (False, 5, None, 27)])
def test_chunked_attention_matches_reference(causal, window, softcap, t):
    """``_chunked_attn`` against the reference's (queries in chunks of 8,
    a ragged last chunk), and B3's plain version against both."""
    rng = np.random.default_rng(t)
    q = rng.standard_normal((2, 20, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, t, 2, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap, scale=0.25)
    want = jax.jit(lambda q, k, v: JL._chunked_attn(q, k, v, chunk=8, **kw))(
        q, k, v)
    got = PL._chunked_attn(*map(torch.from_numpy, (q, k, v)), chunk=8, **kw)
    _rel(got, want, F32 / 10)
    dense = PL._dense_attn(*map(torch.from_numpy, (q, k, v)), **kw)
    _rel(dense, jax.jit(lambda q, k, v: JL._dense_attn(q, k, v, **kw))(
        q, k, v), F32 / 10)
    plain = reference_attention(*(torch.from_numpy(z).transpose(1, 2)
                                  for z in (q, k, v)), **kw).transpose(1, 2)
    _rel(plain, want, F32 / 10)
    _rel(plain, dense.numpy(), F32 / 10)


def test_long_prompts_take_the_chunked_form(monkeypatch):
    """Above ``DENSE_ATTN_MAX_SEQ`` queries both packages chunk the query
    axis: with the threshold lowered in both, a 20-token prompt runs
    ``_chunked_attn`` in each, and they agree."""
    assert PL.DENSE_ATTN_MAX_SEQ == JL.DENSE_ATTN_MAX_SEQ == 8192
    calls = []
    real = PL._chunked_attn
    monkeypatch.setattr(PL, "_chunked_attn",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(PL, "DENSE_ATTN_MAX_SEQ", 8)
    monkeypatch.setattr(JL, "DENSE_ATTN_MAX_SEQ", 8)
    cfg = dataclasses.replace(_ATTN_BASE, dtype="float32", sliding_window=6,
                              attn_softcap=3.0)
    p = _attn_layer(cfg, 5)
    x = np.random.default_rng(6).standard_normal((2, 20, 64)).astype(
        np.float32)
    want, _ = JL.attention(p, jnp.asarray(x), cfg, local=True)
    got, _ = PL.attention({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), to_port_config(cfg),
                          local=True)
    assert calls == [1]
    _rel(got, want, F32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_mlp_matches_reference(dtype):
    """``act="gelu"`` is ``jax.nn.gelu``'s default, the tanh form."""
    cfg = dataclasses.replace(_ATTN_BASE, act="gelu", dtype=dtype)
    p, _ = JL.init_mlp(jax.random.PRNGKey(7), cfg)
    p = jax.tree.map(np.array, p)
    x = 2 * np.random.default_rng(8).standard_normal((2, 9, 64)).astype(
        np.float32)
    want = jax.jit(lambda p, x: JL.mlp(p, x, cfg))(
        p, jnp.asarray(x).astype(cfg.compute_dtype))
    got = PL.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x).to(getattr(torch, dtype)),
                 to_port_config(cfg))
    _rel(got, _np(want), TOL[dtype])
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    tanh = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    assert not torch.equal(erf, tanh)      # the two forms differ
