"""The direct (eager) decoder-only LM — the dense subset of
``repro/models/transformer.py`` that ``lazy_transformer.validate_config``
admits, in PyTorch.

It is the port's end-to-end oracle: the tests hold it against the JAX
package's jitted model on the same weights (:func:`params_from_numpy`), and
on the card, where there is no JAX, the lazy transformer is held against
it.  It never runs on the lazy path.

The parameter tree has the reference's structure: ``groups/l{i}/...``
stacked on a leading layer axis (one entry per repeat of the layer
pattern's unit), plus ``embed``, ``final_norm`` and ``lm_head``.  Layers run
in a Python loop over that axis (the reference's ``lax.scan``).

Entry points: :func:`forward` (logits for a whole sequence),
:func:`serve_prefill` (prompt → last-position logits and a filled KV
cache) and :func:`serve_decode` (one token against the cache).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..core.lazy import resolve_device
from .config import ModelConfig
from .layers import attention, init_attention, init_mlp, init_rmsnorm, mlp, rmsnorm
from .lazy_transformer import validate_config

Params = Dict[str, Any]


def _stack(trees: List[Params]) -> Params:
    """Stack a list of identically-shaped trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _index(tree: Params, g: int) -> Params:
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random weights drawn from ``generator`` (which must live on
    ``device``, the generator's own device by default), in the reference's
    tree structure and initial scales.  The draws differ from JAX's:
    tests that compare the two packages convert the reference's weights
    with :func:`params_from_numpy` instead."""
    validate_config(cfg)
    device = torch.device(device if device is not None else generator.device)
    unit, n_groups = cfg.scan_groups()
    pd = getattr(torch, cfg.param_dtype)

    def layer():
        return {"norm1": init_rmsnorm(cfg.d_model, pd, device),
                "mixer": init_attention(generator, cfg, device),
                "norm2": init_rmsnorm(cfg.d_model, pd, device),
                "ffn": init_mlp(generator, cfg, device)}

    params: Params = {"groups": _stack([
        {f"l{i}": layer() for i in range(len(unit))}
        for _ in range(n_groups)])}
    params["embed"] = (torch.randn((cfg.vocab_size, cfg.d_model),
                                   generator=generator, device=device)
                       * 0.02).to(pd)
    params["final_norm"] = init_rmsnorm(cfg.d_model, pd, device)
    params["lm_head"] = (torch.randn((cfg.d_model, cfg.vocab_size),
                                     generator=generator, device=device)
                         * (1 / math.sqrt(cfg.d_model))).to(pd)
    return params


def params_from_numpy(tree, device=None) -> Params:
    """The JAX package's parameter tree (leaves as numpy arrays, or anything
    ``np.asarray`` takes) as the port's: the same nesting, torch tensors on
    ``device`` (the CUDA card unless given)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(resolve_device(device))


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _apply_layer(lp: Params, x, cfg: ModelConfig, *, positions, cache=None):
    h = rmsnorm(lp["norm1"], x, plus_one=cfg.norm_plus_one)
    a, new_cache = attention(lp["mixer"], h, cfg, positions=positions,
                             cache=cache)
    x = x + a
    h = rmsnorm(lp["norm2"], x, plus_one=cfg.norm_plus_one)
    return x + mlp(lp["ffn"], h, cfg), new_cache


def _run_groups(params, x, cfg: ModelConfig, *, positions, caches=None):
    """The layers in order over the stacked groups.  ``caches`` is stacked
    over the group axis (or None).  Returns ``(x, new_caches)``."""
    unit, n_groups = cfg.scan_groups()
    new: Dict[str, List] = {f"l{i}": [] for i in range(len(unit))}
    gp = params["groups"]
    for g in range(n_groups):
        for i in range(len(unit)):
            c = None if caches is None else _index(caches[f"l{i}"], g)
            x, nc = _apply_layer(_index(gp[f"l{i}"], g), x, cfg,
                                 positions=positions, cache=c)
            if nc is not None:
                new[f"l{i}"].append(nc)
    if caches is None:
        return x, None
    return x, {k: _stack(v) for k, v in new.items()}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _tokens(params, tokens) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                           device=params["embed"].device)


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig):
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    if cfg.norm_plus_one:           # gemma convention
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype,
                             device=x.device)
    return x


def _unembed(params, x, cfg: ModelConfig):
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(x.dtype))
    return logits.to(torch.float32)


def forward(params, tokens, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Training/eval logits ``(B, S, vocab)`` and the auxiliary loss (zero:
    the dense subset has no router)."""
    validate_config(cfg)
    tokens = _tokens(params, tokens)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    x, _ = _run_groups(params, x, cfg, positions=positions)
    x = rmsnorm(params["final_norm"], x, plus_one=cfg.norm_plus_one)
    return _unembed(params, x, cfg), torch.zeros((), device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Params:
    """Zero KV caches stacked over the groups: ``{"l{i}": {"k", "v":
    (groups, B, max_seq, kv_heads, hd), "idx": (groups,) int32}}``."""
    unit, n_groups = cfg.scan_groups()
    kvh, hd = cfg.n_kv_heads, cfg.hd
    shape = (n_groups, batch, max_seq, kvh, hd)
    return {f"l{i}": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "idx": torch.zeros((n_groups,), dtype=torch.int32, device=device),
    } for i in range(len(unit))}


def serve_prefill(params, tokens, cfg: ModelConfig, max_seq: int):
    """Run the prompt, returning ``(last-position logits, filled cache)``."""
    validate_config(cfg)
    tokens = _tokens(params, tokens)
    x = _embed(params, tokens, cfg)
    b, s = tokens.shape
    caches = init_cache(cfg, b, max_seq, dtype=cfg.compute_dtype,
                        device=x.device)
    positions = torch.arange(s, device=x.device)[None]
    x, new_caches = _run_groups(params, x, cfg, positions=positions,
                                caches=caches)
    x = rmsnorm(params["final_norm"], x, plus_one=cfg.norm_plus_one)
    return _unembed(params, x[:, -1:], cfg), new_caches


def serve_decode(params, caches, token, cfg: ModelConfig):
    """One decode step for ``(B, 1)`` tokens.  Returns ``(logits,
    caches)``."""
    validate_config(cfg)
    token = _tokens(params, token)
    x = _embed(params, token, cfg)
    idx = caches["l0"]["idx"][0]       # same position for every layer
    positions = (idx + torch.arange(1, device=x.device))[None]
    x, new_caches = _run_groups(params, x, cfg, positions=positions,
                                caches=caches)
    x = rmsnorm(params["final_norm"], x, plus_one=cfg.norm_plus_one)
    return _unembed(params, x, cfg), new_caches
