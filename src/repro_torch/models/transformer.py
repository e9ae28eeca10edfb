"""The direct (eager) decoder-only LM of ``repro/models/transformer.py``
in PyTorch, for the layer kinds the port has: dense attention + MLP layers
(the subset the lazy LM lane admits) and RWKV6 + MLP layers at any compute
dtype the config names (:func:`validate_config` says which configurations
it runs and names what it lacks for the others).

It is the port's end-to-end oracle for the lazy lane: the tests hold it
against the JAX package's jitted model on the same weights
(:func:`params_from_numpy`), and on the card, where there is no JAX, the
lazy transformer is held against it.  It never runs on the lazy path.  For
RWKV6 it is also the serving path itself (``launch/serve.py``): its RWKV
layers run the recurrence through kernels B7 (a prompt, in chunks) and B6
(a decode token, carrying the state).

The parameter tree has the reference's structure: ``groups/l{i}/...``
stacked on a leading layer axis (one entry per repeat of the layer
pattern's unit), plus ``embed``, ``final_norm`` and ``lm_head``.  Layers run
in a Python loop over that axis (the reference's ``lax.scan``).

Entry points: :func:`forward` (logits for a whole sequence),
:func:`serve_prefill` (prompt → last-position logits and a filled cache:
KV caches for attention, the token shift and wkv state for RWKV) and
:func:`serve_decode` (one token against the cache).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .config import ModelConfig
from .layers import (attention, init_attention, init_mlp, init_rmsnorm,
                     init_rwkv, mlp, rmsnorm, rwkv_mixer)
from .lazy_transformer import validate_config as validate_lazy_config

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


def validate_config(cfg: ModelConfig) -> None:
    """Raise ``ValueError``, naming what the direct model lacks, unless
    ``cfg`` is dense attn+mlp as the lazy lane admits it or rwkv+mlp (any
    compute dtype)."""
    unit, _ = cfg.scan_groups()
    mixers = {m for m, _ in unit}
    if mixers != {"rwkv"}:
        try:
            validate_lazy_config(cfg)
        except ValueError as e:
            raise ValueError(f"the direct model runs dense layers as the lazy "
                             f"lane admits them: {e}") from e
        return
    checks = [
        (all(f == "mlp" for _, f in unit), f"ffn kinds {unit}"),
        (cfg.act == "silu", f"act={cfg.act!r}"),
        (not cfg.final_softcap, "final_softcap"),
        (not cfg.tie_embeddings, "tie_embeddings"),
        (cfg.n_encoder_layers == 0, "encoder layers"),
        (cfg.n_patches == 0, "patch embeddings"),
        (cfg.moe is None, "moe"),
        (cfg.d_model % cfg.rwkv.head_dim == 0,
         f"d_model {cfg.d_model} not a multiple of the RWKV head size "
         f"{cfg.rwkv.head_dim}"),
    ]
    for ok, what in checks:
        if not ok:
            raise ValueError(f"the direct model does not support {what}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random weights drawn from ``generator``, on ``device`` (the CUDA card
    unless given; the generator must live there), in the reference's tree
    structure and initial scales.  The draws differ from JAX's: tests that
    compare the two packages convert the reference's weights with
    :func:`params_from_numpy` instead."""
    validate_config(cfg)
    device = resolve_device(device)
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"init_params: a generator on {generator.device} "
                         f"cannot draw weights on {device}")
    unit, n_groups = cfg.scan_groups()
    pd = getattr(torch, cfg.param_dtype)

    def layer(mixer: str):
        init_mixer = init_rwkv if mixer == "rwkv" else init_attention
        return {"norm1": init_rmsnorm(cfg.d_model, pd, device),
                "mixer": init_mixer(generator, cfg, device),
                "norm2": init_rmsnorm(cfg.d_model, pd, device),
                "ffn": init_mlp(generator, cfg, device)}

    params: Params = {"groups": _stack([
        {f"l{i}": layer(mixer) for i, (mixer, _) in enumerate(unit)}
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


#: the leaves the forward pass casts to ``cfg.compute_dtype`` before use
#: (the projection matrices of attention, RWKV6 and the MLP, the embedding
#: and the unembedding); every other leaf (RWKV6's ``mix``, ``w0``,
#: ``w_a``, ``w_b``, ``u``, ``ln_g``, the norm gains) is read in float32
COMPUTE_LEAVES = frozenset({"wq", "wk", "wv", "wo", "wr", "wg", "w_gate",
                            "w_up", "w_down", "embed", "lm_head"})


def serving_params(params, cfg: ModelConfig) -> Params:
    """The serving copy of ``params``: every leaf in
    :data:`COMPUTE_LEAVES` cast once to ``cfg.compute_dtype``, every other
    leaf the same tensor.  The layers' own casts are then no-ops, and since
    a cast is deterministic the logits are bitwise those of ``params``;
    the float32-read leaves stay float32, as rounding them would change
    results."""
    cd = cfg.compute_dtype

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else v.to(cd) if k in COMPUTE_LEAVES else v
                for k, v in tree.items()}

    return walk(params)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _apply_layer(lp: Params, x, cfg: ModelConfig, mixer: str, *, positions,
                 cache=None, in_place: bool = False):
    h = rmsnorm(lp["norm1"], x, plus_one=cfg.norm_plus_one)
    if mixer == "rwkv":
        a, new_cache = rwkv_mixer(lp["mixer"], h, cfg, state=cache,
                                  in_place=in_place)
    else:
        a, new_cache = attention(lp["mixer"], h, cfg, positions=positions,
                                 cache=cache)
    x = x + a
    h = rmsnorm(lp["norm2"], x, plus_one=cfg.norm_plus_one)
    return x + mlp(lp["ffn"], h, cfg), new_cache


def _run_groups(params, x, cfg: ModelConfig, *, positions, caches=None,
                in_place: bool = False):
    """The layers in order over the stacked groups.  ``caches`` is stacked
    over the group axis (or None).  Returns ``(x, new_caches)``; with
    ``in_place`` the new caches are written into ``caches`` (each layer's
    right after it runs; an RWKV layer's wkv state by the layer itself) and
    ``caches`` is returned."""
    unit, n_groups = cfg.scan_groups()
    new: Dict[str, List] = {f"l{i}": [] for i in range(len(unit))}
    gp = params["groups"]
    for g in range(n_groups):
        for i, (mixer, _) in enumerate(unit):
            c = None if caches is None else _index(caches[f"l{i}"], g)
            x, nc = _apply_layer(_index(gp[f"l{i}"], g), x, cfg, mixer,
                                 positions=positions, cache=c,
                                 in_place=in_place)
            if nc is None:
                continue
            if not in_place:
                new[f"l{i}"].append(nc)
                continue
            for key, dst in c.items():
                if nc[key].data_ptr() != dst.data_ptr():  # not written yet
                    dst.copy_(nc[key])
    if caches is None or in_place:
        return x, caches
    return x, {k: _stack(v) for k, v in new.items()}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _tokens(params, tokens) -> torch.Tensor:
    device = params["embed"].device
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                           device=device)


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig):
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    if cfg.norm_plus_one:           # gemma convention
        # the scale rounded to the compute dtype, as a host scalar: no copy
        # to the device, so a decode step can be captured in a CUDA graph
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype)
    return x


def _unembed(params, x, cfg: ModelConfig):
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(x.dtype))
    return logits.to(torch.float32)


def forward(params, tokens, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Training/eval logits ``(B, S, vocab)`` and the auxiliary loss (zero:
    the layers the port has hold no router)."""
    validate_config(cfg)
    tokens = _tokens(params, tokens)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    x, _ = _run_groups(params, x, cfg, positions=positions)
    x = rmsnorm(params["final_norm"], x, plus_one=cfg.norm_plus_one)
    return _unembed(params, x, cfg), torch.zeros((), device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Params:
    """Zero caches stacked over the groups, per position of the pattern's
    unit, on ``device`` (the CUDA card unless given): an attention layer's
    ``{"k", "v": (groups, B, max_seq, kv_heads, hd), "idx": (groups,)
    int32}``, an RWKV layer's ``{"last": (groups, B, d) in dtype, "wkv":
    (groups, B, H, N, N) float32}``."""
    device = resolve_device(device)
    unit, n_groups = cfg.scan_groups()
    kvh, hd = cfg.n_kv_heads, cfg.hd
    cache: Params = {}
    for i, (mixer, _) in enumerate(unit):
        if mixer == "rwkv":
            n = cfg.rwkv.head_dim
            heads = cfg.d_model // n
            cache[f"l{i}"] = {
                "last": torch.zeros((n_groups, batch, cfg.d_model),
                                    dtype=dtype, device=device),
                "wkv": torch.zeros((n_groups, batch, heads, n, n),
                                   dtype=torch.float32, device=device),
            }
            continue
        shape = (n_groups, batch, max_seq, kvh, hd)
        cache[f"l{i}"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": torch.zeros((n_groups,), dtype=torch.int32, device=device),
        }
    return cache


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


def serve_decode(params, caches, token, cfg: ModelConfig, *,
                 in_place: bool = False):
    """One decode step for ``(B, 1)`` tokens.  Returns ``(logits,
    caches)``: new caches, or with ``in_place`` the given ones, updated
    (the decode graph's static caches)."""
    validate_config(cfg)
    token = _tokens(params, token)
    x = _embed(params, token, cfg)
    idx = _first_idx(caches, x.device)
    positions = (idx + torch.arange(1, device=x.device))[None]
    x, new_caches = _run_groups(params, x, cfg, positions=positions,
                                caches=caches, in_place=in_place)
    x = rmsnorm(params["final_norm"], x, plus_one=cfg.norm_plus_one)
    return _unembed(params, x, cfg), new_caches


def _first_idx(caches, device) -> torch.Tensor:
    """The position of the next token: the write index of the first
    attention cache (the same for every attention layer); RWKV layers keep
    no position, only their state."""
    for v in caches.values():
        if "idx" in v:
            return v["idx"][0]
    return torch.zeros((), dtype=torch.int32, device=device)
