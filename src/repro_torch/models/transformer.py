"""The direct (eager) LM of ``repro/models/transformer.py`` in PyTorch:
decoder-only, MoE, encoder-decoder, VLM, SSM-hybrid and RWKV models —
attention (full and sliding-window, with the ring-buffer caches of local
layers), Mamba and RWKV6 mixers, each followed by a dense MLP or a MoE
layer — at any compute dtype the config names: every config of
``configs/`` as published.

It is the port's end-to-end oracle for the lazy lane: the tests hold it
against the JAX package's jitted model on the same weights
(:func:`params_from_numpy`), and on the card, where there is no JAX, the
lazy transformer is held against it.  It never runs on the lazy path.  It
is also the serving path itself (``launch/serve.py``): on the card every
multi-token attention and every cross-attention runs kernel B3, RWKV
layers run the recurrence through kernels B7 (a prompt, in chunks) and B6
(a decode token, carrying the state), Mamba layers their scan through
kernel B5 (a prompt or a decode token, carrying the state).

The parameter tree has the reference's structure: ``groups/l{i}/...``
stacked on a leading layer axis (one entry per repeat of the layer
pattern's unit), plus ``embed``, ``final_norm``, ``lm_head`` (not with
tied embeddings) and, for an encoder, ``encoder`` (stacked over its
layers) and ``enc_norm``.  Layers run in a Python loop over that axis
(the reference's ``lax.scan``).

On a mesh the leaves are DTensors placed by their logical axes
(:func:`param_axes`, :func:`abstract_params`); :func:`forward` and
:func:`lm_loss` take the reference's ``constrain`` hook and
:func:`serve_prefill` its ``pin_cache`` (``launch/steps.py`` passes them);
without them nothing changes.

Entry points: :func:`forward` (logits for a whole sequence),
:func:`serve_prefill` (prompt → last-position logits and a filled cache:
KV caches for attention, the conv inputs and SSM state for Mamba, the
token shift and wkv state for RWKV),
:func:`serve_decode` (one token against the cache), :func:`encode` (the
encoder over frame embeddings) and :func:`lm_loss`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..core.device import resolve_device
from ..core.obs import trace
from .config import ModelConfig
from .layers import (MAMBA_AXES, MLP_AXES, RMSNORM_AXES, RWKV_AXES,
                     _is_dtensor, attention, attention_axes, einsum,
                     init_attention, init_mamba,
                     init_mlp, init_moe, init_rmsnorm, init_rwkv,
                     mamba_mixer, mlp, moe, moe_axes, rmsnorm, rwkv_mixer)

Params = Dict[str, Any]


def _stack(trees: List[Params]) -> Params:
    """Stack a list of identically-shaped trees along a new leading axis.
    It empties the trees as it goes, so each leaf's pieces are freed once
    their stack is made: a model's float32 weights are never held twice
    (Gemma2-9B's layers are 33 GB)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(first)}
    out = torch.stack(trees)
    trees.clear()
    return out


def _index(tree: Params, g: int) -> Params:
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def validate_config(cfg: ModelConfig) -> None:
    """Raise ``ValueError``, naming what the direct model lacks, unless
    every layer of ``cfg`` can run.  Every layer kind of
    ``ModelConfig.layer_pattern`` can; an RWKV6 model needs a ``d_model``
    that is a multiple of its head size."""
    if cfg.rwkv is not None and cfg.d_model % cfg.rwkv.head_dim:
        raise ValueError(f"the direct model does not support d_model "
                         f"{cfg.d_model} not a multiple of the RWKV head "
                         f"size {cfg.rwkv.head_dim}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

_INIT_MIXER = {"attn": init_attention, "attn_local": init_attention,
               "mamba": init_mamba, "rwkv": init_rwkv}


def _init_layer(gen, cfg: ModelConfig, mixer: str, ffn: str, device,
                cross: bool = False) -> Params:
    pd = getattr(torch, cfg.param_dtype)
    p = {"norm1": init_rmsnorm(cfg.d_model, pd, device),
         "mixer": _INIT_MIXER[mixer](gen, cfg, device)}
    if cross:
        p["cross"] = init_attention(gen, cfg, device)
        p["norm_cross"] = init_rmsnorm(cfg.d_model, pd, device)
    p["norm2"] = init_rmsnorm(cfg.d_model, pd, device)
    p["ffn"] = (init_moe if ffn == "moe" else init_mlp)(gen, cfg, device)
    return p


def _build(cfg: ModelConfig, gen, device) -> Params:
    """The parameter tree: drawn from ``gen``, or (``gen`` None, on the
    ``meta`` device) shapes and dtypes only."""
    unit, n_groups = cfg.scan_groups()
    pd = getattr(torch, cfg.param_dtype)

    def normal(shape, scale):
        if gen is None:
            return torch.empty(shape, dtype=pd, device=device)
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(pd)

    cross = cfg.n_encoder_layers > 0
    params: Params = {"groups": _stack([
        {f"l{i}": _init_layer(gen, cfg, mixer, ffn, device, cross=cross)
         for i, (mixer, ffn) in enumerate(unit)}
        for _ in range(n_groups)])}
    params["embed"] = normal((cfg.vocab_size, cfg.d_model), 0.02)
    params["final_norm"] = init_rmsnorm(cfg.d_model, pd, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab_size),
                                   1 / math.sqrt(cfg.d_model))
    if cfg.n_encoder_layers:
        params["encoder"] = _stack([
            _init_layer(gen, cfg, "attn", "mlp", device)
            for _ in range(cfg.n_encoder_layers)])
        params["enc_norm"] = init_rmsnorm(cfg.d_model, pd, device)
    return params


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
    return _build(cfg, generator, device)


def _layer_axes(cfg: ModelConfig, mixer: str, ffn: str,
                cross: bool = False) -> Params:
    ax = {"norm1": RMSNORM_AXES,
          "mixer": {"mamba": MAMBA_AXES, "rwkv": RWKV_AXES}.get(
              mixer) or attention_axes(cfg)}
    if cross:
        ax["cross"] = attention_axes(cfg)
        ax["norm_cross"] = RMSNORM_AXES
    ax["norm2"] = RMSNORM_AXES
    ax["ffn"] = moe_axes(cfg) if ffn == "moe" else MLP_AXES
    return ax


def _stacked(tree) -> Params:
    """Each leaf's axes behind the leading ``"layers"`` axis of a stack."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return ("layers",) + tuple(tree)


def param_axes(cfg: ModelConfig) -> Params:
    """The logical sharding axes of each leaf of :func:`init_params`' tree
    (a tuple of names a leaf), as the reference's ``init_params`` returns
    them beside the parameters."""
    unit, _ = cfg.scan_groups()
    cross = cfg.n_encoder_layers > 0
    axes: Params = {"groups": _stacked({
        f"l{i}": _layer_axes(cfg, mixer, ffn, cross=cross)
        for i, (mixer, ffn) in enumerate(unit)})}
    axes["embed"] = ("vocab_table", "embed_table")
    axes["final_norm"] = RMSNORM_AXES
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.n_encoder_layers:
        axes["encoder"] = _stacked(_layer_axes(cfg, "attn", "mlp"))
        axes["enc_norm"] = RMSNORM_AXES
    return axes


def abstract_params(cfg: ModelConfig) -> Tuple[Params, Params]:
    """``(shapes, axes)``: the :func:`init_params` tree as ``meta``
    tensors (shapes and dtypes, no memory and no generator) and its
    logical sharding axes (:func:`param_axes`), as the reference's
    ``abstract_params`` returns them."""
    validate_config(cfg)
    return _build(cfg, None, torch.device("meta")), param_axes(cfg)


def params_from_numpy(tree, device=None) -> Params:
    """The JAX package's parameter tree (leaves as numpy arrays, or anything
    ``np.asarray`` takes) as the port's: the same nesting, torch tensors on
    ``device`` (the CUDA card unless given).  A bfloat16 leaf (numpy's
    ``ml_dtypes`` type, which ``torch.from_numpy`` refuses) keeps its
    bits."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.array(tree)
    if arr.dtype.name == "bfloat16":
        out = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        out = torch.from_numpy(arr)
    return out.to(resolve_device(device))


#: the leaves the forward pass casts to ``cfg.compute_dtype`` before use
#: (the projection matrices of attention, RWKV6, Mamba, the MLP and the
#: experts, the QKV biases, Mamba's conv taps and bias, the embedding and
#: the unembedding); every other leaf (RWKV6's ``mix``, ``w0``, ``w_a``,
#: ``w_b``, ``u``, ``ln_g``, the MoE ``router``, Mamba's ``dt_bias``,
#: ``a_log`` and ``d``, the norm gains and the qk-norm gains) is read in
#: float32
COMPUTE_LEAVES = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv", "wr",
                            "wg", "w_gate", "w_up", "w_down", "in_proj",
                            "conv_w", "conv_b", "x_proj", "dt_proj",
                            "out_proj", "embed", "lm_head"})


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

def _apply_layer(lp: Params, x, cfg: ModelConfig, mixer: str, ffn: str, *,
                 positions, cache=None, enc_out=None, causal: bool = True,
                 in_place: bool = False, constrain=None,
                 span: str = "layer", index=None):
    """One layer; returns ``(x, new_cache, aux)``: ``aux`` the MoE
    router's loss, or None for a dense MLP.  With ``in_place`` the new
    cache is written into ``cache`` right after the mixer (an RWKV
    layer's wkv state, a Mamba layer's ssm state and an attention layer's
    keys and values by the layer itself, so only the rest is copied),
    and ``cache`` is returned.  ``constrain`` goes to the MoE layer
    (:func:`forward`).  Each sublayer, its norm and its residual add is a
    device span (``core.obs.trace``) ``<span>.<mixer>``, ``<span>.cross``
    and ``<span>.<ffn>`` with ``layer=index``; the mixer's covers the
    cache's write-back."""
    with trace.device_span(f"{span}.{mixer}", layer=index):
        h = rmsnorm(lp["norm1"], x, plus_one=cfg.norm_plus_one)
        if mixer == "rwkv":
            a, new_cache = rwkv_mixer(lp["mixer"], h, cfg, state=cache,
                                      in_place=in_place)
        elif mixer == "mamba":
            a, new_cache = mamba_mixer(lp["mixer"], h, cfg, state=cache,
                                       in_place=in_place)
        else:
            a, new_cache = attention(lp["mixer"], h, cfg,
                                     local=mixer == "attn_local",
                                     positions=positions, cache=cache,
                                     causal=causal, in_place=in_place)
        if in_place and new_cache is not None:
            for key, dst in cache.items():
                if new_cache[key].data_ptr() != dst.data_ptr():
                    dst.copy_(new_cache[key])       # not written yet
            new_cache = cache
        x = x + a
    if enc_out is not None and "cross" in lp:
        with trace.device_span(f"{span}.cross", layer=index):
            h = rmsnorm(lp["norm_cross"], x, plus_one=cfg.norm_plus_one)
            c, _ = attention(lp["cross"], h, cfg, kv_src=enc_out,
                             causal=False)
            x = x + c
    with trace.device_span(f"{span}.{ffn}", layer=index):
        h = rmsnorm(lp["norm2"], x, plus_one=cfg.norm_plus_one)
        if ffn == "moe":
            f, aux = moe(lp["ffn"], h, cfg, constrain=constrain)
            return x + f, new_cache, aux
        return x + mlp(lp["ffn"], h, cfg), new_cache, None


def _unstack(tree: Params, n: int) -> List[Params]:
    """The ``n`` per-group trees of a tree stacked over its leading axis, as
    views through ``torch.unbind``: its backward stacks the groups'
    gradients once, where indexing each group would add a zero-filled
    gradient of the whole stack per group."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: p[g] for k, p in parts.items()} for g in range(n)]
    return list(torch.unbind(tree))


def _remat(enabled: bool, fn, *args):
    """``fn(*args)``; when ``enabled`` and gradients are being recorded,
    keeping none of its activations for the backward pass, which runs it
    again (the reference's ``jax.checkpoint`` with ``nothing_saveable``)."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _run_groups(params, x, cfg: ModelConfig, *, positions, caches=None,
                enc_out=None, in_place: bool = False, constrain=None):
    """The layers in order over the stacked groups.  ``caches`` is stacked
    over the group axis (or None).  Returns ``(x, new_caches, aux)``, aux
    the float32 sum of the MoE layers' router losses (zero without any);
    with ``in_place`` the new caches are written into ``caches`` (each
    layer's right after its mixer, :func:`_apply_layer`) and ``caches``
    is returned.  Layer ``g · len(unit) + i`` is group ``g``'s ``i``-th.
    Without caches and with ``cfg.remat`` each group's body is
    rematerialized in the backward pass (:func:`_remat`), so only the
    group-boundary activations stay alive.  ``constrain`` pins each
    group's input and output (``"activation"``) and goes to the layers."""
    unit, n_groups = cfg.scan_groups()
    groups = _unstack(params["groups"], n_groups)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if caches is None:
        def group(x, aux, gp, g):
            if constrain is not None:
                x = constrain("activation", x)
            for i, (mixer, ffn) in enumerate(unit):
                x, _, a = _apply_layer(gp[f"l{i}"], x, cfg, mixer, ffn,
                                       positions=positions, enc_out=enc_out,
                                       constrain=constrain,
                                       index=g * len(unit) + i)
                if a is not None:
                    aux = aux + a
            if constrain is not None:
                x = constrain("activation", x)
            return x, aux

        for g, gp in enumerate(groups):
            x, aux = _remat(cfg.remat, group, x, aux, gp, g)
        return x, None, aux
    new: Dict[str, List] = {f"l{i}": [] for i in range(len(unit))}
    for g, gp in enumerate(groups):
        if constrain is not None:
            x = constrain("activation", x)
        for i, (mixer, ffn) in enumerate(unit):
            c = _index(caches[f"l{i}"], g)
            x, nc, a = _apply_layer(gp[f"l{i}"], x, cfg, mixer, ffn,
                                    positions=positions, cache=c,
                                    enc_out=enc_out, in_place=in_place,
                                    constrain=constrain,
                                    index=g * len(unit) + i)
            if a is not None:
                aux = aux + a
            if nc is not None and not in_place:
                new[f"l{i}"].append(nc)
        if constrain is not None:
            x = constrain("activation", x)
    if in_place:
        return x, caches, aux
    return x, {k: _stack(v) for k, v in new.items()}, aux


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _tokens(params, tokens) -> torch.Tensor:
    device = params["embed"].device
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                           device=device)


def _input(params, x, cfg: ModelConfig):
    """Frames or patch embeddings (a tensor or anything ``np.asarray``
    takes) on the weights' device, in the compute dtype."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=params["embed"].device, dtype=cfg.compute_dtype)


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig, patch_embeds=None):
    table = params["embed"].to(cfg.compute_dtype)
    if _is_dtensor(table):
        # DTensor's row-gather rule (the table's d_model sharded: each
        # rank gathers its columns); the same rows as the index below
        x = torch.nn.functional.embedding(tokens, table)
    else:
        x = table[tokens]
    if cfg.norm_plus_one:           # gemma convention
        # the scale rounded to the compute dtype, as a host scalar: no copy
        # to the device, so a decode step can be captured in a CUDA graph
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype)
    if patch_embeds is not None:
        x = torch.cat([_input(params, patch_embeds, cfg), x], dim=1)
    return x


def _unembed(params, x, cfg: ModelConfig, constrain=None):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if cfg.tie_embeddings and constrain is not None:
        # the table keeps its vocab dim whole for the token gather; the
        # unembedding takes it vocab-sharded, so the logits come out so
        w = constrain("unembed_w", w)
    logits = einsum("bsd,dv->bsv", x, w.to(x.dtype)).to(torch.float32)
    if constrain is not None:
        # the (B, S, V) float32 logits stay vocab-sharded: the loss runs
        # on the shards
        logits = constrain("logits", logits)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def encode(params, frames, cfg: ModelConfig) -> torch.Tensor:
    """The encoder over precomputed frame embeddings ``(B, enc_seq, d)``
    (the reference's conv front end is a stub too): full attention, RoPE
    on its self-attention as in the reference, then ``enc_norm``; with
    ``cfg.remat`` each layer rematerialized in the backward pass."""
    validate_config(cfg)
    x = _input(params, frames, cfg)
    pos = torch.arange(x.shape[1], device=x.device)[None]

    def layer(x, lp, i):
        return _apply_layer(lp, x, cfg, "attn", "mlp", positions=pos,
                            causal=False, span="encoder", index=i)[0]

    for i, lp in enumerate(_unstack(params["encoder"],
                                    cfg.n_encoder_layers)):
        x = _remat(cfg.remat, layer, x, lp, i)
    return rmsnorm(params["enc_norm"], x, plus_one=cfg.norm_plus_one)


def forward(params, tokens, cfg: ModelConfig, *, frames=None,
            patch_embeds=None,
            constrain=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/eval logits ``(B, S, vocab)`` and the auxiliary loss (the
    MoE layers' router losses summed, float32; zero without MoE layers).
    ``frames``: the encoder's input; ``patch_embeds``: ``(B, n_patches,
    d)`` prefixed to the tokens and dropped from the logits.
    ``constrain``: an optional ``(tag, x) -> x`` sharding hook, called at
    the reference's sites: ``"activation"`` (the embedded input and each
    layer group's input and output), ``"moe_dispatch"`` and
    ``"moe_expert"`` (in :func:`~.layers.moe`), ``"unembed_w"`` (a tied
    table) and ``"logits"``."""
    validate_config(cfg)
    enc_out = None if frames is None else encode(params, frames, cfg)
    with trace.device_span("model.embed"):
        x = _embed(params, _tokens(params, tokens), cfg, patch_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    if constrain is not None:
        x = constrain("activation", x)
    x, _, aux = _run_groups(params, x, cfg, positions=positions,
                            enc_out=enc_out, constrain=constrain)
    with trace.device_span("model.head"):
        x = rmsnorm(params["final_norm"], x, plus_one=cfg.norm_plus_one)
        if patch_embeds is not None:
            x = x[:, patch_embeds.shape[1]:]
        return _unembed(params, x, cfg, constrain=constrain), aux


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Params:
    """Zero caches stacked over the groups, per position of the pattern's
    unit, on ``device`` (the CUDA card unless given; ``meta`` gives shapes
    only): an attention layer's ``{"k", "v": (groups, B, T, kv_heads, hd),
    "idx": (groups,) int32}`` with ``T = max_seq``, or for a sliding-window
    layer a ring of ``T = min(max_seq, window)``; an RWKV layer's
    ``{"last": (groups, B, d) in dtype, "wkv": (groups, B, H, N, N)
    float32}``; a Mamba layer's ``{"conv": (groups, B, d_conv - 1,
    d_inner) in dtype, "ssm": (groups, B, d_inner, d_state) float32}``."""
    device = resolve_device(device)
    unit, n_groups = cfg.scan_groups()
    kvh, hd = cfg.n_kv_heads, cfg.hd

    def zeros(*shape, dtype=dtype):
        return torch.zeros((n_groups, batch) + shape, dtype=dtype,
                           device=device)

    cache: Params = {}
    for i, (mixer, _) in enumerate(unit):
        if mixer in ("attn", "attn_local"):
            seq = max_seq
            if mixer == "attn_local" and cfg.sliding_window:
                seq = min(max_seq, cfg.sliding_window)
            cache[f"l{i}"] = {
                "k": zeros(seq, kvh, hd), "v": zeros(seq, kvh, hd),
                "idx": torch.zeros((n_groups,), dtype=torch.int32,
                                   device=device)}
        elif mixer == "mamba":
            m = cfg.mamba
            d_in = m.expand * cfg.d_model
            cache[f"l{i}"] = {
                "conv": zeros(m.d_conv - 1, d_in),
                "ssm": zeros(d_in, m.d_state, dtype=torch.float32)}
        elif mixer == "rwkv":
            n = cfg.rwkv.head_dim
            cache[f"l{i}"] = {
                "last": zeros(cfg.d_model),
                "wkv": zeros(cfg.d_model // n, n, n, dtype=torch.float32)}
    return cache


def serve_prefill(params, tokens, cfg: ModelConfig, max_seq: int, *,
                  frames=None, patch_embeds=None, enc_out=None,
                  pin_cache=None):
    """Run the prompt, returning ``(last-position logits, filled cache)``.
    ``frames`` go through the encoder first, unless the caller passes its
    output as ``enc_out`` (the launcher encodes once a batch and hands the
    result to every decode step too); ``patch_embeds`` prefix the tokens
    (``max_seq`` counts them).  ``pin_cache``: an optional tree-aware
    sharding hook that places the zero caches and the filled ones in
    their serving layout (``launch/steps.py``)."""
    validate_config(cfg)
    if enc_out is None and frames is not None:
        enc_out = encode(params, frames, cfg)
    with trace.device_span("model.embed"):
        x = _embed(params, _tokens(params, tokens), cfg, patch_embeds)
    b, s = x.shape[0], x.shape[1]
    caches = init_cache(cfg, b, max_seq, dtype=cfg.compute_dtype,
                        device=x.device)
    if pin_cache is not None:
        caches = pin_cache(caches)
    positions = torch.arange(s, device=x.device)[None]
    x, new_caches, _ = _run_groups(params, x, cfg, positions=positions,
                                   caches=caches, enc_out=enc_out)
    if pin_cache is not None:
        new_caches = pin_cache(new_caches)
    with trace.device_span("model.head"):
        x = rmsnorm(params["final_norm"], x, plus_one=cfg.norm_plus_one)
        return _unembed(params, x[:, -1:], cfg), new_caches


def serve_decode(params, caches, token, cfg: ModelConfig, *, enc_out=None,
                 in_place: bool = False):
    """One decode step for ``(B, 1)`` tokens, cross-attending to
    ``enc_out`` where the model has an encoder.  Returns ``(logits,
    caches)``: new caches, or with ``in_place`` the given ones, updated
    (the decode graph's static caches)."""
    validate_config(cfg)
    with trace.device_span("model.embed"):
        x = _embed(params, _tokens(params, token), cfg)
    idx = _first_idx(caches, x.device)
    positions = (idx + torch.arange(1, device=x.device))[None]
    x, new_caches, _ = _run_groups(params, x, cfg, positions=positions,
                                   caches=caches, enc_out=enc_out,
                                   in_place=in_place)
    with trace.device_span("model.head"):
        x = rmsnorm(params["final_norm"], x, plus_one=cfg.norm_plus_one)
        return _unembed(params, x, cfg), new_caches


def _first_idx(caches, device) -> torch.Tensor:
    """The position of the next token: the write index of the first
    attention cache, wherever it sits in the unit (the same for every
    attention layer; Jamba's is at position 4); Mamba and RWKV layers keep
    no position, only their state."""
    for v in caches.values():
        if "idx" in v:
            return v["idx"][0]
    return torch.zeros((), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss(params, batch, cfg: ModelConfig, *, z_coef: float = 1e-4,
            constrain=None):
    """Next-token cross entropy plus the logit z-loss and the MoE routers'
    auxiliary loss (:func:`forward`'s).  ``batch`` holds ``tokens``,
    ``labels`` (negative labels are masked out) and optionally ``frames``
    and ``patch_embeds``.  Returns ``(loss, {"nll", "aux"})``.
    ``constrain`` is :func:`forward`'s; with it the label's log-probability
    is the reference's one-hot reduction, shard-local over vocab-sharded
    logits (the same value as the gather: one term, the rest zeros)."""
    logits, aux = forward(params, batch["tokens"], cfg,
                          frames=batch.get("frames"),
                          patch_embeds=batch.get("patch_embeds"),
                          constrain=constrain)
    labels = _tokens(params, batch["labels"])
    logz = torch.logsumexp(logits, dim=-1)
    if constrain is None:
        ll = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    else:
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        onehot = vocab == labels.clamp_min(0)[..., None]
        ll = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    mask = (labels >= 0).to(torch.float32)
    count = torch.clamp_min(mask.sum(), 1.0)
    nll = torch.sum((logz - ll) * mask) / count
    zloss = z_coef * torch.sum(logz ** 2 * mask) / count
    return nll + zloss + aux, {"nll": nll, "aux": aux}
