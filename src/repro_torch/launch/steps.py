"""Step builders: the port of ``repro/launch/steps.py``: the train step
and the serve steps with their partition specs, on one card or on a named
``DeviceMesh`` (``("data", "model")`` or ``("pod", "data", "model")``,
``launch/mesh.py``).

The train recipe is the reference's: the batch split into microbatches,
each microbatch's gradients (float32, by autograd through ``lm_loss``)
cast to ``grad_dtype`` and added into ``grad_dtype`` accumulators that
start at zero, then the cosine-warmup learning rate of the optimizer's
step and one AdamW update with ``grad_scale = 1 / n_micro`` (the
microbatch mean folded into the update, no whole-tree float32 copy).  The
model rematerializes its layer groups when ``cfg.remat`` is set.

On a mesh the reference is GSPMD (``jax.jit`` with sharding constraints at
``reshard``, ``pin``, ``constrain`` and ``pin_cache``); the port is SPMD
over ranks (every rank runs the same step) with DTensors: every parameter
and moment is a DTensor placed by its ``PartitionSpec`` (FSDP × TP × EP
under ``RULES_TRAIN``, ``distributed.sharding``), each of the reference's
constraints is a ``redistribute`` to the same placements at the same site,
and DTensor's propagation places everything between them.  The model's
kernels run on each rank's local shards (``models.layers.sharded_call``).
A ``reshard`` of the batch takes this rank's rows of the whole batch,
which every rank passes.

The spec helpers (``opt_state_specs``, ``batch_specs_tree``,
``cache_specs``, ``params_specs``) read only the mesh's axis sizes, so a
duck-typed mesh whose ``shape`` maps axis to size serves them.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.obs import trace
from ..distributed.sharding import (RULES_SERVE, RULES_TRAIN, PartitionSpec,
                                    batch_spec, mesh_axis_sizes,
                                    params_specs)
from ..models.config import ModelConfig
from ..models.transformer import (abstract_params, init_cache, lm_loss,
                                  serve_decode, serve_prefill)
from ..optim.adamw import (OptState, _is_factored, _is_q, _paths,
                           _unflatten, adamw_init, adamw_update)
from ..optim.schedule import cosine_warmup

P = PartitionSpec


# ---------------------------------------------------------------------------
# Spec helpers
# ---------------------------------------------------------------------------

def _divides(n: int, mesh, axis) -> bool:
    if axis is None:
        return True
    sizes = mesh_axis_sizes(mesh)
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= sizes[a]
    return n % size == 0


def _map_specs(fn, specs, *trees):
    """``fn(spec, *nodes)`` at each ``PartitionSpec`` of ``specs``, the
    other trees' nodes at the same path (a moment's node may be a dict)."""
    if isinstance(specs, Mapping):
        return {k: _map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    return fn(specs, *trees)


def opt_state_specs(opt_shapes: OptState, pspecs, mesh) -> OptState:
    """Moments follow their parameter's spec exactly (the quantized q tensor
    is shape-preserving); the per-channel scale drops the last dim's axis,
    a factored moment's row and column their reduced dims'."""

    def one(pspec, leaf):
        if _is_q(leaf):
            parts = list(pspec) + [None] * (leaf["q"].ndim - len(pspec))
            return {"q": P(*parts), "scale": P(*parts[:-1], None)}
        if _is_factored(leaf):
            parts = list(pspec) + [None] * (
                leaf["row"].ndim + 1 - len(pspec))
            return {"row": P(*parts[:-1]), "col": P(*parts[:-2], parts[-1])}
        return pspec

    return OptState(step=P(), m=_map_specs(one, pspecs, opt_shapes.m),
                    v=_map_specs(one, pspecs, opt_shapes.v))


def batch_specs_tree(batch_shapes, mesh):
    """Each batch entry's leading dim over the data-parallel axes."""
    bs = batch_spec(mesh)
    return {k: P(bs[0], *([None] * (len(x.shape) - 1)))
            for k, x in batch_shapes.items()}


def cache_specs(cache_shapes, mesh, batch: int):
    """KV/SSM cache sharding: batch over the data axes when divisible,
    otherwise the sequence dim of k/v shards over ``data`` (a batch of one
    at long context: sequence parallelism for the cache); kv heads (or,
    where they do not divide, the sequence) and the state's inner dims
    over ``model``."""
    baxes = batch_spec(mesh)[0]

    def leaf(name, x):
        shape = tuple(x.shape)
        if name == "idx":
            return P()
        spec = [None] * len(shape)
        # dim 0 is the group axis, dim 1 the batch; k/v are (groups,
        # batch, seq, kv_heads, head_dim)
        if len(shape) >= 2 and _divides(shape[1], mesh, baxes):
            spec[1] = baxes
        if name in ("k", "v") and len(shape) >= 4:
            if _divides(shape[3], mesh, "model"):
                spec[3] = "model"           # kv heads over TP
            elif _divides(shape[2], mesh, "model"):
                spec[2] = "model"           # the sequence, where they don't
            if spec[1] is None and _divides(shape[2], mesh, "data") \
                    and spec[2] is None:
                spec[2] = "data"            # batch of one: seq over data
        elif name in ("ssm", "wkv", "conv", "last") and len(shape) >= 3 \
                and _divides(shape[2], mesh, "model"):
            spec[2] = "model"
        return P(*spec)

    def walk(tree):
        return {k: walk(v) if isinstance(v, Mapping) else leaf(k, v)
                for k, v in tree.items()}

    return walk(cache_shapes)


def _dp_total(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))


def microbatch_count(cfg: ModelConfig, batch: int, seq: int,
                     requested: Optional[int] = None,
                     dp_total: int = 1) -> int:
    """The reference's choice: the requested count, else the config's, else
    microbatches of at most ~32k tokens a data-parallel rank."""
    if requested:
        return requested
    if cfg.num_microbatches:
        return cfg.num_microbatches
    per_dev_tokens = (batch // dp_total) * seq
    return max(1, min(batch // dp_total or 1, -(-per_dev_tokens // 32768)))


# ---------------------------------------------------------------------------
# Placement on a mesh
# ---------------------------------------------------------------------------

def _place(x, spec: PartitionSpec, mesh):
    """``x`` on ``mesh`` placed by ``spec``: a DTensor redistributed, a
    plain tensor (the same on every rank) distributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = spec.placements(mesh)
    if isinstance(x, DTensor):
        if list(x.placements) == placements:
            return x
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements)


def _mesh_scope(mesh):
    """Where the steps run on a mesh: plain tensors (token ids, positions,
    the step counter) meet DTensors as replicated ones."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _mesh_device(mesh, device) -> Optional[torch.device]:
    """Where a step runs: ``device`` (the CUDA card unless given) without a
    mesh, the mesh's device type on one, None on a duck-typed mesh (its
    specs only)."""
    if mesh is None:
        return resolve_device(device)
    kind = getattr(mesh, "device_type", None)
    return None if kind is None else torch.device(kind)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

#: the axis sizes of a 1 x 1 ``("data", "model")`` mesh: the specs of a
#: step without a mesh, which has nothing to shard
_ONE_BY_ONE = SimpleNamespace(shape={"data": 1, "model": 1})


def make_train_step(cfg: ModelConfig, mesh=None, *,
                    num_microbatches: Optional[int] = None,
                    grad_dtype=torch.bfloat16,
                    opt_state_dtype: Optional[str] = None,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, device=None):
    """Returns ``(train_step, specs)``.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  Without ``mesh`` it runs on ``device`` (the CUDA card
    unless given), where the parameters and moments must lie.  With a
    ``mesh`` (a ``DeviceMesh`` with named dims among ``pod``, ``data`` and
    ``model``) every rank calls it with the parameters and moments as
    DTensors placed by ``specs["params"]`` and ``specs["opt"]``
    (``distributed.sharding.shard_tree``) and the whole batch; the
    microbatches are resharded over the data axes, the accumulators and
    gradients pinned to the parameters' placements and the activations,
    logits and MoE dispatch constrained, as the reference does.  ``batch``
    holds ``tokens`` and ``labels`` (tensors or numpy arrays, as
    ``data.SyntheticLM`` makes them) and ``frames`` / ``patch_embeds``
    where the model takes them.  The step updates ``params`` and
    ``opt_state``'s moments in place and returns them (the reference's
    jitted step donates both); ``metrics`` holds ``loss`` (the mean over
    the microbatches) and ``lr``, float32 0-d tensors (plain ones on a
    mesh too).

    ``specs`` holds ``params`` and ``opt`` (the parameters' and moments'
    ``PartitionSpec`` trees under ``RULES_TRAIN``: over ``mesh``, or
    without one over a 1 x 1 ``("data", "model")`` mesh), ``pshapes`` and
    ``oshapes`` (the parameters and moments as ``meta`` tensors) and
    ``axes`` (the parameters' logical axes)."""
    if opt_state_dtype is None:
        opt_state_dtype = cfg.opt_state_dtype
    device = _mesh_device(mesh, device)
    sized = _ONE_BY_ONE if mesh is None else mesh
    dp_total = _dp_total(sized)
    bspec = batch_spec(sized)
    sizes = mesh_axis_sizes(sized)
    pshapes, axes = abstract_params(cfg)
    pspecs = params_specs(pshapes, axes, RULES_TRAIN, sized)

    def reshard(x, n_micro, bm):
        if n_micro > 1 and mesh is not None and _is_dtensor(x):
            # a batch already placed over the data axes (a dry run's):
            # whole first, so microbatch i is rows [i·bm, (i+1)·bm) of the
            # batch, as from a whole batch
            x = _place(x, P(*([None] * x.ndim)), mesh)
        mb = x.reshape(n_micro, bm, *x.shape[1:])
        if mesh is None:
            return mb
        return _place(mb, P(None, bspec[0], *([None] * (x.ndim - 1))), mesh)

    def pin(leaves, specs):
        if mesh is None:
            return leaves
        return [_place(t, s, mesh) for t, s in zip(leaves, specs)]

    def constrain(tag, x):
        baxis = bspec[0] if x.shape[0] % dp_total == 0 else None
        model = sizes["model"]
        if tag == "logits":
            vocab_ax = "model" if x.shape[-1] % model == 0 else None
            return _place(x, P(baxis, None, vocab_ax), mesh)
        if tag == "unembed_w":
            vocab_ax = "model" if x.shape[-1] % model == 0 else None
            return _place(x, P(None, vocab_ax), mesh)
        if tag == "moe_dispatch":       # (groups, s_g, experts, cap)
            e_ax = "model" if x.shape[2] % model == 0 else None
            return _place(x, P(baxis, None, e_ax, None), mesh)
        if tag == "moe_expert":         # (experts, groups, cap, d)
            e_ax = "model" if x.shape[0] % model == 0 else None
            g_ax = bspec[0] if x.shape[1] % dp_total == 0 else None
            return _place(x, P(e_ax, g_ax, None, None), mesh)
        if tag == "activation":
            # sequence parallelism: layer-boundary activations shard their
            # sequence over the model axis
            seq_ax = "model" if (x.ndim == 3
                                 and x.shape[1] % model == 0) else None
            return _place(x, P(baxis, seq_ax, None), mesh)
        return x

    def train_step(params, opt_state, batch):
        b, seq = batch["tokens"].shape[:2]
        n_micro = microbatch_count(cfg, b, seq, num_microbatches, dp_total)
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             "microbatches")
        bm = b // n_micro
        paths = [path for path, _ in _paths(params)]
        leaves = [leaf for _, leaf in _paths(params)]
        specs = [s for _, s in _paths(pspecs)]
        if device is None or leaves[0].device.type != device.type:
            raise ValueError(f"train_step runs on {device}; the parameters "
                             f"lie on {leaves[0].device}")
        with _mesh_scope(mesh):
            micro = {k: reshard(_on(leaves[0].device, v), n_micro, bm)
                     for k, v in batch.items()}
            acc = pin([torch.zeros(p.shape, dtype=grad_dtype,
                                   device=p.device) if mesh is None
                       else _zeros(p, grad_dtype) for p in leaves], specs)
            losses = []
            for i in range(n_micro):
                mb = {k: v[i] for k, v in micro.items()}
                with trace.span("train_step.forward_backward"), \
                        torch.enable_grad():
                    flat = [p.detach().requires_grad_() for p in leaves]
                    loss, _ = lm_loss(
                        _unflatten(paths, flat), mb, cfg,
                        constrain=None if mesh is None else constrain)
                    # a leaf the loss does not read (an encoder without
                    # frames) gets zeros, as under jax.grad
                    grads = pin(list(torch.autograd.grad(
                        loss, flat, allow_unused=True,
                        materialize_grads=True)), specs)
                del flat
                with trace.span("train_step.accumulate"):
                    for j, a in enumerate(acc):
                        a.add_(grads[j].to(grad_dtype))
                        grads[j] = None     # the float32 gradient freed
                losses.append(_plain(loss.detach()))
            lr = cosine_warmup(opt_state.step, peak_lr=peak_lr,
                               warmup=warmup, total=total_steps)
            with trace.span("train_step.adamw"):
                params, opt_state = adamw_update(
                    params, _unflatten(paths, acc), opt_state, lr=lr,
                    grad_scale=1.0 / n_micro)
        return params, opt_state, {"loss": torch.stack(losses).mean(),
                                   "lr": lr}

    oshapes = adamw_init(pshapes, state_dtype=opt_state_dtype)
    ospecs = opt_state_specs(oshapes, pspecs, sized)
    return train_step, {"params": pspecs, "opt": ospecs, "pshapes": pshapes,
                        "oshapes": oshapes, "axes": axes}


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _zeros(like, dtype):
    """Zeros of ``like``'s global shape placed as ``like`` is (a DTensor)."""
    from torch.distributed.tensor import zeros
    return zeros(like.shape, dtype=dtype, device_mesh=like.device_mesh,
                 placements=like.placements)


def _plain(x) -> torch.Tensor:
    """A DTensor's whole value on every rank; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _on(device, x) -> torch.Tensor:
    """A batch entry (a tensor or a numpy array) on ``device``: token ids
    as given (the model reads them as int64), frames and patch embeddings
    as given (the model casts them)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def make_serve_steps(cfg: ModelConfig, mesh, max_seq: int, batch: int):
    """Returns ``(prefill, decode, specs)`` on ``mesh``.

    ``prefill(params, inputs) -> (logits, cache)`` runs the prompt
    (``inputs`` holds ``tokens`` and, where the model takes them,
    ``frames`` / ``patch_embeds``, or the encoder's output of the frames
    as ``enc_out``) into caches placed by
    ``specs["cache"]``; ``decode(params, cache, token, enc_out=None) ->
    (logits, cache)`` runs one token.  Every rank calls them with the
    parameters as DTensors placed by ``specs["params"]`` (``RULES_SERVE``)
    and the whole inputs; the logits are DTensors.  They run eagerly (a
    DTensor's collectives are not captured in a CUDA graph).  ``specs``
    also holds ``pshapes``, ``cshapes`` (``meta`` tensors) and ``axes``."""
    cshapes = init_cache(cfg, batch, max_seq, dtype=cfg.compute_dtype,
                         device="meta")
    cspecs = cache_specs(cshapes, mesh, batch)

    def pin_cache(tree):
        return _map_specs(lambda s, t: _place(t, s, mesh), cspecs, tree)

    def prefill(params, inputs):
        with _mesh_scope(mesh):
            return serve_prefill(params, inputs["tokens"], cfg, max_seq,
                                 frames=inputs.get("frames"),
                                 patch_embeds=inputs.get("patch_embeds"),
                                 enc_out=inputs.get("enc_out"),
                                 pin_cache=pin_cache)

    def decode(params, cache, token, enc_out=None):
        with _mesh_scope(mesh):
            return serve_decode(params, cache, token, cfg, enc_out=enc_out)

    pshapes, axes = abstract_params(cfg)
    pspecs = params_specs(pshapes, axes, RULES_SERVE, mesh)
    specs = {"params": pspecs, "cache": cspecs, "pshapes": pshapes,
             "cshapes": cshapes, "axes": axes}
    return prefill, decode, specs
