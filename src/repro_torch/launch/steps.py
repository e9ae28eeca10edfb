"""The train step: the port of ``repro/launch/steps.py``'s
``make_train_step`` for one card, without a mesh.

The recipe is the reference's: the batch split into microbatches, each
microbatch's gradients (float32, by autograd through ``lm_loss``) cast to
``grad_dtype`` and added into ``grad_dtype`` accumulators that start at
zero, then the cosine-warmup learning rate of the optimizer's step and one
AdamW update with ``grad_scale = 1 / n_micro`` (the microbatch mean folded
into the update, no whole-tree float32 copy).  The model rematerializes
its layer groups when ``cfg.remat`` is set.

What needs the model on the mesh waits for it (ROADMAP A10b-iii): the
sharding pins of the accumulator, batch and activations, the partition
specs of the parameters and moments (the rules and ``params_specs`` are
in ``repro_torch.distributed.sharding``), and the serve steps.  ``specs``
holds the parameters' and moments' shapes (``meta`` tensors) only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..core.device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import abstract_params, lm_loss
from ..optim.adamw import _paths, _unflatten, adamw_init, adamw_update
from ..optim.schedule import cosine_warmup


def microbatch_count(cfg: ModelConfig, batch: int, seq: int,
                     requested: Optional[int] = None) -> int:
    """The reference's choice with one data-parallel rank: the requested
    count, else the config's, else microbatches of at most ~32k tokens."""
    if requested:
        return requested
    if cfg.num_microbatches:
        return cfg.num_microbatches
    return max(1, min(batch or 1, -(-(batch * seq) // 32768)))


def make_train_step(cfg: ModelConfig, *,
                    num_microbatches: Optional[int] = None,
                    grad_dtype=torch.bfloat16,
                    opt_state_dtype: Optional[str] = None,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, device=None):
    """Returns ``(train_step, specs)``.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` runs on ``device`` (the CUDA card unless given), where the
    parameters and moments must lie; ``batch`` holds ``tokens``
    and ``labels`` (tensors or numpy arrays, as ``data.SyntheticLM``
    makes them) and ``frames`` / ``patch_embeds`` where the model takes
    them.  The step updates ``params`` and ``opt_state``'s moments in
    place and returns them (the reference's jitted step donates both);
    ``metrics`` holds ``loss`` (the mean over the microbatches) and ``lr``,
    float32 0-d tensors.  ``specs`` holds ``pshapes`` and ``oshapes``:
    the parameters and moments as ``meta`` tensors."""
    if opt_state_dtype is None:
        opt_state_dtype = cfg.opt_state_dtype
    device = resolve_device(device)

    def train_step(params, opt_state, batch):
        b, seq = batch["tokens"].shape[:2]
        n_micro = microbatch_count(cfg, b, seq, num_microbatches)
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             "microbatches")
        bm = b // n_micro
        paths = [path for path, _ in _paths(params)]
        leaves = [leaf for _, leaf in _paths(params)]
        if leaves[0].device.type != device.type:
            raise ValueError(f"train_step runs on {device}; the parameters "
                             f"lie on {leaves[0].device}")
        batch = {k: _on(leaves[0].device, v) for k, v in batch.items()}
        acc = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
               for p in leaves]
        losses = []
        for i in range(n_micro):
            mb = {k: v[i * bm:(i + 1) * bm] for k, v in batch.items()}
            with record_function("train_step.forward_backward"), \
                    torch.enable_grad():
                flat = [p.detach().requires_grad_() for p in leaves]
                loss, _ = lm_loss(_unflatten(paths, flat), mb, cfg)
                # a leaf the loss does not read (an encoder without
                # frames) gets zeros, as under jax.grad
                grads = list(torch.autograd.grad(
                    loss, flat, allow_unused=True, materialize_grads=True))
            del flat
            with record_function("train_step.accumulate"):
                for j, a in enumerate(acc):
                    a.add_(grads[j].to(grad_dtype))
                    grads[j] = None         # the float32 gradient freed
            losses.append(loss.detach())
        lr = cosine_warmup(opt_state.step, peak_lr=peak_lr, warmup=warmup,
                           total=total_steps)
        with record_function("train_step.adamw"):
            params, opt_state = adamw_update(
                params, _unflatten(paths, acc), opt_state, lr=lr,
                grad_scale=1.0 / n_micro)
        return params, opt_state, {"loss": torch.stack(losses).mean(),
                                   "lr": lr}

    pshapes = abstract_params(cfg)
    oshapes = adamw_init(pshapes, state_dtype=opt_state_dtype)
    return train_step, {"pshapes": pshapes, "oshapes": oshapes}


def _on(device, x) -> torch.Tensor:
    """A batch entry (a tensor or a numpy array) on ``device``: token ids
    as given (the model reads them as int64), frames and patch embeddings
    as given (the model casts them)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device)
