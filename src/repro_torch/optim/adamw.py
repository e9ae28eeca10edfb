"""AdamW with optionally 8-bit quantized moments: the port of
``repro/optim/adamw.py``.

The moments are stored as the reference stores them — float32, bfloat16,
channel-wise μ-law int8 (``{"q": int8 in the parameter's shape, "scale":
float32 absmax per row}``) or, for ``"factored"``, an Adafactor-style
rank-1 second moment (``{"row", "col"}``) — and the update is the same
chain in the same order: the global-norm clip, ``grad_scale``, bias
correction, decoupled weight decay, moments re-quantized every step.
Leaves are taken in the order ``jax.tree`` flattens a dict (sorted keys),
so the gradient norm sums them in the reference's order.

The update is elementwise but for the moments' row reductions (the int8
absmax and the factored means run over the last axis, the column mean
over the second-to-last), so a leaf stacked over a leading layer axis is
updated one layer at a time with the same result.  The new values are
written into the given parameters and moments (the reference's jitted
step donates them), so the float32 temporaries never exceed one layer's
slice and no second copy of the weights or moments is made.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device

QBLOCK = 256     # elements per quantization block
MU = 1e5         # μ-law companding constant (≈ bnb's dynamic-tree range)
_LOG1P_MU = math.log1p(MU)


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any            # tree of moments (quantized dicts or raw tensors)
    v: Any


def _quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Channel-wise μ-law int8, shape-preserving: ``q`` has ``x``'s shape,
    ``scale`` its rows' absmax (at least 1e-20).  ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    s = torch.clamp_min(absmax, 1e-20)
    y = torch.log1p(MU * torch.abs(x) / s) / _LOG1P_MU
    q = torch.round(127.0 * torch.sign(x) * y).to(torch.int8)
    return {"q": q, "scale": s.to(torch.float32)}


def _dequantize(d: Dict[str, torch.Tensor]) -> torch.Tensor:
    qf = d["q"].to(torch.float32)
    y = torch.abs(qf) / 127.0
    return torch.sign(qf) * (torch.expm1(y * _LOG1P_MU) / MU) * d["scale"]


def _is_q(x) -> bool:
    return isinstance(x, dict) and "q" in x and "scale" in x


def _is_factored(x) -> bool:
    return isinstance(x, dict) and "row" in x and "col" in x


def _is_leaf(x) -> bool:
    return not isinstance(x, dict) or _is_q(x) or _is_factored(x)


def _paths(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(key path, leaf)`` in the order ``jax.tree`` flattens a dict
    (sorted keys); a quantized or factored moment is one leaf."""
    if _is_leaf(tree):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _paths(tree[k], prefix + (k,))


def _leaves(tree) -> List[Any]:
    return [leaf for _, leaf in _paths(tree)]


def _unflatten(paths, leaves) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _zeros(p, shape, dtype, drop=(), move=None, fill=0.0):
    """``fill`` in ``shape`` on ``p``'s device; for a DTensor ``p`` a
    DTensor on its mesh, each rank holding its shard, placed as ``p`` is
    but for its dims in ``drop`` (replicated: the moment reduces them) and
    those ``move`` renumbers (a factored column moment's last dim)."""
    if not _is_dtensor(p):
        return torch.full(shape, fill, dtype=dtype, device=p.device)
    from torch.distributed.tensor import Replicate, Shard, full
    placements = []
    for pl in p.placements:
        if pl.is_shard() and pl.dim in drop:
            pl = Replicate()
        elif pl.is_shard() and move and pl.dim in move:
            pl = Shard(move[pl.dim])
        placements.append(pl)
    return full(shape, fill, dtype=dtype, device_mesh=p.device_mesh,
                placements=placements)


def adamw_init(params, *, state_dtype: str = "int8") -> OptState:
    """Zero moments on the parameters' device: ``"int8"`` quantizes a
    leaf with ``ndim >= 2`` and at least :data:`QBLOCK` elements (float32
    otherwise), ``"bf16"`` keeps ``ndim >= 2`` leaves in bfloat16,
    ``"factored"`` also factors the second moment of a leaf whose last two
    dims are at least 64, ``"f32"`` keeps float32.  On ``meta`` parameters
    the moments' shapes and dtypes only; on DTensor parameters (the model
    on a mesh) DTensor moments placed as ``launch.steps.opt_state_specs``
    places them, each rank allocating only its shard."""
    if state_dtype not in ("int8", "f32", "bf16", "factored"):
        raise ValueError(f"unknown optimizer state dtype {state_dtype!r}")

    def zero_like(p):
        if state_dtype in ("bf16", "factored") and p.ndim >= 2:
            return _zeros(p, p.shape, torch.bfloat16)
        if state_dtype == "int8" and p.ndim >= 2 and p.numel() >= QBLOCK:
            if _is_dtensor(p):
                # _quantize of zeros, each rank its shard: zero codes and
                # the floor 1e-20 as every row's scale
                return {"q": _zeros(p, p.shape, torch.int8),
                        "scale": _zeros(p, p.shape[:-1] + (1,),
                                        torch.float32, drop=(p.ndim - 1,),
                                        fill=1e-20)}
            return _quantize(torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device))
        return _zeros(p, p.shape, torch.float32)

    def zero_v(p):
        if state_dtype == "factored" and p.ndim >= 2 and \
                p.shape[-1] >= 64 and p.shape[-2] >= 64:
            # Adafactor-style rank-1 second moment: O(n+m) instead of O(nm)
            n = p.ndim
            return {"row": _zeros(p, p.shape[:-1], torch.float32,
                                  drop=(n - 1,)),
                    "col": _zeros(p, p.shape[:-2] + p.shape[-1:],
                                  torch.float32, drop=(n - 2,),
                                  move={n - 1: n - 2})}
        return zero_like(p)

    device = next(iter(_leaves(params))).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=_map(zero_like, params), v=_map(zero_v, params))


def state_from_numpy(tree, device=None):
    """The JAX package's optimizer state (an ``OptState`` or its ``(step,
    m, v)``; leaves as numpy arrays or anything ``np.asarray`` takes) as
    the port's, on ``device`` (the CUDA card unless given): the optimizer
    counterpart of ``models.transformer.params_from_numpy``.  A bfloat16
    leaf keeps its bits."""
    device = resolve_device(device)

    def leaf(x):
        arr = np.array(x)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device)

    step, m, v = tree
    return OptState(step=leaf(step), m=_map(leaf, m), v=_map(leaf, v))


def _update(p, g, m, v, *, scale, lr, b1, b2, eps, weight_decay, c1, c2):
    """One leaf's (or one layer slice's) AdamW step in the reference's
    order: ``(new p, new m, new v)``."""
    quant = _is_q(m)
    mdt = None if quant else m.dtype
    mf = _dequantize(m) if quant else m.to(torch.float32)
    gf = g.to(torch.float32) * scale
    mf = b1 * mf + (1 - b1) * gf
    mhat = mf / c1
    g2 = gf * gf
    del gf
    if _is_factored(v):
        row = b2 * v["row"] + (1 - b2) * torch.mean(g2, dim=-1)
        col = b2 * v["col"] + (1 - b2) * torch.mean(g2, dim=-2)
        vhat = (row[..., None] * col[..., None, :]
                / torch.clamp_min(torch.mean(row, dim=-1,
                                             keepdim=True)[..., None],
                                  1e-30)) / c2
        new_v = {"row": row, "col": col}
    else:
        vf = _dequantize(v) if _is_q(v) else v.to(torch.float32)
        vf = b2 * vf + (1 - b2) * g2
        vhat = vf / c2
        new_v = _quantize(vf) if _is_q(v) else vf.to(mdt)
        del vf
    del g2
    pf = p.to(torch.float32)
    pf = pf - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf)
    new_m = _quantize(mf) if quant else mf.to(mdt)
    return pf.to(p.dtype), new_m, new_v


def _write(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(src[k])
    else:
        dst.copy_(src)


def _slice(x, i):
    return {k: t[i] for k, t in x.items()} if isinstance(x, dict) else x[i]


def adamw_update(params, grads, state: OptState, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1,
                 grad_clip: Optional[float] = 1.0, grad_scale: float = 1.0):
    """Returns ``(params, new_state)``.  Global-norm clipping, decoupled
    weight decay, bias correction, moments re-quantized per step.

    The new values are written into ``params`` and the moments of
    ``state`` (the reference's jitted step donates both), a leaf stacked
    over a leading axis one slice at a time; ``params`` and a new
    ``OptState`` over the same moment trees are returned.  ``grads`` may
    be bf16 (the accumulator dtype): each leaf is cast to float32 on its
    own, never as a whole-tree float32 copy.  ``grad_scale`` folds the
    1/num_microbatches mean into the update.  ``lr`` is a float or a
    float32 0-d tensor (``cosine_warmup``'s)."""
    step = state.step + 1
    flat_g = _leaves(grads)
    if grad_clip is not None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in flat_g)) * grad_scale
        # a tensor numerator: a scalar over a tensor is its reciprocal
        # times the scalar in PyTorch, not the correctly rounded quotient
        scale = torch.clamp(torch.full_like(gnorm, grad_clip)
                            / torch.clamp_min(gnorm, 1e-12),
                            max=1.0) * grad_scale
    else:
        scale = grad_scale
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    kw = dict(scale=scale, lr=lr, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay, c1=c1, c2=c2)

    flat_p = _leaves(params)
    flat_m, flat_v = _leaves(state.m), _leaves(state.v)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"adamw_update: {len(flat_p)} parameters, "
                         f"{len(flat_g)} gradients, {len(flat_m)} and "
                         f"{len(flat_v)} moments")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        parts = [(p, g, m, v)] if p.ndim < 3 else [
            tuple(_slice(x, i) for x in (p, g, m, v))
            for i in range(p.shape[0])]
        for pi, gi, mi, vi in parts:
            for dst, src in zip((pi, mi, vi), _update(pi, gi, mi, vi, **kw)):
                _write(dst, src)
    return params, OptState(step=step, m=state.m, v=state.v)
