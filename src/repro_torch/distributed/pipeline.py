"""Pipeline parallelism over a mesh axis (the GPipe schedule): the port of
``repro/distributed/pipeline.py``.

The multi-pod mesh's leading ``pod`` axis can run as a pipeline dimension
instead of pure data parallelism: layer groups split into ``n_stages``
contiguous stages, stage ``s`` on the ranks at position ``s`` of the axis.
Microbatches stream through the stages, each hop one activation a
microbatch (in place of a layer's parameter all-gathers).

The reference is ``shard_map`` over the axis with ``ppermute`` for the hop
and ``psum`` for the final broadcast.  The port is SPMD over the axis's
subgroup (``mesh.get_group(axis)``): ``m + S - 1`` steps, each one stage
application and one hop as paired ``isend``/``irecv``
(``batch_isend_irecv``) to stage ``(i + 1) % S``, then the last stage's
outputs all-reduced to every stage.  Under gloo a CUDA tensor is staged
through host memory (several ranks on one card, ``core.dist.mesh``).

The schedule's bubble fraction is ``(S - 1) / (M + S - 1)``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .sharding import _tree_map


def _stage_leaf(x, stage: int, mesh, axis: str):
    """This stage's slice of a leaf stacked over the stages: a DTensor
    sharded over ``axis`` on dim 0 holds one slice a stage; a plain tensor
    (the same on every rank) is indexed."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(x, DTensor):
        dim = mesh.mesh_dim_names.index(axis)
        if x.placements[dim] == Shard(0) and not any(
                p.is_shard() for i, p in enumerate(x.placements) if i != dim):
            return x.to_local()[0]
        x = x.full_tensor()
    return x[stage]


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   *, mesh, axis: str = "pod", n_microbatches: int = None):
    """Run ``stage_fn(params_for_stage, x_mb) -> x_mb`` as a pipeline over
    ``mesh``'s ``axis``; every rank calls it.

    ``stage_params``: a tensor, or nested dicts of them, with a leading
    dim of
    ``n_stages`` (plain tensors, or DTensors sharded over ``axis``).
    ``x``: ``(n_microbatches, mb, ...)`` microbatched input, the same on
    every rank.  Returns the ``(n_microbatches, mb, ...)`` outputs of the
    last stage, on every stage."""
    import torch.distributed as tdist
    from torch.distributed.tensor import DTensor
    from ..core.dist.mesh import host_staged
    if isinstance(x, DTensor):
        x = x.full_tensor()
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    m = x.shape[0] if n_microbatches is None else n_microbatches
    if x.shape[0] != m:
        raise ValueError(f"x holds {x.shape[0]} microbatches, not {m}")
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    params = _tree_map(lambda a: _stage_leaf(a, stage, mesh, axis),
                       stage_params)
    staged = x.is_cuda and host_staged(mesh)
    nxt = tdist.get_global_rank(group, (stage + 1) % n_stages)
    prv = tdist.get_global_rank(group, (stage - 1) % n_stages)

    def hop(out):
        """``ppermute`` to the next stage: this stage's ``out`` sent, the
        previous stage's received."""
        if n_stages == 1:
            return out
        send = out.cpu() if staged else out.contiguous()
        recv = torch.empty_like(send)
        for work in tdist.batch_isend_irecv([
                tdist.P2POp(tdist.isend, send, nxt, group),
                tdist.P2POp(tdist.irecv, recv, prv, group)]):
            work.wait()
        return recv.to(x.device) if staged else recv

    buf = torch.zeros_like(x)                   # outputs (last stage)
    carry = torch.zeros_like(x[0])              # the activation in flight
    for t in range(m + n_stages - 1):
        mb = t - stage                          # this stage's microbatch
        active = 0 <= mb < m
        inp = x[mb] if stage == 0 and active else carry
        out = stage_fn(params, inp) if active else torch.zeros_like(carry)
        if active and stage == n_stages - 1:
            buf[mb] = out                       # the last stage banks it
        carry = hop(out)
    # the last stage's outputs to every stage: zeros elsewhere, then a sum
    if stage != n_stages - 1:
        buf.zero_()
    if n_stages > 1:
        red = buf.cpu() if staged else buf
        tdist.all_reduce(red, group=group)
        buf = red.to(x.device) if staged else red
    return buf


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
