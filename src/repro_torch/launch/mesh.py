"""Mesh construction: the port of ``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
device state and starts no process group.

The reference's meshes are one controller's view of N devices; the port's
are named ``DeviceMesh``es over the ranks of a process group (SPMD, one
rank a device).  The production meshes need a world of exactly 256 or 512
ranks (on a smaller or larger one they raise; they never shrink), over
whatever group is up: NCCL or gloo ranks, or the fake process group
(``torch.testing._internal.distributed.fake_pg``) that a dry run traces
over.
"""

from __future__ import annotations

import math

from ..core.device import resolve_device


def _mesh(shape, axes, device):
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if not tdist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           "ranks; none is up")
    world = tdist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the world has "
                         f"{world}")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16×16 = 256 ranks a pod over ``("data", "model")``; ``multi_pod``
    adds a leading 2-pod axis: ``(2, 16, 16)`` over ``("pod", "data",
    "model")``.  On the CUDA card unless ``device`` names another type."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(device=None):
    """Every rank of the world (CPU smoke runs, one card, or ``torchrun``'s
    ranks): an ``(n, 1)`` mesh over ``("data", "model")``, on the CUDA card
    unless ``device="cpu"``.  With no process group up it starts a world of
    one, as ``core.dist.host_mesh`` does (NCCL on the card, gloo on the
    CPU)."""
    import torch.distributed as tdist
    from ..core.dist import host_mesh
    host_mesh(device=device)
    n = tdist.get_world_size()
    return _mesh((n, 1), ("data", "model"), device)


def launcher_mesh(device=None):
    """The launchers' mesh: :func:`make_host_mesh` when a process group of
    more than one rank is up, or ``torchrun``'s environment names a world
    of more than one (the group is then started from it: NCCL on the
    card, gloo on the CPU); else None: a world of one keeps the mesh-less
    path, which has nothing to shard (and on the card runs its steps as
    CUDA graphs)."""
    import os
    import torch.distributed as tdist
    if not tdist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        tdist.init_process_group(
            "nccl" if resolve_device(device).type == "cuda" else "gloo")
    if tdist.get_world_size() > 1:
        return make_host_mesh(device)
    return None
