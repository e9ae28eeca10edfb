"""Device meshes over ``torch.distributed``, and where sharded data lives.

The reference is one controller over N devices (a 1-D ``jax.sharding.
Mesh``, sharded bases as global arrays).  The port is SPMD: every rank
runs the same program and records the same tape, and the mesh is a 1-D
``DeviceMesh`` over the ranks with axis ``"dev"`` (:data:`DEFAULT_AXIS`).
:func:`topology_key` canonicalizes a mesh into the hashable tuple the
merge cache mixes into ``tape_signature``, so plans computed under one
rank count are never replayed under another.

Where sharded data lives between blocks: a base whose placement the mesh
can hold (:func:`held_sharded`: dim-0 block sharding, one chunk a rank)
is a ``DTensor`` with ``Shard(0)`` in the executor's store, each rank
holding its contiguous chunk (:func:`as_sharded`); everything else is a
whole tensor on every rank.  :func:`all_gather` is the one collective
(``all_gather_into_tensor``); under gloo it stages a CUDA tensor through
the host, as gloo gathers host memory only.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch
import torch.distributed as tdist

from ..device import resolve_device

DEFAULT_AXIS = "dev"

# dtypes the collectives do not carry, sent as the signed type of their
# width (the bits travel unchanged)
_WIRE = {torch.bool: torch.uint8, torch.uint16: torch.int16,
         torch.uint32: torch.int32, torch.uint64: torch.int64}


def world_size() -> int:
    """Ranks of the current process group (1 when none is up)."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def host_mesh(n: Optional[int] = None, axis: str = DEFAULT_AXIS,
              device=None):
    """A 1-D ``DeviceMesh`` over the first ``n`` ranks of the world (all
    by default), on the CUDA card unless given ``device="cpu"``.

    With no process group up it starts a world of one over an in-process
    store: NCCL on the card, gloo on the CPU.  On the card each rank uses
    device ``rank % device_count`` (so ranks share a card when there are
    more ranks than cards, which only gloo allows).  Raises when asked for
    more ranks than the world has, or for a CPU mesh over a group that is
    not gloo."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no mesh on device {dev}")
    if not tdist.is_initialized():
        tdist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                 store=tdist.HashStore(), rank=0,
                                 world_size=1)
    world = tdist.get_world_size()
    if n is None:
        n = world
    if n > world:
        raise ValueError(f"asked for {n} ranks, the world has {world}")
    if dev.type == "cpu" and tdist.get_backend() != "gloo":
        raise ValueError(f"a CPU mesh needs gloo, the group runs "
                         f"{tdist.get_backend()}")
    if dev.type == "cuda":
        torch.cuda.set_device(tdist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(dev.type, list(range(n)), mesh_dim_names=(axis,))


def topology_key(mesh) -> Tuple:
    """Hashable mesh identity: axis names/sizes plus the device type."""
    if mesh is None:
        return ()
    axes = tuple((str(name), int(size))
                 for name, size in zip(mesh.mesh_dim_names, mesh.shape))
    return axes + (str(mesh.device_type),)


def host_staged(mesh) -> bool:
    """Whether the mesh's collectives stage through the host: CUDA data
    over gloo (the functional check of several ranks on one card)."""
    return (mesh.device_type == "cuda"
            and tdist.get_backend(mesh.get_group()) == "gloo")


def all_gather(local: torch.Tensor, mesh) -> torch.Tensor:
    """The whole flat tensor from every rank's contiguous chunk, in rank
    order: one ``all_gather_into_tensor`` over the mesh's group.  A failed
    collective raises."""
    group = mesh.get_group()
    wire = _WIRE.get(local.dtype)
    src = local.contiguous()
    if wire is not None:
        src = src.view(wire)
    staged = src.is_cuda and host_staged(mesh)
    if staged:
        src = src.cpu()
    out = torch.empty(mesh.size() * src.numel(), dtype=src.dtype,
                      device=src.device)
    with warnings.catch_warnings():   # renamed, not removed, in torch 2.13
        warnings.simplefilter("ignore", FutureWarning)
        tdist.all_gather_into_tensor(out, src, group=group)
    if staged:
        out = out.to(local.device)
    if wire is not None:
        out = out.view(local.dtype)
    return out


def held_sharded(base, n_dev: int) -> bool:
    """Whether the store holds ``base`` as one chunk a rank: a dim-0 block
    sharding over all ``n_dev`` ranks that divides evenly."""
    from .spec import spec_of
    s = spec_of(base)
    return (s is not None and s.sharded_dim == 0 and s.divides()
            and s.n_shards == n_dev and base.size % n_dev == 0)


def is_sharded(buf) -> bool:
    """Whether a store entry is a sharded (``DTensor``) buffer."""
    return hasattr(buf, "to_local")


def as_sharded(local: torch.Tensor, mesh):
    """This rank's chunk as the ``Shard(0)`` DTensor the store holds (no
    communication)."""
    from torch.distributed.tensor import DTensor, Shard
    return DTensor.from_local(local, mesh, [Shard(0)], run_check=False)


def whole(buf) -> torch.Tensor:
    """A store entry as the whole flat tensor (one all-gather for a sharded
    buffer, the tensor itself otherwise)."""
    if is_sharded(buf):
        return all_gather(buf.to_local(), buf.device_mesh)
    return buf


def chunk_of(buf, mesh) -> torch.Tensor:
    """This rank's contiguous chunk of a store entry: a sharded buffer's
    local tensor, else the rank's slice of the whole tensor."""
    if is_sharded(buf):
        return buf.to_local()
    n, r = mesh.size(), mesh.get_local_rank()
    c = buf.numel() // n
    return buf[r * c:(r + 1) * c]
