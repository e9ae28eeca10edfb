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

:class:`HostStagedGroup` (backend :data:`HOST_STAGED`) does the same for
every collective DTensor issues (the model on a mesh, ``launch/steps.py``)
when several ranks share one card: NCCL refuses two ranks a device.
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
    over gloo or :data:`HOST_STAGED` (the functional check of several
    ranks on one card)."""
    return (mesh.device_type == "cuda" and tdist.get_backend(
        mesh.get_all_groups()[0]) in ("gloo", HOST_STAGED))


#: the backend name of :class:`HostStagedGroup`
HOST_STAGED = "hoststaged"

#: what this process's :class:`HostStagedGroup` collectives moved: kind ->
#: ``[calls, bytes]``, the bytes of this rank's inputs (a measurement of
#: the staged path, not of a fabric)
STAGED = {}


def _count(kind: str, tensors) -> None:
    entry = STAGED.setdefault(kind, [0, 0])
    entry[0] += 1
    entry[1] += sum(t.numel() * t.element_size() for t in tensors)


def _done(result=None):
    """A finished ``Work`` (the collective ran synchronously)."""
    from torch._C._distributed_c10d import _create_work_from_future
    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


class HostStagedGroup(tdist.ProcessGroup):
    """A process group whose collectives copy CUDA tensors to host memory,
    run gloo's collective there and copy the results back: several ranks
    on one card, where NCCL refuses two ranks a device and gloo's own
    collectives do not all take CUDA tensors.  DTensor's collectives (the
    model on a mesh) reach it through the backend's name,
    :data:`HOST_STAGED` (:func:`register_host_staged`).  Every collective
    is synchronous; its walls are host copies and gloo, not a fabric."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = tdist.ProcessGroupGloo(store, rank, size, timeout)

    def getBackendName(self) -> str:
        return HOST_STAGED

    @property
    def group_name(self) -> str:
        return tdist.distributed_c10d._world.pg_names[self]

    @staticmethod
    def _host(ts):
        return [t.detach().cpu() if t.is_cuda else t for t in ts]

    @staticmethod
    def _back(dsts, hosts) -> None:
        for d, h in zip(dsts, hosts):
            if d is not h:
                d.copy_(h)

    def allreduce(self, tensors, opts=None):
        _count("all_reduce", tensors)
        hosts = self._host(tensors)
        self._gloo.allreduce(hosts, opts or tdist.AllreduceOptions()).wait()
        self._back(tensors, hosts)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        return self.allreduce(tensors)

    def barrier(self, opts=None):
        self._gloo.barrier(opts or tdist.BarrierOptions()).wait()
        return _done()

    def broadcast(self, tensors, opts=None):
        _count("broadcast", tensors)
        hosts = self._host(tensors)
        self._gloo.broadcast(hosts, opts or tdist.BroadcastOptions()).wait()
        self._back(tensors, hosts)
        return _done(tensors)

    def allgather(self, output_lists, inputs, opts=None):
        _count("all_gather", inputs)
        outs = [self._host(o) for o in output_lists]
        self._gloo.allgather(outs, self._host(inputs)).wait()
        for dsts, hosts in zip(output_lists, outs):
            self._back(dsts, hosts)
        return _done(output_lists)

    def _allgather_base(self, output, input, opts=None):
        self.allgather([list(output.chunk(self.size()))], [input])
        return _done(output)

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i)
        return _done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def _reduce_scatter_base(self, output, input, opts=None):
        """The sum over every rank of ``input``, this rank's chunk of it
        kept (an all-reduce on the host, then a slice)."""
        _count("reduce_scatter", [input])
        whole = input.detach().cpu().clone()
        red = tdist.AllreduceOptions()
        if opts is not None:
            red.reduceOp = opts.reduceOp
        self._gloo.allreduce([whole], red).wait()
        output.copy_(whole.chunk(self.size())[self.rank()])
        return _done(output)

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter(self, outputs, input_lists, opts=None):
        for o, ins in zip(outputs, input_lists):
            self._reduce_scatter_base(o, torch.cat([t.reshape(-1)
                                                    for t in ins]), opts)
        return _done(outputs)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return _done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    def alltoall_base(self, output, input, output_splits, input_splits,
                      opts=None):
        _count("all_to_all", [input])
        host_out = output.detach().cpu() if output.is_cuda else output
        self._gloo.alltoall_base(host_out, input.detach().cpu(),
                                 output_splits or [], input_splits or [],
                                 tdist.AllToAllOptions()).wait()
        self._back([output], [host_out])
        return _done(output)

    all_to_all_single = alltoall_base

    def alltoall(self, outputs, inputs, opts=None):
        _count("all_to_all", inputs)
        host_out = self._host(outputs)
        self._gloo.alltoall(host_out, self._host(inputs),
                            tdist.AllToAllOptions()).wait()
        self._back(outputs, host_out)
        return _done(outputs)

    def scatter(self, outputs, input_lists, opts=None):
        _count("scatter", outputs)
        host_out = self._host(outputs)
        self._gloo.scatter(host_out, [self._host(i) for i in input_lists],
                           opts or tdist.ScatterOptions()).wait()
        self._back(outputs, host_out)
        return _done(outputs)

    def gather(self, output_lists, inputs, opts=None):
        outs = [self._host(o) for o in output_lists]
        self._gloo.gather(outs, self._host(inputs),
                          opts or tdist.GatherOptions()).wait()
        for dsts, hosts in zip(output_lists, outs):
            self._back(dsts, hosts)
        return _done(output_lists)

    def send(self, tensors, dst: int, tag: int = 0):
        _count("send", tensors)
        # not waited for: a ring of sends (a pipeline's hop) completes only
        # once every rank has posted its receive
        return self._gloo.send(self._host(tensors), dst, tag)

    def recv(self, tensors, src: int, tag: int = 0):
        hosts = self._host(tensors)
        return _Received(self._gloo.recv(hosts, src, tag), tensors, hosts)


class _Received(tdist.Work):
    """A staged receive: gloo's, then the host copies written back to the
    CUDA tensors when it is waited for."""

    def __init__(self, work, tensors, hosts):
        super().__init__()
        self._work, self._tensors, self._hosts = work, tensors, hosts

    def wait(self, timeout=None) -> bool:
        self._work.wait()
        HostStagedGroup._back(self._tensors, self._hosts)
        return True


def register_host_staged() -> None:
    """Make :data:`HOST_STAGED` a backend ``init_process_group`` takes
    (once a process)."""
    if HOST_STAGED.upper() in tdist.Backend._plugins:
        return
    tdist.Backend.register_backend(
        HOST_STAGED, lambda store, rank, size, timeout: HostStagedGroup(
            store, rank, size, timeout), devices=["cpu", "cuda"])


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
