"""DistBlockExecutor — a ``BlockExecutor`` whose mesh defaults to the
host mesh (the port's copy of ``repro.core.dist.executor``).

``BlockExecutor(mesh=...)`` is the real constructor: a mesh prepends the
``shard_map`` backend to the stack, folds placement into the
executable-cache key and declares the collective/fabric-byte stats.  This
class survives for the reference's ``DistBlockExecutor(mesh=...)`` call
sites; it adds nothing beyond defaulting the mesh to :func:`host_mesh`
on the executor's device.
"""

from __future__ import annotations

from typing import Optional

from ..executor import BlockExecutor
from .mesh import host_mesh


class DistBlockExecutor(BlockExecutor):
    """``BlockExecutor`` with a mesh (default: every rank of the world)."""

    def __init__(self, mesh=None, axis: Optional[str] = None, **kw):
        super().__init__(mesh=mesh if mesh is not None
                         else host_mesh(device=kw.get("device")),
                         axis=axis, **kw)
