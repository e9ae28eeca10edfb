"""Communication-aware distributed fusion (the port's copy of
``repro.core.dist``).

The pieces layered over the trace→graph→partition→schedule→execute
pipeline:

* ``spec``     — ``ShardSpec``, the sharded-IR placement annotation;
* ``reshard``  — the resharding-insertion pass (explicit COMM graph nodes);
* ``cost``     — priced by ``CommCost`` in ``repro_torch.core.cost``
  (registered as ``"comm"``);
* ``mesh``     — ``host_mesh`` (a 1-D ``DeviceMesh`` over the ranks),
  ``topology_key`` and the store's sharded buffers;
* ``executor`` — ``DistBlockExecutor``; the ``shard_map`` backend lowers
  sharded blocks with real collectives.

``shard`` / ``reshard`` are the user-facing annotation APIs on lazy arrays.
"""

from __future__ import annotations

from typing import Optional

from ..ir import View
from .executor import DistBlockExecutor                      # noqa: F401
from .mesh import DEFAULT_AXIS, host_mesh, topology_key      # noqa: F401
from .mesh import world_size
from .reshard import (block_comm_bytes, comm_op_bytes,       # noqa: F401
                      insert_resharding, tape_has_sharding, _make_comm)
from .spec import ShardSpec, spec_of, view_aligned           # noqa: F401


def shard(arr, dim: int = 0, axis: str = DEFAULT_AXIS,
          n: Optional[int] = None):
    """Annotate a lazy array's base as block-sharded along ``dim`` over an
    ``n``-way mesh axis (``n``: the ranks of the current process group, 1
    when none is up).  Placement only — no data moves; the resharding pass
    and the executor act on the annotation at the next flush."""
    v = arr.view
    if not (v.offset == 0 and v.size == v.base.size and v.is_contiguous()):
        raise ValueError("can only annotate a whole-base contiguous array")
    if n is None:
        n = world_size()
    v.base.shard_spec = ShardSpec.for_dim(v.shape, dim, axis, n)
    return arr


def reshard(arr, spec: Optional[ShardSpec]):
    """Record an explicit placement cast as a COMM op and return the copy.

    sharded→replicated is an allgather, replicated→sharded a reduce-scatter
    (shard-local slice of already-complete data, zero fabric bytes), and
    sharded→sharded a ppermute.  Casting replicated→replicated is a no-op.
    """
    src = arr.view.base
    s = spec_of(src)
    dst_spec = None if spec is None or spec.is_replicated else spec
    if s is None and dst_spec is None:
        return arr
    if s is None:
        kind = "comm_reduce_scatter"
    elif dst_spec is None:
        kind = "comm_allgather"
    else:
        kind = "comm_ppermute"
    op, dst = _make_comm(kind, src, dst_spec)
    rt = arr.rt
    rt.record(op)
    v = arr.view
    from ..lazy import LazyArray     # local import: lazy imports this package
    return LazyArray(rt, View(dst, v.offset, v.shape, v.strides))
