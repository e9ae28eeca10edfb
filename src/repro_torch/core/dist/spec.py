"""ShardSpec — the sharded-IR placement annotation (the port's copy of
``repro.core.dist.spec``).

A ``ShardSpec`` describes how the canonical view of a ``BaseArray`` is laid
out across a device mesh: one mesh axis (or ``None`` = replicated) per
canonical dimension, plus the mesh geometry itself.  It is deliberately a
*logical* annotation — plain data, hashable, valid without any process
group — so the resharding pass, the ``comm`` cost model and the merge
cache can all reason about placement off-device; only the ``shard_map``
backend and the executor's store ever touch a ``DeviceMesh``.

``from_logical`` reuses the logical-axis rules machinery in
``repro_torch.distributed.sharding`` so model-layer annotations and
runtime-layer placement speak the same language.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

MeshShape = Tuple[Tuple[str, int], ...]          # sorted ((axis, size), ...)

# Process-wide "has any ShardSpec ever been constructed" latch.  The flush
# fast path consults it to skip the per-flush ``tape_has_sharding`` scan in
# the (overwhelmingly common) fully-local case; it never resets, so it can
# only err on the side of scanning.
_SPECS_SEEN = False


def sharding_ever_used() -> bool:
    return _SPECS_SEEN


@dataclass(frozen=True)
class ShardSpec:
    """Placement of a base's canonical view over a named mesh.

    ``shape``      — the canonical (logical) shape the sharding refers to;
    ``mesh_axes``  — one mesh-axis name (or None) per canonical dimension;
    ``mesh``       — the mesh geometry as sorted ``(axis, size)`` pairs.
    """

    shape: Tuple[int, ...]
    mesh_axes: Tuple[Optional[str], ...]
    mesh: MeshShape

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_axes):
            raise ValueError(
                f"mesh_axes {self.mesh_axes} must match shape {self.shape}")
        global _SPECS_SEEN
        _SPECS_SEEN = True

    # -- geometry ------------------------------------------------------
    def axis_size(self, axis: Optional[str]) -> int:
        if axis is None:
            return 1
        return dict(self.mesh).get(axis, 1)

    @property
    def n_shards(self) -> int:
        out = 1
        for a in self.mesh_axes:
            out *= self.axis_size(a)
        return out

    @property
    def sharded_dim(self) -> Optional[int]:
        """Index of the (single) sharded canonical dimension, or None."""
        for d, a in enumerate(self.mesh_axes):
            if a is not None and self.axis_size(a) > 1:
                return d
        return None

    @property
    def is_replicated(self) -> bool:
        return self.n_shards <= 1

    def chunk_shape(self) -> Tuple[int, ...]:
        """Per-device shape (sharded dims divided by their axis size)."""
        return tuple(s // self.axis_size(a) if a is not None else s
                     for s, a in zip(self.shape, self.mesh_axes))

    def divides(self) -> bool:
        """True when every sharded dim divides evenly by its axis size."""
        return all(a is None or s % self.axis_size(a) == 0
                   for s, a in zip(self.shape, self.mesh_axes))

    def drop_dim(self, dim: int) -> "ShardSpec":
        """Spec of a reduction output (the swept dimension removed)."""
        return ShardSpec(self.shape[:dim] + self.shape[dim + 1:],
                         self.mesh_axes[:dim] + self.mesh_axes[dim + 1:],
                         self.mesh)

    def placement_key(self) -> Tuple:
        """Hashable identity ignoring the concrete shape — two bases share
        a placement when their mesh axes and mesh geometry agree."""
        return (self.mesh_axes, self.mesh)

    # -- constructors --------------------------------------------------
    @staticmethod
    def replicated(shape: Tuple[int, ...], mesh: MeshShape = ()) -> "ShardSpec":
        return ShardSpec(tuple(shape), (None,) * len(shape), tuple(mesh))

    @staticmethod
    def for_dim(shape: Tuple[int, ...], dim: int, axis: str,
                n: int) -> "ShardSpec":
        """Shard one dimension over a single ``n``-way mesh axis."""
        axes = [None] * len(shape)
        axes[dim] = axis
        return ShardSpec(tuple(shape), tuple(axes), ((axis, n),))

    @staticmethod
    def from_logical(shape: Tuple[int, ...], logical: Tuple, rules: Dict,
                     mesh) -> "ShardSpec":
        """Build a spec from logical axis names via the model-layer rules
        (``repro_torch.distributed.sharding.logical_to_mesh``); ``mesh`` is
        a ``DeviceMesh`` or anything whose ``shape`` maps axis to size."""
        from ...distributed.sharding import logical_to_mesh, mesh_axis_sizes
        pspec = logical_to_mesh(tuple(shape), logical, rules, mesh)
        axes = []
        for entry in tuple(pspec):
            if isinstance(entry, tuple):       # multi-axis dim: collapse to
                entry = entry[0] if entry else None   # its leading axis
            axes.append(entry)
        axes += [None] * (len(shape) - len(axes))
        mesh_shape = tuple(sorted(mesh_axis_sizes(mesh).items()))
        return ShardSpec(tuple(shape), tuple(axes), mesh_shape)


def spec_of(base) -> Optional[ShardSpec]:
    """The base's ShardSpec, treating 1-way shardings as replicated."""
    spec = getattr(base, "shard_spec", None)
    if spec is None or spec.is_replicated:
        return None
    return spec


def placement_digest(ops) -> Tuple[Optional[Tuple], ...]:
    """Placement of every base an op sequence touches, in first-occurrence
    order (the canonical numbering ``block_signature`` uses), with 1-way
    shardings normalized to replicated.  THE placement identity for cache
    keys: ``cache.tape_signature`` and the executor's executable-cache key
    on a mesh both use it."""
    digest, seen = [], set()
    for op in ops:
        for v in (*op.in_views(), *op.out_views()):
            u = v.base.uid
            if u not in seen:
                seen.add(u)
                spec = spec_of(v.base)
                digest.append(None if spec is None else spec.placement_key())
    return tuple(digest)


def view_aligned(view, spec: Optional[ShardSpec]) -> bool:
    """Can ``view`` be served shard-locally under ``spec`` with no data
    movement?  Replicated data serves anything; sharded data serves only
    whole-base contiguous views whose leading canonical dimension is the
    sharded one and divides evenly (chunks are then contiguous in the flat
    base, so per-device windows are plain slices)."""
    if spec is None or spec.is_replicated:
        return True
    if spec.sharded_dim != 0 or not spec.divides():
        return False
    return (view.offset == 0 and view.size == view.base.size
            and view.is_contiguous()
            and len(view.shape) > 0
            and view.shape[0] % spec.n_shards == 0)
