"""Logical-axis sharding rules (MaxText-style, minimal): the port's copy of
``repro.distributed.sharding``.

Every parameter leaf carries a tuple of logical axis names (from the model
init); rules map logical names to mesh axes.  ``logical_to_mesh`` is
shape-aware: a dimension that does not divide evenly by its mesh-axis size
falls back to replication (e.g. starcoder2's 2 kv-heads on a 16-way model
axis).

Training rules implement FSDP(ZeRO-3)×TP×EP: the "embed" (d_model) dimension
shards over the data axis while heads/ffn/vocab/experts shard over the
model axis.  Serving rules use pure TP (+EP over model, expert-ffn over
data for the 235B MoE so its experts span the whole mesh).

PyTorch has no ``PartitionSpec``, so :class:`PartitionSpec` is the port's
own: one entry per tensor dimension (None, an axis name, or a tuple of
names), convertible to DTensor placements on a real ``DeviceMesh``
(:meth:`PartitionSpec.placements`).  Everything but :func:`shard_tree`
only reads the mesh's axis sizes (:func:`mesh_axis_sizes`), so a
duck-typed mesh whose ``shape`` maps axis to size serves as well.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

RULES_TRAIN: Dict[str, Any] = {
    "embed": "data",            # FSDP / ZeRO-3 over the data axis
    "vocab": "model",
    # The embedding TABLE keeps its vocab dim unsharded (a gather over a
    # row-sharded table would all-gather the whole table) and shards
    # d_model over the model axis instead: the token gather is then
    # shard-local.
    "vocab_table": None,
    "embed_table": "model",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "expert": "model",          # expert parallelism
    "expert_ffn": None,
    "mamba_inner": "model",
    "layers": None,             # the layer-stack axis is never sharded
}

RULES_SERVE: Dict[str, Any] = {
    "embed": None,
    "vocab": "model",
    "vocab_table": None,
    "embed_table": "model",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "expert": "model",
    "expert_ffn": "data",       # 2-D expert sharding for the 235B serve fit
    "mamba_inner": "model",
    "layers": None,
}


class PartitionSpec(tuple):
    """Per-dimension mesh axes of one tensor: each entry is None
    (replicated), an axis name, or a tuple of axis names; trailing
    dimensions past the entries are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def placements(self, mesh) -> list:
        """DTensor placements on ``mesh`` (a ``DeviceMesh`` with named
        dimensions): ``Shard(d)`` on each mesh dimension some tensor
        dimension ``d`` names, ``Replicate()`` on the others."""
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(mesh.mesh_dim_names or ())
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    out[names.index(axis)] = Shard(d)
        return out


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh: a ``DeviceMesh``'s named dimensions, or
    any object whose ``shape`` maps axis to size."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {str(k): int(v) for k, v in shape.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("a mesh without named dimensions has no axes")
    return {str(k): int(v) for k, v in zip(names, shape)}


def _axis_size(sizes: Dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def logical_to_mesh(shape: Tuple[int, ...], logical: Tuple, rules: Dict,
                    mesh) -> PartitionSpec:
    """PartitionSpec for one leaf, dropping non-divisible dims to None."""
    sizes = mesh_axis_sizes(mesh)
    spec = []
    used = set()
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name is not None else None
        if axis is None or axis in used:
            spec.append(None)
            continue
        if dim % _axis_size(sizes, axis) != 0:
            spec.append(None)          # e.g. kv_heads=2 on a 16-way axis
            continue
        used.add(axis)
        spec.append(axis)
    return PartitionSpec(*spec)


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` trees share the
    structure; their leaves may be tuples, as the axes tree's are)."""
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def params_specs(param_shapes, axes_tree, rules: Dict, mesh):
    """Tree of PartitionSpec matching the params tree (each leaf has a
    ``shape``; ``axes_tree`` holds one tuple of logical names a leaf)."""
    return _tree_map(
        lambda leaf, ax: logical_to_mesh(tuple(leaf.shape), ax, rules, mesh),
        param_shapes, axes_tree)


def batch_spec(mesh) -> PartitionSpec:
    """Batch dimension shards over every data-parallel mesh axis present."""
    sizes = mesh_axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    return PartitionSpec(axes if len(axes) > 1 else axes[0])


def shard_tree(tree, specs, mesh):
    """Each tensor leaf of ``tree`` as a DTensor on ``mesh`` placed by its
    spec (``distribute_tensor``: every rank passes the whole leaf)."""
    from torch.distributed.tensor import distribute_tensor
    return _tree_map(
        lambda x, s: distribute_tensor(x, mesh, s.placements(mesh)),
        tree, specs)
