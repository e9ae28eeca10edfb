"""Elastic scaling: resume a run on a different mesh: the port of
``repro/runtime/elastic.py``.

``CheckpointManager`` saves leaves whole, so elasticity is a re-shard:
:func:`reshard_params` re-derives the ``PartitionSpec``s for the new mesh
(the divisibility-aware rules adapt: a 4-way model axis becoming 2-way
changes which dims shard) and places every leaf there as a DTensor.

The trainer's flow on restart after a change of mesh (every rank):
    mesh = make_host_mesh()                          # the ranks now up
    train_step, specs = make_train_step(cfg, mesh)   # the new specs
    like = reshard_params(fresh_params, specs["axes"], mesh)
    step, params = ckpt.restore(None, like)
"""

from __future__ import annotations

from typing import Any

from ..distributed.sharding import (RULES_TRAIN, _tree_map, params_specs,
                                    shard_tree)


def reshard_params(params: Any, axes: Any, new_mesh,
                   rules=RULES_TRAIN) -> Any:
    """``params`` (plain tensors, the same on every rank, or DTensors on
    any mesh of the same ranks) as DTensors on ``new_mesh``, each placed by
    its spec under ``rules``.  A DTensor leaf is gathered whole first (a
    collective on its own mesh, so every rank calls this)."""
    from torch.distributed.tensor import DTensor

    def whole(x):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return x.to(new_mesh.device_type)

    full = _tree_map(whole, params)
    return shard_tree(full, params_specs(full, axes, rules, new_mesh),
                      new_mesh)
