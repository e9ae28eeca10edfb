"""The ``shard_map`` lowering backend — sharded blocks with real
collectives on a ``DeviceMesh`` (the port's counterpart of the reference's
``jax.shard_map`` backend).

Blocks that touch sharded bases lower to one function each rank runs on
its own data (SPMD): sharded bases enter as this rank's contiguous chunk
(dim-0 block sharding keeps chunks contiguous in the flat base),
replicated bases enter whole, and COMM ops become real collectives
(``dist.mesh.all_gather`` for allgather/ppermute resharding, shard-local
slices for placement casts).  Identical COMM ops inside one block execute
as ONE collective — the backend realizes the elision the ``comm`` cost
model priced.  Sharded outputs leave as ``Shard(0)`` DTensors
(``dist.mesh.as_sharded``), the store's form for sharded data.

``claims`` is the static eligibility check: blocks the shard tiler cannot
express (strided/partial views, reductions, opaque ops, foreign shardings)
and purely replicated blocks are declined with a reason slug and fall to
the next backend in the policy, which sees whole tensors (the executor
gathers a sharded input first) and runs COMM ops as local identity copies
— results are bit-identical to the single-device path by construction.

All dist-layer imports are function-local: the backends package must stay
importable from ``core.executor`` without touching ``core.dist`` (whose
package init imports the executor back).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from .base import LoweringBackend, LoweringContext

#: claim-failure slugs (per-backend fallback stats), the reference's
REASONS = (
    "no_mesh",         # executor has no device mesh
    "system_only",     # nothing to dispatch
    "opcode",          # op outside the shard tiler's elementwise/COMM set
    "irregular_view",  # strided/partial view: chunks not contiguous
    "placement",       # foreign/misaligned sharding, or purely replicated
)


def shard_specs(work: Sequence, n_dev: int) -> Tuple[Optional[Dict], Optional[str]]:
    """Static eligibility check; returns ``({base uid: ShardSpec|None},
    None)`` when the block is expressible as one per-rank program, else
    ``(None, reason)``."""
    from ..dist.spec import spec_of
    from ..executor import _BINARY, _UNARY
    from ..ir import COMM_OPS

    if not work:
        return None, "system_only"
    specs: Dict[int, object] = {}
    any_sharded = False
    for op in work:
        oc = op.opcode
        if oc not in _UNARY and oc not in _BINARY and oc != "where" \
                and oc not in COMM_OPS:
            return None, "opcode"
        for v in (*op.in_views(), *op.out_views()):
            if not (v.offset == 0 and v.size == v.base.size
                    and v.is_contiguous()):
                return None, "irregular_view"
            s = spec_of(v.base)
            if s is not None:
                if (s.sharded_dim != 0 or not s.divides()
                        or s.n_shards != n_dev
                        or v.base.size % n_dev != 0):
                    return None, "placement"
                any_sharded = True
            specs[v.base.uid] = s
    if not any_sharded:
        return None, "placement"
    for op in work:              # replicated outputs need replicated inputs
        if op.opcode in COMM_OPS:
            continue
        so = specs[op.out.base.uid]
        for v in op.in_views():
            si = specs[v.base.uid]
            if si is not None and (so is None or si.placement_key()
                                   != so.placement_key()):
                return None, "placement"  # reshard pass normally prevents
    return specs, None


class ShardMapBackend(LoweringBackend):
    name = "shard_map"

    def claims(self, ops: Sequence, plan, ctx: LoweringContext) -> Optional[str]:
        if ctx.mesh is None:
            return "no_mesh"
        work = [op for op in ops if not op.is_system()]
        _, reason = shard_specs(work, ctx.n_dev)
        return reason

    def cache_token(self, ops: Sequence, plan, ctx: LoweringContext) -> Tuple:
        from ..dist.spec import placement_digest
        return (placement_digest(ops),)

    def build(self, ops: Sequence, plan, ctx: LoweringContext):
        import torch

        from ..dist.mesh import all_gather, as_sharded, chunk_of, whole
        from ..dist.reshard import _comm_key
        from ..executor import _base_meta, apply_op, block_io, torch_dtype
        from ..ir import COMM_OPS, View

        work = [op for op in ops if not op.is_system()]
        specs, reason = shard_specs(work, ctx.n_dev)
        assert specs is not None, f"build without claim: {reason}"
        inputs, outputs, _ = block_io(ops)
        meta = _base_meta(work)
        mesh, device = ctx.mesh, ctx.device
        rank = mesh.get_local_rank()
        chunk = {u: size // ctx.n_dev for u, (size, _) in meta.items()}

        def shard_of(val, u):
            # this rank's chunk of ``u``; the start is clamped into ``val``
            # as ``lax.dynamic_slice`` clamps it, so a placement cast whose
            # source is already this rank's chunk returns that chunk
            start = min(rank * chunk[u], max(0, val.numel() - chunk[u]))
            return val[start:start + chunk[u]]

        def fn(*bufs_and_salts):
            *bufs, _salts = bufs_and_salts
            env: Dict[int, torch.Tensor] = {
                u: chunk_of(b, mesh) if specs.get(u) is not None else whole(b)
                for u, b in zip(inputs, bufs)}
            for u, (size, dt) in meta.items():
                if u not in env:
                    local = chunk[u] if specs.get(u) is not None else size
                    env[u] = torch.zeros(local, dtype=torch_dtype(dt),
                                         device=device)
            issued: Dict[Tuple, torch.Tensor] = {}
            for op in work:
                oc = op.opcode
                ou = op.out.base.uid
                size, dt = meta[ou]
                if oc in COMM_OPS:
                    key = _comm_key(op)
                    val = issued.get(key)
                    if val is None:           # ONE collective per identity
                        su = op.in_views()[0].base.uid
                        if oc == "comm_allgather":
                            val = all_gather(env[su], mesh)
                        elif oc == "comm_ppermute":
                            val = shard_of(all_gather(env[su], mesh), ou)
                        else:                 # reduce_scatter placement cast
                            val = shard_of(env[su], ou)
                        issued[key] = val
                    env[ou] = val.to(torch_dtype(dt))
                    continue
                sharded_out = specs.get(ou) is not None
                ins = []
                for v in op.inputs:
                    if not isinstance(v, View):
                        ins.append(v)
                        continue
                    x = env[v.base.uid]
                    if sharded_out and specs.get(v.base.uid) is None:
                        x = shard_of(x, v.base.uid)   # replicated → my chunk
                    ins.append(x)
                val = apply_op(oc, ins, device)
                local = chunk[ou] if sharded_out else size
                env[ou] = torch.broadcast_to(val.to(torch_dtype(dt)),
                                             (local,)).contiguous()
            return tuple(as_sharded(env[u], mesh)
                         if specs.get(u) is not None else env[u]
                         for u in outputs)

        return fn

    def post_dispatch(self, ops: Sequence, plan, ctx: LoweringContext,
                      stats) -> None:
        """Collectives/fabric bytes are counted only for dispatches that
        actually lowered through shard_map — on other backends COMM ops
        execute as local identity copies and move nothing."""
        from ..dist.reshard import _comm_key, block_comm_bytes
        from ..ir import COMM_OPS
        n_comms = len({_comm_key(op) for op in ops if op.opcode in COMM_OPS})
        if n_comms:
            stats.inc("collectives", n_comms)
            stats.inc("interconnect_bytes", block_comm_bytes(ops))
