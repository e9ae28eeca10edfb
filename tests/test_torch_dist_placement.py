"""The mesh's placement layer in the port (``repro_torch.core.dist`` spec and
resharding pass, the ``comm``/``gpu_dist`` cost models, the cache key and
``repro_torch.distributed.sharding``), held against the JAX package on the
same programs.  Pure Python: no process group, no device.

Resharded tapes are compared op by op after renumbering bases by first
occurrence (opcode, axis, every view's geometry, literals, new/del/sync
bases and each base's placement), COMM byte counts and ``comm`` partitions
exactly (both packages priced with the same rates), and the placement
specs leaf for leaf on the production mesh shapes.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from repro.configs import ARCHS, get_config
from repro.core import dist as rdist
from repro.core import lazy as rbh
from repro.core.algorithms import partition as ref_partition
from repro.core.cost import CommCost as RefCommCost
from repro.core.cost import make_cost_model as ref_cost_model
from repro.core.dist import insert_resharding as ref_insert
from repro.core.ir import Op as RefOp
from repro.core.lazy import fresh_runtime as ref_fresh_runtime
from repro.distributed import sharding as ref_sharding
from repro.models.transformer import abstract_params
from repro.testing.tapegen import TapeProgram as RefTapeProgram

from repro_torch.core import dist
from repro_torch.core import lazy as bh
from repro_torch.core.algorithms import partition
from repro_torch.core.blocks import BlockInfo
from repro_torch.core.cache import tape_signature
from repro_torch.core.cost import FABRIC_BW, CommCost, make_cost_model
from repro_torch.core.dist import (ShardSpec, block_comm_bytes, comm_op_bytes,
                                   insert_resharding, spec_of, view_aligned)
from repro_torch.core.fusion import build_graph, build_graph_reference, fusible
from repro_torch.core.ir import COMM_OPS, BaseArray, Op, View
from repro_torch.core.lazy import fresh_runtime
from repro_torch.core.partition import PartitionState
from repro_torch.core.scheduler import Scheduler
from repro_torch.distributed import sharding
from repro_torch.testing.tapegen import TapeProgram

HBM, FABRIC = 3.35e12, 450e9     # one set of rates for both packages


# ---------------------------------------------------------------------------
# Recording one program in both packages
# ---------------------------------------------------------------------------

def _record(pkg, program, n_shards):
    """The raw tape ``program(bh, dist, n)`` records in one package."""
    if pkg == "port":
        ctx, lib, d, O = fresh_runtime(device="cpu"), bh, dist, Op
    else:
        ctx, lib, d, O = ref_fresh_runtime(), rbh, rdist, RefOp
    with ctx as rt:
        outs = program(lib, d, n_shards)
        for o in outs:
            rt.record(O("sync", None, sync_bases=frozenset({o.view.base})))
        tape = list(rt.tape)
        rt.tape.clear()
        for o in outs:
            o._alive = False
    return tape


def window(bh, d, n):
    x = bh.asarray(np.arange(32, dtype=np.float64))
    d.shard(x, n=n)
    zs = [x[i:28 + i] * 2.0 for i in range(3)]
    return [zs[0] + zs[1] + zs[2]]


def aligned(bh, d, n):
    x = bh.asarray(np.arange(32, dtype=np.float64))
    d.shard(x, n=n)
    return [bh.exp(x * 0.5) + 1.0]


def sweep_sharded(bh, d, n):
    x = bh.asarray(np.arange(32, dtype=np.float64))
    d.shard(x, n=n)
    return [x.sum()]


def sweep_unsharded(bh, d, n):
    x = bh.asarray(np.arange(64, dtype=np.float64).reshape(8, 8))
    d.shard(x, n=n)
    return [x.sum(axis=1)]


def explicit_casts(bh, d, n):
    x = bh.asarray(np.arange(32, dtype=np.float64))
    xs = d.reshard(x, d.ShardSpec.for_dim((32,), 0, "dev", n))
    back = d.reshard(xs, None)
    return [back + 1.0]


def stencil(bh, d, n):
    x = bh.asarray(np.arange(64, dtype=np.float64))
    d.shard(x, n=n)
    y = (x[0:60] + x[1:61] + x[2:62]) * 0.5
    z = bh.zeros((64,))
    z[2:62] = y
    return [z, (z * z).max()]


PROGRAMS = {f.__name__: f for f in (window, aligned, sweep_sharded,
                                    sweep_unsharded, explicit_casts,
                                    stencil)}


def _canon(tape):
    """Package-independent structure of a tape: bases renumbered by first
    occurrence, each op's opcode/axis/views/literals/base sets, and each
    base's size, dtype and placement."""
    ids, bases = {}, []

    def bid(b):
        if b.uid not in ids:
            ids[b.uid] = len(ids)
            bases.append(b)
        return ids[b.uid]

    def vk(v):
        return (bid(v.base), v.offset, tuple(v.shape), tuple(v.strides))

    ops = []
    for op in tape:
        ins = tuple(vk(v) if hasattr(v, "base") else ("lit", repr(v))
                    for v in op.inputs)
        out = vk(op.out) if op.out is not None else None
        sets = tuple(tuple(sorted(bid(b) for b in s)) for s in
                     (op.new_bases, op.del_bases, op.sync_bases))
        ops.append((op.opcode, op.axis, out, ins, sets))
    place = []
    for b in bases:
        s = b.shard_spec
        place.append((b.size, str(np.dtype(b.dtype)), None if s is None else
                      (tuple(s.shape), tuple(s.mesh_axes), tuple(s.mesh))))
    return ops, place


def _both(program, n_shards):
    port = insert_resharding(_record("port", program, n_shards))
    ref = ref_insert(_record("ref", program, n_shards))
    return port, ref


# ---------------------------------------------------------------------------
# ShardSpec
# ---------------------------------------------------------------------------

def test_shardspec_geometry():
    s = ShardSpec.for_dim((32, 8), 0, "dev", 4)
    assert s.n_shards == 4 and s.sharded_dim == 0 and s.divides()
    assert s.chunk_shape() == (8, 8)
    assert not s.is_replicated
    assert s.drop_dim(1).mesh_axes == ("dev",)
    assert s.placement_key() == (("dev", None), (("dev", 4),))
    r = ShardSpec.replicated((32, 8))
    assert r.is_replicated and r.sharded_dim is None
    assert ShardSpec.for_dim((30,), 0, "dev", 4).divides() is False
    assert spec_of(BaseArray(8, np.dtype(np.float64))) is None
    one = BaseArray(8, np.dtype(np.float64))
    one.shard_spec = ShardSpec.for_dim((8,), 0, "dev", 1)
    assert spec_of(one) is None                 # 1-way is replicated


@pytest.mark.parametrize("shape,logical,mesh", [
    ((8, 64), ("heads", "embed"), {"data": 4, "model": 2}),
    ((2, 64), ("kv_heads", "embed"), {"data": 16, "model": 16}),
    ((32, 64, 128), ("layers", "embed", "ffn"), {"data": 16, "model": 16}),
    ((64, 32), ("expert", "expert_ffn"), {"pod": 2, "data": 16,
                                         "model": 16}),
])
def test_shardspec_from_logical_matches_reference(shape, logical, mesh):
    from repro.core.dist import ShardSpec as RefShardSpec
    fake = SimpleNamespace(shape=mesh)
    got = ShardSpec.from_logical(shape, logical, sharding.RULES_TRAIN, fake)
    want = RefShardSpec.from_logical(shape, logical, ref_sharding.RULES_TRAIN,
                                     fake)
    assert (got.shape, got.mesh_axes, got.mesh) == \
        (want.shape, want.mesh_axes, want.mesh)


def test_view_aligned():
    b = BaseArray(32, np.dtype(np.float64))
    s = ShardSpec.for_dim((32,), 0, "dev", 4)
    assert view_aligned(View.contiguous(b, (32,)), s)
    assert view_aligned(View.contiguous(b, (4, 8)), s)
    assert not view_aligned(View(b, 1, (31,), (1,)), s)       # shifted window
    assert not view_aligned(View(b, 0, (16,), (2,)), s)       # strided
    assert not view_aligned(View(b, 0, (2, 32), (0, 1)), s)   # broadcast
    assert view_aligned(View(b, 1, (31,), (1,)), None)        # replicated


# ---------------------------------------------------------------------------
# The resharding pass against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_resharded_tape_matches_reference(name, n_shards):
    port, ref = _both(PROGRAMS[name], n_shards)
    assert _canon(port) == _canon(ref)
    uids = [op.uid for op in port]
    assert uids == sorted(uids)                  # uid order == tape order


@pytest.mark.parametrize("seed", range(32))
def test_tapegen_sharded_tape_matches_reference(seed):
    port = TapeProgram(seed, sharded=True).record()
    ref = RefTapeProgram(seed, sharded=True).record()
    assert _canon(port) == _canon(ref)           # the recorded tapes
    assert dist.tape_has_sharding(port) == rdist.tape_has_sharding(ref)
    port, ref = insert_resharding(port), ref_insert(ref)
    assert _canon(port) == _canon(ref)           # and the resharded ones
    for a, b in zip(port, ref):
        assert comm_op_bytes(a) == rdist.comm_op_bytes(b)
    assert block_comm_bytes(port) == rdist.block_comm_bytes(ref)


def test_reshard_noop_without_sharding():
    with fresh_runtime(device="cpu") as rt:
        x = bh.asarray(np.arange(8.0))
        y = x[1:] * 2.0
        rt.record(Op("sync", None, sync_bases=frozenset({y.view.base})))
        tape = list(rt.tape)
        rt.tape.clear()
    assert insert_resharding(tape) == tape
    assert not dist.tape_has_sharding(tape)


def test_reshard_inserts_allgather_per_read_site():
    tape, _ = _both(window, 4)
    comms = [op for op in tape if op.opcode in COMM_OPS]
    assert len(comms) == 3 and {op.opcode for op in comms} == \
        {"comm_allgather"}
    assert all(spec_of(op.out.base) is None for op in comms)
    for c in comms:                              # single-use temporaries
        assert any(c.out.base in op.del_bases for op in tape)


def test_reshard_ppermute_on_placement_mismatch():
    a = BaseArray(32, np.dtype(np.float64))
    a.shard_spec = ShardSpec.for_dim((32,), 0, "dev", 4)
    o = BaseArray(32, np.dtype(np.float64))
    o.shard_spec = ShardSpec.for_dim((32,), 0, "mdl", 4)
    op = Op("copy", View.contiguous(o, (32,)), (View.contiguous(a, (32,)),))
    out = insert_resharding([op])
    assert [x.opcode for x in out if x.opcode in COMM_OPS] == \
        ["comm_ppermute"]
    assert spec_of(out[0].out.base).placement_key() == \
        o.shard_spec.placement_key()
    assert comm_op_bytes(out[0]) == 32 * 8 * 3 / 4   # nbytes * (n-1)/n


def test_comm_op_bytes_model():
    tape, ref = _both(window, 4)
    ag = next(op for op in tape if op.opcode == "comm_allgather")
    assert comm_op_bytes(ag) == 3 * 32 * 8       # (n-1) * nbytes
    rs = Op("comm_reduce_scatter", View.contiguous(
        BaseArray(32, np.dtype(np.float64)), (32,)),
        (View.contiguous(BaseArray(32, np.dtype(np.float64)), (32,)),))
    assert comm_op_bytes(rs) == 0.0              # placement cast is local
    dup = [op for op in tape if op.opcode == "comm_allgather"]
    assert block_comm_bytes(dup) == comm_op_bytes(dup[0])
    assert block_comm_bytes(dup) == rdist.block_comm_bytes(
        [op for op in ref if op.opcode == "comm_allgather"])


def test_comm_is_a_fusion_boundary_and_graphs_agree():
    tape, _ = _both(window, 4)
    ags = [op for op in tape if op.opcode == "comm_allgather"]
    mul = next(op for op in tape if op.opcode == "mul")
    assert not fusible(ags[0], mul) and not fusible(mul, ags[0])
    assert fusible(ags[0], ags[1])               # identical reshards merge
    g1, g2 = build_graph(list(tape)), build_graph_reference(list(tape))
    assert (g1.dep_out, g1.dep_in, g1.fuse_forbidden) == \
        (g2.dep_out, g2.dep_in, g2.fuse_forbidden)


# ---------------------------------------------------------------------------
# The comm model's partitions against the reference's
# ---------------------------------------------------------------------------

def _fabric(tape, res):
    return sum(block_comm_bytes([tape[i] for i in blk])
               for blk in res.op_blocks())


@pytest.mark.parametrize("algorithm", ["greedy", "singleton"])
@pytest.mark.parametrize("name", ["window", "stencil", "sweep_sharded",
                                  "explicit_casts"])
def test_comm_partition_matches_reference(name, algorithm):
    port, ref = _both(PROGRAMS[name], 4)
    got = partition(port, algorithm=algorithm,
                    cost_model=CommCost(hbm_bw=HBM, fabric_bw=FABRIC))
    want = ref_partition(ref, algorithm=algorithm,
                         cost_model=RefCommCost(hbm_bw=HBM, ici_bw=FABRIC))
    assert [tuple(b) for b in got.op_blocks()] == \
        [tuple(b) for b in want.op_blocks()]
    assert got.cost == want.cost
    for blk in got.op_blocks():                  # never comm with compute
        kinds = {op.opcode in COMM_OPS for op in (port[i] for i in blk)
                 if not op.is_system()}
        assert len(kinds) <= 1


def test_comm_partition_elides_collectives():
    tape, _ = _both(window, 4)
    res_s = partition(tape, algorithm="singleton", cost_model="comm")
    res_g = partition(tape, algorithm="greedy", cost_model="comm")
    assert res_g.cost <= res_s.cost
    assert _fabric(tape, res_g) < _fabric(tape, res_s)
    ags = [op for op in tape if op.opcode == "comm_allgather"]
    cm = CommCost()
    cm.prepare(tape)
    b1, b2 = BlockInfo.from_op(ags[0]), BlockInfo.from_op(ags[1])
    assert cm.merge_saving(b1, b2) >= comm_op_bytes(ags[0]) / FABRIC_BW > 0


@pytest.mark.parametrize("seed", range(0, 32, 4))
def test_comm_sparse_weights_match_dense(seed):
    """The sparse saving-support graph holds every edge the dense one
    prices, with the same weight.  A dense-only edge is the rounding of a
    difference of equal sums (1e-25 s on seeds 4 and 20, in the
    reference's ``comm`` as well), never a saving."""
    tape = insert_resharding(TapeProgram(seed, sharded=True).record())
    g = build_graph(list(tape))
    sparse = PartitionState(g, make_cost_model("comm")).weights
    dense = PartitionState(g, make_cost_model("comm"), dense=True).weights
    assert all(dense.get(e) == w for e, w in sparse.items())
    assert all(abs(w) < 1e-20 for e, w in dense.items() if e not in sparse)


@pytest.mark.parametrize("seed", range(0, 32, 2))
def test_tapegen_comm_greedy_matches_reference(seed):
    port = insert_resharding(TapeProgram(seed, sharded=True).record())
    ref = ref_insert(RefTapeProgram(seed, sharded=True).record())
    got = partition(port, algorithm="greedy",
                    cost_model=CommCost(hbm_bw=HBM, fabric_bw=FABRIC))
    want = ref_partition(ref, algorithm="greedy",
                         cost_model=RefCommCost(hbm_bw=HBM, ici_bw=FABRIC))
    assert [tuple(b) for b in got.op_blocks()] == \
        [tuple(b) for b in want.op_blocks()]
    assert got.cost == want.cost


@pytest.mark.parametrize("seed", range(1, 32, 2))
def test_gpu_dist_prices_like_gpu(seed):
    """ROADMAP C26: ``halo_bytes`` reads ``base.shard``, which nothing
    sets, so ``gpu_dist`` prices every block as ``gpu`` does, sharded tapes
    included — as the reference's ``tpu_dist`` prices as ``tpu``."""
    tape = insert_resharding(TapeProgram(seed, sharded=True).record())
    assert dist.tape_has_sharding(tape)
    gpu, gpu_dist = make_cost_model("gpu"), make_cost_model("gpu_dist")
    for blk in partition(tape, algorithm="greedy",
                         cost_model="gpu").op_blocks():
        b = BlockInfo.from_ops([tape[i] for i in blk])
        assert gpu_dist.block_cost(b) == gpu.block_cost(b)
    ref = ref_insert(RefTapeProgram(seed, sharded=True).record())
    tpu, tpu_dist = ref_cost_model("tpu"), ref_cost_model("tpu_dist")
    from repro.core.blocks import BlockInfo as RefBlockInfo
    for blk in ref_partition(ref, algorithm="greedy",
                             cost_model="tpu").op_blocks():
        b = RefBlockInfo.from_ops([ref[i] for i in blk])
        assert tpu_dist.block_cost(b) == tpu.block_cost(b)


def test_calibrated_prices_a_comm_block_with_its_fabric_term():
    tape, _ = _both(window, 4)
    ags = [op for op in tape if op.opcode == "comm_allgather"]
    b = BlockInfo.from_ops(ags)
    cal, gpu = make_cost_model("calibrated", fit=None), make_cost_model("gpu")
    want = gpu.block_cost(b) + block_comm_bytes(ags) / FABRIC_BW
    assert cal.block_cost(b) == pytest.approx(want, rel=1e-15)
    assert cal.block_cost(b) > gpu.block_cost(b)


# ---------------------------------------------------------------------------
# Placement-aware cache keys
# ---------------------------------------------------------------------------

def _tiny_tape():
    with fresh_runtime(device="cpu") as rt:
        x = bh.asarray(np.arange(8.0))
        y = x * 2.0
        rt.record(Op("sync", None, sync_bases=frozenset({y.view.base})))
        tape = list(rt.tape)
        rt.tape.clear()
        x._alive = y._alive = False
    return tape, x


def test_tape_signature_includes_topology_and_placement():
    tape, x = _tiny_tape()
    k1 = tape_signature(tape, "greedy", "comm")
    k2 = tape_signature(tape, "greedy", "comm", topology=(("dev", 4), "cpu"))
    assert k1 != k2
    assert k1[2] == k2[2] == ()                  # key[2] stays the token
    x.view.base.shard_spec = ShardSpec.for_dim((8,), 0, "dev", 4)
    k3 = tape_signature(tape, "greedy", "comm")
    assert k3 != k1                              # placement changes the key
    cal = tape_signature(tape, "greedy", "calibrated",
                         cost_token=("calibrated_epoch", 3))
    assert cal[2] == ("calibrated_epoch", 3)


def test_merge_cache_not_shared_across_topology():
    tape, _ = _tiny_tape()
    sch = Scheduler()
    sch.plan(tape, topology=(("dev", 1), "cpu"))
    sch.plan(tape, topology=(("dev", 4), "cpu"))
    assert sch.cache.misses == 2 and sch.cache.hits == 0
    sch.plan(tape, topology=(("dev", 4), "cpu"))
    assert sch.cache.hits == 1


def test_plan_store_reads_an_envelope_from_before_the_mesh_as_stale(
        tmp_path):
    """A plan stored under the key without topology and placement reads back
    as a stale miss at the new key, never as a hit."""
    import json
    from repro_torch.core.serve.store import PlanStore
    tape, _ = _tiny_tape()
    store = PlanStore(str(tmp_path))
    key = tape_signature(tape, "greedy", "bohrium")
    old_key = (key[0], key[1], key[2], key[4], key[6], key[7])
    assert store.store(key, ((0,), (1,)), None)
    path = store.path_for(key)
    env = json.loads(open(path).read())
    env.update(version="repro_torch_plan_v1", key_repr=repr(old_key))
    with open(path, "w") as f:
        json.dump(env, f)
    assert store.load(key) is None
    assert store._metrics.counter("serve.store.stale").get() == 1


# ---------------------------------------------------------------------------
# distributed/sharding against the reference, every leaf of every config
# ---------------------------------------------------------------------------

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def abstract():
    return {arch: abstract_params(get_config(arch)) for arch in ARCHS}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_specs_match_reference(abstract, arch, mesh):
    shapes, axes = abstract[arch]
    fake = SimpleNamespace(shape=MESHES[mesh])
    for rules, ref_rules in ((sharding.RULES_TRAIN, ref_sharding.RULES_TRAIN),
                             (sharding.RULES_SERVE,
                              ref_sharding.RULES_SERVE)):
        assert rules == ref_rules
        got = dict(_leaves(sharding.params_specs(shapes, axes, rules, fake)))
        want = dict(_leaves(ref_sharding.params_specs(shapes, axes,
                                                      ref_rules, fake)))
        assert got.keys() == want.keys() and got
        for path in want:
            assert tuple(got[path]) == tuple(want[path]), (arch, path)


def test_logical_to_mesh_divisibility_and_batch_spec():
    fake = SimpleNamespace(shape={"data": 16, "model": 16})
    spec = sharding.logical_to_mesh((2, 64), ("kv_heads", "embed"),
                                    sharding.RULES_TRAIN, fake)
    assert spec == sharding.PartitionSpec(None, "data")
    spec = sharding.logical_to_mesh((32, 64), ("kv_heads", "embed"),
                                    sharding.RULES_TRAIN, fake)
    assert tuple(spec) == ("model", "data")
    for mesh in MESHES.values():
        fake = SimpleNamespace(shape=mesh)
        assert tuple(sharding.batch_spec(fake)) == \
            tuple(ref_sharding.batch_spec(fake))
