"""The port's ``gpu_fma`` cost model and B1's contracting form, on the CPU.

``gpu_fma`` is the reference's ``tpu_fma`` (``src/repro/core/cost.py``
``TPUFMACost``) as ``gpu`` is its ``tpu``: built with the reference's
constants it prices every block and partition of the 15 Benchpress
programs' tapes and of tapegen's seeds exactly as the reference does, and
partitions them identically.  B1's contracting form
(``codegen.triton_source(..., contract_fma=True)``) writes one ``tl.fma``
for each floating-point multiply→add pair the model counts; with the flag
off every generated source is byte for byte the parent commit's (a pinned
digest).  A runtime's lowering context carries the flag only under
``gpu_fma``, and the executor caches the two forms apart.
"""

import functools
import hashlib

import numpy as np
import pytest

from repro.core import partition as ref_partition
from repro.core.blocks import BlockInfo as RefBlockInfo
from repro.core.cost import TPUFMACost
from repro.core.lazy import fresh_runtime as ref_fresh_runtime
from repro.testing.tapegen import TapeProgram

from repro_torch.core import lazy
from repro_torch.core import partition
from repro_torch.core.blocks import BlockInfo, view_key
from repro_torch.core.cost import GPUFMACost, contracts_fma, make_cost_model
from repro_torch.kernels.fused_block import codegen
from test_codegen import SCALED
from test_torch_planning import to_port
from test_torch_programs import PORT, REF

#: the reference's ``tpu`` constants and ``tpu_fma``'s bonus
REF_CONSTANTS = dict(hbm_bw=819e9, launch_s=2e-6)
REF_BONUS_S = 1e-7
ALGORITHMS = ("singleton", "linear", "greedy")
#: tapes longer than this are partitioned by ``greedy`` alone (the
#: runtime's algorithm; lattice_boltzmann's 209-op flush takes ~10 s an
#: algorithm and package under the dense weight graph)
LONG_TAPE = 100
CASES = list(SCALED) + [("quickstart", (1, 5000))]
TAPEGEN_SEEDS = range(10)

#: sha256 of every distinct B1 source (and loop form, for blocks that
#: draw) of the programs' claimed blocks at ``SCALED`` sizes, in order of
#: first dispatch, as the parent commit generates them: 68 sources
BITWISE_SOURCES = ("992b6e8a6f288f83f95138301b41ba5b525d89f990f312b25aae43818b72396e",
                   68)


def _reference_tapes(name, args):
    """Every flush tape of one program, recorded by the reference's
    runtime (loop fusion off, so every flush is planned)."""
    tapes = []
    with ref_fresh_runtime(algorithm="greedy", backend="xla",
                           loop_fusion=False) as rt:
        plan = rt.scheduler.plan

        def spy(tape, **kw):
            tapes.append(list(tape))
            return plan(tape, **kw)

        rt.scheduler.plan = spy
        REF[name](*args)
    return tapes


@functools.lru_cache(maxsize=None)
def _claimed_blocks(name, args):
    """The op lists of every block the port's triton backend ran for one
    program on the CPU (``greedy`` under ``bohrium``), in dispatch
    order."""
    seen = []
    with lazy.fresh_runtime(algorithm="greedy", backend="triton",
                            device="cpu", loop_fusion=False) as rt:
        run = rt.executor.run_schedule

        def spy(schedule, buffers):
            for plan in schedule.blocks:
                if plan.has_work and plan.lowering is not None \
                        and plan.lowering.backend == "triton":
                    seen.append([schedule.tape[i] for i in plan.op_indices])
            return run(schedule, buffers)

        rt.executor.run_schedule = spy
        PORT[name](*args)
    return seen


def _same_pricing(tape):
    """``gpu_fma`` with the reference's constants against ``tpu_fma``:
    partitions, their costs, and every block's cost, equal to the bit."""
    port = to_port(tape)
    mine = make_cost_model("gpu_fma", fma_bonus_s=REF_BONUS_S,
                           **REF_CONSTANTS)
    ref = TPUFMACost(**REF_CONSTANTS)
    assert ref.FMA_BONUS_S == REF_BONUS_S
    for algo in ALGORITHMS if len(tape) <= LONG_TAPE else ("greedy",):
        got = partition(port, algorithm=algo, cost_model=mine)
        want = ref_partition(list(tape), algorithm=algo, cost_model=ref)
        assert got.op_blocks() == want.op_blocks(), algo
        assert got.cost == want.cost, algo
        mine_blocks = [BlockInfo.from_ops([port[i] for i in b])
                       for b in got.op_blocks()]
        ref_blocks = [RefBlockInfo.from_ops([tape[i] for i in b])
                      for b in want.op_blocks()]
        assert [mine.block_cost(b) for b in mine_blocks] == \
            [ref.block_cost(b) for b in ref_blocks], algo
        assert mine.partition_cost(mine_blocks) == \
            ref.partition_cost(ref_blocks), algo


@pytest.mark.parametrize("name,args", CASES[:15], ids=[c[0] for c in CASES[:15]])
def test_gpu_fma_prices_programs_like_tpu_fma(name, args):
    tapes = _reference_tapes(name, args)
    assert tapes
    for tape in tapes:
        _same_pricing(tape)


@pytest.mark.parametrize("seed", TAPEGEN_SEEDS)
def test_gpu_fma_prices_tapegen_like_tpu_fma(seed):
    _same_pricing(TapeProgram(seed, n_actions=16).record())


def test_gpu_fma_is_monotone_and_fuses_the_pair():
    """The reference's own scenario (``tests/test_wsp_properties.py``
    ``test_tpu_fma_cost_model_monotone_and_rewards_fma``) in the port."""
    from repro_torch.core import build_graph
    from repro_torch.core.partition import PartitionState
    with lazy.fresh_runtime(device="cpu") as rt:
        a = lazy.ones(1024)
        b_ = lazy.ones(1024)
        t = a * b_          # mul
        c = t + 1.0         # consuming add -> FMA pair when fused
        t.delete()
        tape = list(rt.tape)
        rt.tape.clear()
        for x in (a, b_, c):
            x._alive = False
    for model in (make_cost_model("gpu_fma"),
                  make_cost_model("gpu_fma", fma_bonus_s=REF_BONUS_S)):
        st_ = PartitionState(build_graph(tape), model)
        ids = sorted(st_.blocks)
        for u in ids:
            for v in ids:
                if u < v:
                    assert model.merge_saving(st_.blocks[u],
                                              st_.blocks[v]) >= -1e-12
        res = partition(tape, algorithm="greedy", cost_model=model)
        mul_i = next(i for i, op in enumerate(tape) if op.opcode == "mul")
        add_i = next(i for i, op in enumerate(tape) if op.opcode == "add")
        blk = next(b for b in res.op_blocks() if mul_i in b)
        assert add_i in blk            # the FMA pair fused


def test_gpu_fma_with_no_bonus_plans_as_gpu():
    """Where the bonus is 0, ``gpu_fma`` prices every block as ``gpu``."""
    tape = to_port(TapeProgram(3, n_actions=16).record())
    fma = GPUFMACost(fma_bonus_s=0.0)
    gpu = make_cost_model("gpu")
    got = partition(tape, algorithm="greedy", cost_model=fma)
    want = partition(tape, algorithm="greedy", cost_model=gpu)
    assert got.op_blocks() == want.op_blocks() and got.cost == want.cost


def _float_pairs(ops):
    """The model's pairs (``_fma_pairs``'s rule) whose mul and add are
    floating point of one dtype."""
    writers = {}
    for op in ops:
        if op.out is not None:
            writers[view_key(op.out)] = op
    n = 0
    for op in ops:
        if op.opcode != "add":
            continue
        for v in op.in_views():
            w = writers.get(view_key(v))
            if w is not None and w.opcode == "mul":
                n += (np.dtype(v.dtype).kind == "f"
                      and np.dtype(op.out.dtype) == np.dtype(v.dtype))
                break
    return n


@pytest.mark.parametrize("name,args", CASES, ids=[c[0] for c in CASES])
def test_contracting_source_has_one_fma_a_float_pair(name, args):
    """Every claimed block's contracting source holds one ``tl.fma`` for
    each float pair the model counts, and its bitwise source none."""
    model = make_cost_model("gpu_fma")
    for ops in _claimed_blocks(name, args):
        plan = codegen._analyze(ops)
        src = codegen.triton_source(plan, contract_fma=True)[0]
        want = _float_pairs(ops)
        assert src.count("tl.fma(") == len(plan.fma) == want
        assert model._fma_pairs(BlockInfo.from_ops(ops)) >= want
        assert "tl.fma(" not in codegen.triton_source(plan)[0]


def test_bitwise_sources_are_the_parents():
    """With ``contract_fma`` off, every block's source (and loop form) is
    byte for byte what the parent commit generated."""
    srcs = []
    for name, args in CASES:
        for ops in _claimed_blocks(name, args):
            plan = codegen._analyze(ops)
            for keyed in (False, True) if plan.rand_shapes else (False,):
                s = codegen.triton_source(plan, keyed)[0]
                if s not in srcs:
                    srcs.append(s)
    digest = hashlib.sha256("".join(srcs).encode()).hexdigest()
    assert (digest, len(srcs)) == BITWISE_SOURCES


def _pair_tape(dtype, lit):
    with lazy.fresh_runtime(device="cpu") as rt:
        a = lazy.asarray(np.arange(64, dtype=dtype))
        b = lazy.asarray(np.arange(64, dtype=dtype) % 7)
        c = a * b + lit
        tape = [op for op in rt.tape if op.opcode in ("mul", "add")]
        rt.tape.clear()
        for x in (a, b, c):
            x._alive = False
    return tape


def test_contraction_form_and_integer_pairs():
    """A float pair becomes ``tl.fma`` of the mul's operands and the add's
    other term; an integer pair, which the model counts, stays a multiply
    and an add (exact either way)."""
    f = codegen._analyze(_pair_tape(np.float64, 0.5))
    src = codegen.triton_source(f, contract_fma=True)[0]
    assert f.fma == {1: (0, 0)} and src.count("tl.fma(") == 1
    line = next(ln for ln in src.splitlines() if "tl.fma(" in ln)
    assert line.strip().startswith("v") and line.count("tl.load") == 0
    ints = _pair_tape(np.int64, 3)
    assert make_cost_model("gpu_fma")._fma_pairs(
        BlockInfo.from_ops(ints)) == 1
    i = codegen._analyze(ints)
    assert i.fma == {} and "tl.fma(" not in codegen.triton_source(
        i, contract_fma=True)[0]


def test_cpu_contracting_block_is_the_plain_evaluation():
    """On the CPU a contracting block runs the plain (bitwise) version."""
    ops = _pair_tape(np.float64, 0.5)
    plain, _, _ = codegen.build_block_kernel(ops, device="cpu")
    fma, ins, _ = codegen.build_block_kernel(ops, device="cpu",
                                             contract_fma=True)
    assert fma.contract_fma and not plain.contract_fma
    import torch
    bufs = [torch.arange(64, dtype=torch.float64),
            torch.arange(64, dtype=torch.float64) % 7]
    assert all(torch.equal(x, y) for x, y in zip(plain(*bufs, ()),
                                                  fma(*bufs, ())))


def test_runtime_context_carries_the_flag_only_under_gpu_fma():
    """Only ``gpu_fma`` contracts; a policy change keys the executor's
    cache apart, so a kernel of one form never serves the other."""
    assert [m for m in ("bohrium", "gpu", "gpu_dist", "calibrated", "comm",
                        "gpu_fma") if contracts_fma(m)] == ["gpu_fma"]
    with lazy.fresh_runtime(device="cpu", backend="triton",
                            cost_model="gpu", loop_fusion=False) as rt:
        assert not rt.lowering_policy().ctx.contract_fma
        x = lazy.ones(256) * 3.0 + 1.0
        assert x.numpy()[0] == 4.0
        lazy.set_policy(cost_model="gpu_fma")
        assert rt.lowering_policy().ctx.contract_fma
        y = lazy.ones(256) * 3.0 + 1.0
        assert y.numpy()[0] == 4.0
        keys = [k for k in rt.executor._cache if k[0] == "triton"]
        sigs = {k[1] for k in keys}
        assert len(keys) == 2 * len(sigs)
        assert {k[2:] for k in keys} == {(), ("contract_fma",)}
        forms = {k[2:]: rt.executor._cache[k] for k in keys}
        assert forms[("contract_fma",)].contract_fma
        assert not forms[()].contract_fma
        lazy.set_policy(cost_model="gpu")
        assert not rt.lowering_policy().ctx.contract_fma


def test_loop_body_is_keyed_by_the_form():
    """A fused loop under ``gpu_fma`` builds its body's blocks in the
    contracting form, under a key apart from the bitwise body's, with the
    same results on the CPU (the plain version either way)."""
    from repro_torch.testing.programs import BENCHMARKS
    out = {}
    for model in ("gpu", "gpu_fma"):
        with lazy.fresh_runtime(device="cpu", backend="triton",
                                cost_model=model) as rt:
            out[model] = np.asarray(BENCHMARKS["sor"](8, 24))
            loops = [k for k in rt.executor._cache if k[0] == "loop"]
            assert loops and {k[2] for k in loops} == {model == "gpu_fma"}
            assert rt.executor.stats["loop_iterations"] > 0
    np.testing.assert_array_equal(out["gpu"], out["gpu_fma"])
