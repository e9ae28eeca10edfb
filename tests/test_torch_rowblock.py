"""Kernel B2 — the row-replay generator — against the JAX package on the CPU.

Blocks come from the reference runtime under ``backend="lm"``: every flush
of the ``LMProgram`` grammars and of the tiny LM's forward, prefill and
decode is captured at dispatch, each work block rebuilt in the port's IR
(``to_port``).  On each block the port must give the reference's analysis
slug, matcher verdicts and lowering decision (backend names mapped
``pallas → triton``, ``xla → torch``).

Each claimed block is then run through the reference's Pallas kernel
(interpret mode) and the port's wrapper on CPU tensors (its plain
version), on the same integer-valued inputs.  Blocks of correctly rounded
ops with exact row sums (the masked max, the hand-built replay block) match
bit for bit.  Blocks with ``rsqrt`` or ``exp`` match within 4 float32 ulps
of the block's largest value: XLA's and PyTorch's CPU ``rsqrt`` differ in
the last ulp on about a third of float32 inputs (and neither is correctly
rounded), their ``exp`` differ likewise, and XLA contracts the scan
grammar's ``exp(a)*h + g*u`` into an FMA (ROADMAP C7).  On every block the
plain version equals the port's torch floor bit for bit.
"""

import ast

import jax
import numpy as np
import pytest
import torch

from repro.core.ir import BaseArray, Op, View
from repro.core.lazy import fresh_runtime as ref_fresh_runtime
from repro.kernels.fused_block.rowblock import (
    build_rowblock_kernel as ref_build, rowblock_lower_reason as ref_reason)
from repro.testing.tapegen import LMProgram as RefLMProgram

from repro_torch.core.backends import LM_STACK, LoweringContext, select_lowering
from repro_torch.core.executor import make_block_fn
from repro_torch.kernels.flash_attention import block as fa_block
from repro_torch.kernels.fused_block import codegen, rowblock
from repro_torch.kernels.mamba_scan import block as scan_block
from repro_torch.kernels.rmsnorm import block as norm_block
from repro_torch.testing.tapegen import LMProgram, check_lm
from test_torch_gpu import _replay_ops
from test_torch_planning import to_port, to_reference

NAMES = {"pallas": "triton", "xla": "torch"}
ROW = ("flash_attention", "rmsnorm", "mamba_scan")
EXACT_OPS = {"add", "sub", "mul", "div", "where", "reduce_max", "reduce_sum",
             "copy"}


def _capture(run):
    """Work blocks of every flush ``run(rt)`` makes on a reference runtime
    under the lm stack: ``(ref ops, port ops, ref decision)``."""
    out = []
    with ref_fresh_runtime(backend="lm", algorithm="greedy",
                           cost_model="bohrium", loop_fusion=False) as rt:
        orig = rt.executor.run_schedule

        def spy(schedule, buffers):
            port_tape = to_port(schedule.tape)
            for plan in schedule.blocks:
                if plan.has_work:
                    idx = plan.op_indices
                    out.append(([schedule.tape[i] for i in idx],
                                [port_tape[i] for i in idx], plan.lowering))
            return orig(schedule, buffers)

        rt.executor.run_schedule = spy
        run(rt)
    return out


def _lm_tapes(rt):
    from repro.models import transformer as T
    from repro.models.lazy_transformer import LazyTransformer
    from test_torch_lm import CFG, MAX_SEQ, TOKENS
    p, _ = T.init_params(CFG, jax.random.PRNGKey(0))
    lt = LazyTransformer(p, CFG, runtime=rt)
    lt.forward(TOKENS)
    lt.prefill(TOKENS, MAX_SEQ)
    lt.decode(np.asarray([[5], [11]], np.int32))


SOURCES = {f"lmprog{s}": (lambda s: lambda rt: RefLMProgram(s)._trace(rt))(s)
           for s in range(8)}
SOURCES["lm_tiny"] = _lm_tapes
_CACHE = {}


def blocks_of(name):
    if name not in _CACHE:
        _CACHE[name] = _capture(SOURCES[name])
    return _CACHE[name]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_slugs_matchers_and_decisions_match_reference(name):
    from repro.kernels.flash_attention.block import match as r_fa
    from repro.kernels.mamba_scan.block import match as r_scan
    from repro.kernels.rmsnorm.block import match as r_norm
    blocks = blocks_of(name)
    assert blocks
    ctx = LoweringContext(device="cpu")
    for rops, pops, decision in blocks:
        assert rowblock.rowblock_lower_reason(pops) == ref_reason(rops)
        assert fa_block.match(pops) == r_fa(rops)
        assert norm_block.match(pops) == r_norm(rops)
        assert scan_block.match(pops) == r_scan(rops)
        got = select_lowering(pops, None, LM_STACK, ctx)
        assert got.backend == NAMES.get(decision.backend, decision.backend)
        assert got.declined == tuple((NAMES.get(n, n), r)
                                     for n, r in decision.declined)


def _inputs(ops, ins, seed):
    """Integer-valued inputs for a block's input bases (non-negative, so
    variances stay real), as numpy arrays."""
    meta = {}
    for op in ops:
        for v in (*op.in_views(), *op.out_views()):
            meta[v.base.uid] = (v.base.size, np.dtype(v.base.dtype))
    rng = np.random.default_rng(seed)
    out = []
    for u in ins:
        size, dt = meta[u]
        if dt == np.bool_:
            out.append(rng.random(size) < 0.7)
        else:
            out.append(rng.integers(0, 16, size).astype(dt))
    return out


def _claimed(name):
    return [(r, p) for r, p, d in blocks_of(name) if d.backend in ROW]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_plain_version_matches_reference_kernel_and_floor(name):
    claimed = _claimed(name)
    for k, (rops, pops) in enumerate(claimed):
        rfn, rins, routs = ref_build(rops, interpret=True)
        fn, ins, outs = rowblock.build_rowblock_kernel(pops, device="cpu")
        assert len(ins) == len(rins) and len(outs) == len(routs)
        arrays = _inputs(rops, rins, seed=k)
        want = [np.asarray(x) for x in jax.jit(rfn)(
            *arrays, jax.numpy.zeros((0,), jax.numpy.int32))]
        bufs = [torch.from_numpy(a.copy()) for a in arrays]
        got = [t.numpy() for t in fn(*bufs, ())]
        floor, _, _ = make_block_fn(pops, device="cpu")
        for g, f in zip(got, floor(*bufs, ())):
            np.testing.assert_array_equal(g, f.numpy())
        ocs = {op.opcode for op in pops if not op.is_system()}
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            if ocs <= EXACT_OPS:
                np.testing.assert_array_equal(g, w)
            else:
                ulp = np.spacing(np.float32(max(1.0, np.abs(w).max())))
                np.testing.assert_allclose(g, w, rtol=0, atol=4 * ulp)


def test_every_source_exercises_the_claimants():
    seen = {d.backend for name in SOURCES for _, _, d in blocks_of(name)}
    assert set(ROW) <= seen


@pytest.mark.parametrize("seed", range(16))
def test_check_lm_bitwise_on_cpu(seed):
    check_lm(seed)


def test_lm_program_draws_the_reference_shapes_and_leaves():
    for seed in range(12):
        mine, ref = LMProgram(seed), RefLMProgram(seed)
        assert (mine.grammar, mine.b, mine.s, mine.d, mine.h, mine.n_exp) \
            == (ref.grammar, ref.b, ref.s, ref.d, ref.h, ref.n_exp)
    # the same program in both packages, within 4 ulps of its largest value:
    # XLA contracts moe's ``out + x*e*g`` into an FMA, and the CPU rsqrt
    # implementations differ (rmsnorm)
    for seed, grammar in ((2, "moe"), (4, "rmsnorm")):
        prog, rprog = LMProgram(seed), RefLMProgram(seed)
        assert prog.grammar == grammar
        got = prog.run(backend="torch", device="cpu")[0]
        want = rprog.run(backend="xla", loop_fusion=False)[0]
        assert got.dtype == want.dtype == np.float32
        ulp = np.spacing(np.float32(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)


# ---------------------------------------------------------------------------
# hand-built blocks: the decline slugs, multi-reduction replay
# ---------------------------------------------------------------------------

def _b(n, dt=np.float32):
    return BaseArray(n, np.dtype(dt))


def _decline_blocks():
    r, c = 4, 8
    x, y, s, t = _b(r * c), _b(r * c), _b(r), _b(r * c + 5)
    vx, vy = View.contiguous(x, (r, c)), View.contiguous(y, (r, c))
    vs = View.contiguous(s, (r,))
    one = _b(c)
    cases = {
        "system_only": [Op("del", None, del_bases=frozenset({x}))],
        "comm": [Op("comm_allgather", vy, (vx,))],
        "opcode": [Op("matmul", vy, (vx, vx))],
        "reduction_axis": [Op("reduce_sum", View.contiguous(one, (c,)),
                              (vx,), axis=0)],
        "mixed_domain": [Op("add", vy, (vx, 1.0)),
                         Op("neg", vs, (vs,))],
        "empty_domain": [Op("neg", View(y, 0, (0, c), (c, 1)),
                            (View(x, 0, (0, c), (c, 1)),))],
        "reduction_out": [Op("reduce_sum", View(t, 1, (r,), (1,)), (vx,),
                             axis=1)],
        "irregular_view": [Op("add", View(t, 5, (r, c), (c, 1)),
                              (vx, 1.0))],
        "view_conflict": [Op("reduce_sum", vs, (vx,), axis=1),
                          Op("add", vy, (vx, View(s, 0, (r, c), (0, 0))))],
    }
    one_d = _b(c)
    cases["reduction_axis_1d"] = [
        Op("reduce_sum", View.contiguous(_b(1), ()),
           (View.contiguous(one_d, (c,)),), axis=0)]
    return cases


@pytest.mark.parametrize("case", sorted(_decline_blocks()))
def test_decline_slugs_match_reference(case):
    rops = _decline_blocks()[case]
    want = ref_reason(rops)
    assert want == case.replace("_1d", "")
    assert rowblock.rowblock_lower_reason(to_port(rops)) == want
    with pytest.raises(codegen.FusedBlockUnsupported) as ei:
        rowblock.build_rowblock_kernel(to_port(rops), device="cpu")
    assert ei.value.reason == want


def test_row_cap_declines_with_vmem():
    """The deliberate difference (ROADMAP C3): a row wider than MAX_ROW
    columns declines with ``vmem``; the TPU kernel claims it while its
    budget allows, and past it both decline."""
    for c, ref_want in ((rowblock.MAX_ROW * 2, None), (2 ** 22, "vmem")):
        x, y, s = _b(2 * c), _b(2 * c), _b(2)
        vx, vy = View.contiguous(x, (2, c)), View.contiguous(y, (2, c))
        ops = [Op("mul", vy, (vx, vx), new_bases=frozenset({y})),
               Op("reduce_sum", View.contiguous(s, (2,)), (vy,), axis=1,
                  new_bases=frozenset({s}))]
        assert ref_reason(ops) == ref_want
        assert rowblock.rowblock_lower_reason(to_port(ops)) == "vmem"
    c = rowblock.MAX_ROW
    x, y = _b(2 * c), _b(2)
    ops = [Op("reduce_max", View.contiguous(y, (2,)),
              (View.contiguous(x, (2, c)),), axis=1)]
    assert rowblock.rowblock_lower_reason(to_port(ops)) is None


@pytest.mark.parametrize("r,c", [(3, 5), (40, 64), (7, 300)])
def test_multi_reduction_replay_bitwise(r, c):
    pops = _replay_ops(r, c)
    rops = to_reference(pops)
    assert ref_reason(rops) is None and rowblock.rowblock_lower_reason(pops) is None
    rfn, rins, routs = ref_build(rops, interpret=True)
    fn, ins, outs = rowblock.build_rowblock_kernel(pops, device="cpu")
    assert len(outs) == len(routs) == 4          # s, o, m, o2
    arrays = [(a - 8).astype(a.dtype) if a.dtype != np.bool_ else a
              for a in _inputs(rops, rins, seed=r * c)]
    want = jax.jit(rfn)(*arrays, jax.numpy.zeros((0,), jax.numpy.int32))
    bufs = [torch.from_numpy(a.copy()) for a in arrays]
    floor, _, _ = make_block_fn(pops, device="cpu")
    for g, w, f in zip(fn(*bufs, ()), want, floor(*bufs, ())):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), f.numpy())


# ---------------------------------------------------------------------------
# the Triton source (it runs only on a card; here it must be valid Python)
# ---------------------------------------------------------------------------

def test_generated_sources_parse():
    n = 0
    for name in SOURCES:
        for _, pops, d in blocks_of(name):
            if d.backend in ROW:
                src, _, _ = rowblock.triton_source(rowblock._analyze(pops))
                assert "def row_kernel(" in src
            elif d.backend == "pallas":
                src, *_ = codegen.triton_source(codegen._analyze(pops))
            else:
                continue
            ast.parse(src)
            n += 1
    src, _, _ = rowblock.triton_source(rowblock._analyze(_replay_ops(5, 9)))
    ast.parse(src)
    assert " != 0" in src            # the bool mask is loaded as bytes
    assert n > 20


def test_wrapper_interface_matches_fused_block_kernel():
    fn, _, _ = rowblock.build_rowblock_kernel(_replay_ops(4, 8), device="cpu")
    assert isinstance(fn, rowblock.RowBlockKernel)
    assert fn.plan.domain == (4, 8) and fn.plan.N == 32
    assert len(fn.plan.nodes) == 6 and fn.draw_random((), "cpu") == []
    assert rowblock.block_bytes(fn.plan) == (32 * 4 + 8 + 4 * 4) + (
        4 * 4 + 32 * 4 + 4 * 4 + 32 * 4)
    assert rowblock.block_ops(fn.plan) == {"float32": 6 * 32}
    bufs = [torch.ones(32), torch.ones(8, dtype=torch.bool), torch.ones(4)]
    before = rowblock.LAUNCHES["rowblock"]
    fn(*bufs, ())                    # CPU tensors: the plain version
    assert rowblock.LAUNCHES["rowblock"] == before
    with pytest.raises(RuntimeError):
        fn(*[b.to("meta") for b in bufs], ())
