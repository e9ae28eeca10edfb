"""The fused-block generator's analysis and its plain version, and the torch
floor, against the JAX package on the same blocks and the same inputs.

* Analysis: ``block_lower_reason`` gives the reference's slug on every
  block of ``tests/test_codegen.py`` (the one deliberate difference is the
  reference's VMEM budget; see ``codegen``'s docstring).
* Execution: each case is built in the reference IR, rebuilt in the port's
  (``to_port``), and run through the reference's ``make_block_fn`` and
  Pallas kernel (interpret mode) and through the port's ``make_block_fn``
  and fused-block wrapper (its plain version, on the CPU) with the same
  numpy inputs.  Bitwise on integer-valued or dyadic data; real-valued
  transcendental chains within 1e-12 relative (libm implementations
  differ by an ulp or two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.executor import make_block_fn as ref_make_block_fn
from repro.core.ir import BaseArray, Op, View
from repro.kernels.fused_block.codegen import (
    block_lower_reason as ref_reason, build_block_kernel as ref_build)

from repro_torch.core.executor import make_block_fn, op_dtypes, promote
from repro_torch.kernels.fused_block import codegen
from repro_torch.kernels.fused_block.ops import fused_block_fn
from test_torch_planning import to_port


def _base(n, dtype=np.float64, name=""):
    return BaseArray(n, np.dtype(dtype), name=name)


def _ints(rng, n, lo=-9, hi=9, dtype=np.float64):
    return rng.integers(lo, hi, n).astype(dtype)


def run_both(ops, arrays, *, seed=0, salts=()):
    """Outputs of (ref floor, ref Pallas, port floor, port kernel) as numpy."""
    port_ops = to_port(ops)
    jsalts = jnp.asarray(list(salts), jnp.int32)
    jbufs = [jnp.asarray(a) for a in arrays]
    tbufs = [torch.from_numpy(np.array(a)) for a in arrays]
    outs = []
    f, _, _ = ref_make_block_fn(ops, seed=seed)
    outs.append(jax.jit(f)(*jbufs, jsalts))
    f, _, _ = ref_build(ops, seed=seed)
    outs.append(jax.jit(f)(*jbufs, jsalts))
    f, _, _ = make_block_fn(port_ops, seed=seed)
    outs.append(f(*tbufs, tuple(salts)))
    f, _, _ = codegen.build_block_kernel(port_ops, seed=seed)
    outs.append(f(*tbufs, tuple(salts)))
    return [[np.asarray(x) for x in o] for o in outs]


def assert_all_equal(results, exact=True):
    first = results[0]
    for other in results[1:]:
        assert len(other) == len(first)
        for g, w in zip(other, first):
            assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
            if exact:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-300)


# ---------------------------------------------------------------------------
# analysis: the reference's slugs
# ---------------------------------------------------------------------------

def test_reason_slugs_match_reference_blocks():
    from test_codegen import _reason_blocks
    for reason, ops in _reason_blocks().items():
        got = codegen.block_lower_reason(to_port(ops))
        if reason == "vmem":
            # a (1, 2**23) row: past the TPU's VMEM budget, but a Hopper
            # program loops over columns and claims it
            assert ref_reason(ops) == "vmem" and got is None
        else:
            assert got == ref_reason(ops) == reason


def test_reason_list_is_the_reference_list():
    from repro.kernels.fused_block.codegen import REASONS
    assert codegen.REASONS == REASONS


def test_every_reason_raises_from_the_builder():
    from test_codegen import _reason_blocks
    for reason, ops in _reason_blocks().items():
        if reason == "vmem":
            continue
        with pytest.raises(codegen.FusedBlockUnsupported) as ei:
            codegen.build_block_kernel(to_port(ops))
        assert ei.value.reason == reason


def test_declined_block_gets_the_floor_with_its_slug():
    n = 64
    a, rev = _base(n), _base(n)
    ops = to_port([Op("copy", View.contiguous(rev, (n,)),
                      (View(a, n - 1, (n,), (-1,)),),
                      new_bases=frozenset({rev}))])
    fn, ins, outs, reason = fused_block_fn(ops)
    assert reason == "irregular_view"
    got = fn(torch.arange(n, dtype=torch.float64), ())
    np.testing.assert_array_equal(got[0].numpy(), np.arange(n)[::-1])


# ---------------------------------------------------------------------------
# execution cases (test_codegen.py's shapes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opcode", ["reduce_sum", "reduce_max", "reduce_min",
                                    "reduce_prod"])
@pytest.mark.parametrize("n", [7, 1000, 2049])
def test_full_1d_reduction(opcode, n):
    rng = np.random.default_rng(n)
    a, r = _base(n), _base(1)
    ops = [Op(opcode, View.contiguous(r, ()), (View.contiguous(a, (n,)),),
              axis=0, new_bases=frozenset({r}))]
    lo, hi = (1, 3) if opcode == "reduce_prod" else (-9, 9)
    assert_all_equal(run_both(ops, [_ints(rng, n, lo, hi)]))


@pytest.mark.parametrize("axis,rows,cols", [(0, 100, 24), (1, 13, 40),
                                            (0, 9, 130), (1, 300, 5)])
def test_2d_axis_reduction(axis, rows, cols):
    rng = np.random.default_rng(axis * 1000 + rows)
    a = _base(rows * cols)
    out_shape = (cols,) if axis == 0 else (rows,)
    r = _base(int(np.prod(out_shape)))
    ops = [Op("reduce_sum", View.contiguous(r, out_shape),
              (View.contiguous(a, (rows, cols)),), axis=axis,
              new_bases=frozenset({r}))]
    assert_all_equal(run_both(ops, [_ints(rng, rows * cols)]))


def test_narrowing_and_trailing_3d_reductions():
    rng = np.random.default_rng(21)
    n = 3000
    a, r = _base(n), _base(1, np.float32)
    ops = [Op("reduce_sum", View.contiguous(r, ()),
              (View.contiguous(a, (n,)),), axis=0, new_bases=frozenset({r}))]
    assert_all_equal(run_both(ops, [_ints(rng, n)]))
    d = (5, 6, 7)
    a3, r3 = _base(210), _base(30)
    ops = [Op("reduce_max", View.contiguous(r3, d[:-1]),
              (View.contiguous(a3, d),), axis=2, new_bases=frozenset({r3}))]
    assert_all_equal(run_both(ops, [_ints(rng, 210)]))


@pytest.mark.parametrize("m", [10, 33])
def test_stencil_rmw(m):
    g = _base(m * m)
    inner = _base((m - 2) * (m - 2))
    win = lambda i0, j0: View(g, i0 * m + j0, (m - 2, m - 2), (m, 1))  # noqa: E731
    vin = View.contiguous(inner, (m - 2, m - 2))
    ops = [
        Op("add", vin, (win(1, 0), win(1, 2)), new_bases=frozenset({inner})),
        Op("add", vin, (vin, win(0, 1))),
        Op("add", vin, (vin, win(2, 1))),
        Op("mul", vin, (vin, 0.25)),
        Op("copy", win(1, 1), (vin,)),
        Op("del", None, del_bases=frozenset({inner})),
    ]
    rng = np.random.default_rng(m)
    assert_all_equal(run_both(ops, [_ints(rng, m * m, -40, 40)]))


def test_strided_column_rmw_and_broadcast_classes():
    n = 50
    force, f = _base(3 * n), _base(n)
    vcol = View(force, 1, (n,), (3,))
    rng = np.random.default_rng(7)
    assert_all_equal(run_both(
        [Op("add", vcol, (vcol, View.contiguous(f, (n,))))],
        [_ints(rng, 3 * n), _ints(rng, n)]))
    n, m = 21, 130
    A, rowv, colv, sc, T = (_base(n * m), _base(m), _base(n), _base(1),
                            _base(n * m))
    vT = View.contiguous(T, (n, m))
    ops = [
        Op("mul", vT, (View.contiguous(A, (n, m)), View(rowv, 0, (n, m), (0, 1))),
           new_bases=frozenset({T})),
        Op("add", vT, (vT, View(colv, 0, (n, m), (1, 0)))),
        Op("maximum", vT, (vT, View(sc, 0, (n, m), (0, 0)))),
    ]
    assert_all_equal(run_both(ops, [_ints(rng, n * m), _ints(rng, m),
                                    _ints(rng, n), _ints(rng, 1)]))


def test_scalar_domain_and_mixed_3d_broadcast():
    acc, s = _base(1), _base(1)
    ops = [Op("add", View.contiguous(acc, ()),
              (View.contiguous(acc, ()), View.contiguous(s, ())))]
    assert_all_equal(run_both(ops, [np.array([3.0]), np.array([4.0])]))
    d = (4, 5, 6)
    src, T = _base(24), _base(120)
    ops = [Op("mul", View.contiguous(T, d), (View(src, 0, d, (6, 0, 1)), 2.0),
              new_bases=frozenset({T}))]
    assert_all_equal(run_both(ops, [_ints(np.random.default_rng(11), 24)]))


def test_range_and_random_bitwise():
    n = 700
    I, R, O = _base(n), _base(n), _base(n)
    vi, vr, vo = (View.contiguous(x, (n,)) for x in (I, R, O))
    ops = [
        Op("range", vi, (), new_bases=frozenset({I})),
        Op("random", vr, (), new_bases=frozenset({R})),
        Op("mod", vo, (vi, 2.0), new_bases=frozenset({O})),
        Op("mul", vo, (vo, vr)),
        Op("del", None, del_bases=frozenset({I})),
        Op("del", None, del_bases=frozenset({R})),
    ]
    assert_all_equal(run_both(ops, [], seed=5, salts=(17,)))


def test_contracted_partial_write_zero_fill():
    n = 32
    t, o = _base(n), _base(n // 2)
    ops = [
        Op("copy", View(t, 0, (n // 2,), (1,)), (5.0,),
           new_bases=frozenset({t})),
        Op("copy", View.contiguous(o, (n // 2,)),
           (View(t, n // 2, (n // 2,), (1,)),), new_bases=frozenset({o})),
        Op("del", None, del_bases=frozenset({t})),
    ]
    assert_all_equal(run_both(ops, []))


def test_gather_fill_mode():
    """jnp.take's default mode: negative indices wrap once, the rest of the
    out-of-range ones read NaN."""
    n = 40
    T, X, O = _base(n), _base(n), _base(n)
    vt, vx, vo = (View.contiguous(b, (n,)) for b in (T, X, O))
    ops = [Op("gather", vo, (vt, vx), axis=0, new_bases=frozenset({O}))]
    idx = np.arange(n, dtype=np.float64) * 3 - 50      # [-50, 67)
    res = run_both(ops, [np.arange(n) * 0.5, idx])
    assert np.isnan(res[0][0]).any() and not np.isnan(res[0][0]).all()
    assert_all_equal(res)


# ---------------------------------------------------------------------------
# promotion, mod, transcendental chains
# ---------------------------------------------------------------------------

def test_int_literal_keeps_integer_arithmetic():
    n = 8
    a, o = _base(n, np.int32), _base(n, np.int32)
    ops = [Op("mul", View.contiguous(o, (n,)), (View.contiguous(a, (n,)), 3),
              new_bases=frozenset({o}))]
    buf = np.array([2 ** 30, -2 ** 30, 2 ** 24 + 1, -1, 0, 1, 7, -7], np.int32)
    assert_all_equal(run_both(ops, [buf]))


def test_int_times_float_literal_promotes_to_float64():
    """PyTorch alone would compute int64 * 0.5 in float32; the port follows
    jnp's weak-type rule (float64)."""
    assert (torch.tensor([3, 5]) * 0.5).dtype == torch.float32
    assert op_dtypes("mul", [np.dtype(np.int64), 0.5])[0] == np.float64
    n = 6
    a, o = _base(n, np.int64), _base(n, np.float64)
    big = np.array([2 ** 40 + 1, -(2 ** 33) - 3, 5, 7, 2 ** 52, -1], np.int64)
    ops = [Op("mul", View.contiguous(o, (n,)), (View.contiguous(a, (n,)), 0.5),
              new_bases=frozenset({o}))]
    res = run_both(ops, [big])
    assert_all_equal(res)
    np.testing.assert_array_equal(res[3][0], big * 0.5)


@pytest.mark.parametrize("dtypes", [(np.int32, np.int32), (np.int64, np.float32),
                                    (np.int32, np.float64), (np.bool_, np.int32),
                                    (np.float32, np.float64)])
def test_promotion_table_matches_jnp(dtypes):
    import jax.numpy as jnp
    x, y = (jnp.zeros(2, d) for d in dtypes)
    assert promote([np.dtype(d) for d in dtypes]) == (x + y).dtype
    assert op_dtypes("div", [np.dtype(d) for d in dtypes])[0] == \
        jnp.divide(x, y).dtype
    assert op_dtypes("sqrt", [np.dtype(dtypes[0])])[0] == jnp.sqrt(x).dtype
    for lit in (0.5, 2, True):
        assert promote([np.dtype(dtypes[0]), lit]) == (x * lit).dtype


def test_mod_sign_follows_the_divisor():
    n = 12
    a, b, o, oi = _base(n), _base(n), _base(n), _base(n, np.int32)
    ai, bi = _base(n, np.int32), _base(n, np.int32)
    xa = np.array([7, -7, 7, -7, 0, 5.5, -5.5, 1e300, -3, 3, 2, -2])
    xb = np.array([3, 3, -3, -3, 2, 2, -2, 7, 0.5, -0.5, 3, 3])
    ops = [Op("mod", View.contiguous(o, (n,)), (View.contiguous(a, (n,)),
                                                View.contiguous(b, (n,))),
              new_bases=frozenset({o}))]
    res = run_both(ops, [xa, xb])
    assert_all_equal(res)
    np.testing.assert_array_equal(res[2][0], np.mod(xa, xb))
    opsi = [Op("mod", View.contiguous(oi, (n,)), (View.contiguous(ai, (n,)),
                                                  View.contiguous(bi, (n,))),
               new_bases=frozenset({oi}))]
    xai = np.array([7, -7, 7, -7, 0, 5, -5, 9, -3, 3, 2, -2], np.int32)
    xbi = np.array([3, 3, -3, -3, 2, 0, -2, 7, 1, -1, 3, 0], np.int32)
    assert_all_equal(run_both(opsi, [xai, xbi]))


def test_transcendental_chain_within_ulps():
    n = 1500
    rng = np.random.default_rng(3)
    X, T, O = _base(n), _base(n), _base(n)
    vx, vt, vo = (View.contiguous(b, (n,)) for b in (X, T, O))
    ops = [
        Op("exp", vt, (vx,), new_bases=frozenset({T})),
        Op("log", vt, (vt,)),
        Op("sin", vo, (vt,), new_bases=frozenset({O})),
        Op("erf", vt, (vx,)),
        Op("add", vo, (vo, vt)),
        Op("tanh", vt, (vx,)),
        Op("add", vo, (vo, vt)),
        Op("sigmoid", vt, (vx,)),
        Op("sub", vo, (vo, vt)),
        Op("abs", vt, (vx,)),
        Op("rsqrt", vt, (vt,)),
        Op("mul", vo, (vo, vt)),
        Op("del", None, del_bases=frozenset({T})),
    ]
    assert_all_equal(run_both(ops, [rng.standard_normal(n) * 2]), exact=False)


def test_facades_and_unfused_oracle_agree():
    """``kernel.build_fused_kernel`` (salt-less) and ``ref.reference_block``
    (every intermediate materialized) compute what the floor computes."""
    from repro_torch.kernels.fused_block.kernel import build_fused_kernel
    from repro_torch.kernels.fused_block.ref import reference_block
    n = 300
    a, b, t, o = _base(n), _base(n), _base(n), _base(n)
    va, vb, vt, vo = (View.contiguous(x, (n,)) for x in (a, b, t, o))
    ops = to_port([
        Op("mul", vt, (va, vb), new_bases=frozenset({t})),
        Op("add", vo, (vt, 1.5), new_bases=frozenset({o})),
        Op("maximum", vo, (vo, va)),
        Op("del", None, del_bases=frozenset({t})),
    ])
    rng = np.random.default_rng(4)
    bufs = [torch.from_numpy(_ints(rng, n)) for _ in range(2)]
    fn, _, _ = build_fused_kernel(ops)
    floor, _, _ = make_block_fn(ops)
    want = floor(*bufs, ())
    for got in (fn(*bufs), reference_block(ops, *bufs)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# what a launch must move and compute (the numerators of its bound)
# ---------------------------------------------------------------------------

def test_block_bytes_and_ops_count_what_the_kernel_touches():
    from repro_torch.core import ir as pir
    n = 700
    I, R, O = (pir.BaseArray(n, np.dtype(np.float64)) for _ in range(3))
    vi, vr, vo = (pir.View.contiguous(x, (n,)) for x in (I, R, O))
    ops = [
        pir.Op("range", vi, (), new_bases=frozenset({I})),
        pir.Op("random", vr, (), new_bases=frozenset({R})),
        pir.Op("mod", vo, (vi, 2.0), new_bases=frozenset({O})),
        pir.Op("mul", vo, (vo, vr)),
        pir.Op("del", None, del_bases=frozenset({I})),
        pir.Op("del", None, del_bases=frozenset({R})),
    ]
    plan = codegen._analyze(ops)
    # the drawn values are read once from device memory, O written once
    assert codegen.block_bytes(plan) == 2 * n * 8
    # range, mod and mul compute; random only loads
    assert codegen.block_ops(plan) == {"float64": 3 * n}

    A, B, C = (pir.BaseArray(n, np.dtype(np.float32)) for _ in range(3))
    va, vb, vc = (pir.View.contiguous(x, (n,)) for x in (A, B, C))
    ops = [
        pir.Op("copy", vb, (va,), new_bases=frozenset({B})),
        pir.Op("greater", vc, (va, vb), new_bases=frozenset({C})),
    ]
    plan = codegen._analyze(ops)
    assert codegen.block_bytes(plan) == 3 * n * 4      # A read once
    # the comparison runs in its operands' type, not its bool result's
    assert codegen.block_ops(plan) == {"float32": n}
