"""Card-only checks of the port's kernels — the fused-block generator (B1)
and the row-replay generator (B2) in Triton, the LM lane that runs them,
the standalone model kernels (B3 flash attention, B5 Mamba scan, B6 RWKV6
scan and B7 chunked RWKV6 in CUDA C++, B4 add+RMSNorm in Triton), the
decode-attention kernel (CUDA C++; the served shapes, bitwise repeats, no
use of keys outside the valid range, its refusals, one launch a layer at
a decode graph's capture and none at its replays) and the RWKV6 model
path that runs B6 and B7 — skipped without a CUDA device (and, for the
Triton kernels, Triton).

Also cross-flush loop fusion on the card: a drain replays one captured
CUDA graph of an iteration, bitwise the per-flush run; and the attention
families, whose every multi-token and cross attention runs B3: each
feature's B3 call against its plain version, Gemma2's ring decode past
the window as graph replays bitwise to eager steps, Whisper's
cross-attention, and serving against eager and the CPU.

Run on a GPU with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``.  Each case builds one block in the port's IR,
runs the generated kernel on CUDA tensors, and holds it against the torch
floor (``make_block_fn``) and the kernel's plain version on the same
inputs: bitwise for every elementwise op (libdevice is what PyTorch's CUDA
kernels call too) and for reductions over integer-valued data (every
summation order is exact there).  Real-valued row sums (softmax
normalizers, the LM's variances) are held to the summation error bound
``row * eps * magnitude``.  B3-B7 are held to their plain versions at
the reference's tolerances, run twice for bitwise-equal results, and fed
inputs they must refuse.
"""

import gc

import numpy as np
import pytest
import torch

from repro_torch.core.executor import make_block_fn
from repro_torch.core.ir import BaseArray, Op, View
from repro_torch.kernels.fused_block import codegen, rowblock

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    pytest.importorskip("triton")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _base(n, dtype=np.float64):
    return BaseArray(n, np.dtype(dtype))


def _run_all(ops, bufs, dev, salts=()):
    fn, ins, outs = codegen.build_block_kernel(ops, seed=3, device=dev)
    ref, rins, routs = make_block_fn(ops, seed=3, device=dev)
    assert list(ins) == list(rins) and list(outs) == list(routs)
    bufs = [b.to(dev) for b in bufs]
    before = codegen.LAUNCHES["fused_block"]
    got = fn(*bufs, salts)
    assert codegen.LAUNCHES["fused_block"] == before + 1
    return got, ref(*bufs, salts), fn.plain(*bufs, salts)


def _assert_same(got, *wants):
    for want in wants:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(torch.nan_to_num(g.cpu()),
                               torch.nan_to_num(w.cpu())), (g, w)


UNARY = ["copy", "sqrt", "exp", "log", "abs", "neg", "sin", "cos", "erf",
         "sign", "rsqrt", "tanh", "square", "reciprocal", "floor", "sigmoid"]
BINARY = ["add", "sub", "mul", "div", "pow", "maximum", "minimum", "greater",
          "less", "mod"]
F32_LIBM_DIFFERS = {"erf", "pow"}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("opcode", UNARY + BINARY)
def test_elementwise_op_bitwise(cuda, opcode, dtype):
    n = 5000
    rng = np.random.default_rng(7)
    a, b, o = _base(n, dtype), _base(n, dtype), _base(n, dtype)
    va, vb, vo = (View.contiguous(x, (n,)) for x in (a, b, o))
    ins = (va,) if opcode in UNARY else (va, vb)
    ops = [Op(opcode, vo, ins, new_bases=frozenset({o}))]
    xa = rng.standard_normal(n) * 3
    xb = rng.standard_normal(n) * 3
    if opcode in ("sqrt", "log", "rsqrt", "pow"):
        xa = np.abs(xa) + 0.1
    bufs = [torch.from_numpy(x.astype(dtype)) for x in (xa, xb)][:len(ins)]
    got, floor, plain = _run_all(ops, bufs, cuda)
    if dtype == np.float32 and opcode in F32_LIBM_DIFFERS:
        # PyTorch's float32 erf and pow are its own, not libdevice's: hold
        # them to 4 ulp (the programs run in float64, where they agree
        # bit for bit)
        for want in (floor[0], plain[0]):
            ulps = (got[0].view(torch.int32).long()
                    - want.view(torch.int32).long()).abs().max().item()
            assert ulps <= 4, ulps
    else:
        _assert_same(got, floor, plain)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16])
def test_neg_of_signed_zeros_bitwise(cuda, dtype):
    """B1's ``neg`` flips the sign bit of every float, zeros included:
    ``neg(+0)`` is -0, bit for bit with the floor and with IEEE negation
    (``np.negative``, which ``jnp.negative`` is: the CPU test
    ``test_torch_codegen.py::test_float_neg_is_a_product_with_minus_one``
    holds the plain version against the JAX package's)."""
    x = np.array([0.0, -0.0, 1.5, -2.0, np.inf, -np.inf, 6e-5, -3.0] * 100,
                 dtype)
    n = x.size
    a, o = _base(n, dtype), _base(n, dtype)
    ops = [Op("neg", View.contiguous(o, (n,)), (View.contiguous(a, (n,)),),
              new_bases=frozenset({o}))]
    got, floor, plain = _run_all(ops, [torch.from_numpy(x)], cuda)
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.itemsize]
    want = torch.from_numpy(np.negative(x)).view(ints)
    for res in (got, floor, plain):
        assert torch.equal(res[0].cpu().view(ints), want)


@pytest.mark.parametrize("literal", [0.1, 3, -2.5])
def test_literal_promotion_and_rounding(cuda, literal):
    """int32 x float literal promotes to float64; float32 x literal rounds
    the literal to float32 first — exactly as the floor does."""
    n = 777
    for dt in (np.int32, np.float32, np.float64):
        a, o = _base(n, dt), _base(n, np.float64)
        ops = [Op("mul", View.contiguous(o, (n,)),
                  (View.contiguous(a, (n,)), literal),
                  new_bases=frozenset({o}))]
        x = torch.from_numpy((np.arange(n) - 300).astype(dt))
        got, *wants = _run_all(ops, [x], cuda)
        _assert_same(got, *wants)


@pytest.mark.parametrize("opcode", ["reduce_sum", "reduce_max", "reduce_min",
                                    "reduce_prod"])
@pytest.mark.parametrize("shape,axis", [((100_003,), 0), ((300, 517), 1),
                                        ((517, 300), 0), ((5, 6, 4099), 2)])
def test_reductions_bitwise_and_deterministic(cuda, opcode, shape, axis):
    n = int(np.prod(shape))
    rng = np.random.default_rng(n)
    lo, hi = (1, 3) if opcode == "reduce_prod" else (-9, 9)
    data = rng.integers(lo, hi, n).astype(np.float64)
    if opcode == "reduce_prod":
        data = np.where(rng.random(n) < 0.999, 1.0, data)   # stay finite
    a = _base(n)
    out_shape = shape[:axis] + shape[axis + 1:]
    r = _base(max(1, int(np.prod(out_shape))))
    ops = [Op(opcode, View.contiguous(r, out_shape),
              (View.contiguous(a, shape),), axis=axis,
              new_bases=frozenset({r}))]
    got, *wants = _run_all(ops, [torch.from_numpy(data)], cuda)
    _assert_same(got, *wants)
    again, *_ = _run_all(ops, [torch.from_numpy(data)], cuda)
    _assert_same(again, got)


def test_stencil_rmw_and_broadcasts(cuda):
    m = 300
    g = _base(m * m)
    inner = _base((m - 2) * (m - 2))
    win = lambda i0, j0: View(g, i0 * m + j0, (m - 2, m - 2), (m, 1))  # noqa: E731
    vin = View.contiguous(inner, (m - 2, m - 2))
    row, col = _base(m - 2), _base(m - 2)
    ops = [
        Op("add", vin, (win(1, 0), win(1, 2)), new_bases=frozenset({inner})),
        Op("add", vin, (vin, win(0, 1))),
        Op("mul", vin, (vin, View(row, 0, (m - 2, m - 2), (0, 1)))),
        Op("add", vin, (vin, View(col, 0, (m - 2, m - 2), (1, 0)))),
        Op("mul", vin, (vin, 0.25)),
        Op("copy", win(1, 1), (vin,)),
        Op("del", None, del_bases=frozenset({inner})),
    ]
    rng = np.random.default_rng(1)
    bufs = [torch.from_numpy(rng.standard_normal(k)) for k in
            (m * m, m - 2, m - 2)]
    got, *wants = _run_all(ops, bufs, cuda)
    _assert_same(got, *wants)


def test_range_random_gather_mod(cuda):
    n = 4097
    I, R, O, T, X = (_base(n) for _ in range(5))
    vi, vr, vo, vt, vx = (View.contiguous(x, (n,)) for x in (I, R, O, T, X))
    ops = [
        Op("range", vi, (), new_bases=frozenset({I})),
        Op("random", vr, (), new_bases=frozenset({R})),
        Op("mod", vo, (vi, -3.0), new_bases=frozenset({O})),
        Op("mul", vo, (vo, vr)),
        Op("sub", vx, (vi, 2000.0), new_bases=frozenset({X})),
        Op("mul", vx, (vx, 3.0)),
        Op("gather", vx, (vt, vx), axis=0),     # indices in [-6000, 6300)
        Op("del", None, del_bases=frozenset({I})),
        Op("del", None, del_bases=frozenset({R})),
    ]
    table = torch.arange(n, dtype=torch.float64) * 0.5
    got, *wants = _run_all(ops, [table], cuda, salts=(17,))
    _assert_same(got, *wants)


def test_gather_at_a_literal_index(cuda):
    """The gather's index is computed from a literal alone, a scalar in
    the kernel: the load still takes the domain's shape and compiles."""
    n = 4096
    F, I, O, T = (_base(n) for _ in range(4))
    vf, vi, vo, vt = (View.contiguous(b, (n,)) for b in (F, I, O, T))
    ops = [
        Op("copy", vf, (-7.0,), new_bases=frozenset({F})),
        Op("abs", vi, (vf,), new_bases=frozenset({I})),
        Op("mod", vi, (vi, float(n))),
        Op("floor", vi, (vi,)),
        Op("gather", vo, (vt, vi), axis=0, new_bases=frozenset({O})),
        Op("del", None, del_bases=frozenset({I})),
    ]
    table = torch.arange(n, dtype=torch.float64) * 0.5
    got, *wants = _run_all(ops, [table], cuda)
    _assert_same(got, *wants)
    assert any(bool((g == 3.5).all()) for g in got)


def test_program_end_to_end_matches_floor(cuda):
    from repro_torch.core.lazy import fresh_runtime
    from repro_torch.testing.programs import BENCHMARKS
    out = {}
    for backend in ("torch", "triton"):
        with fresh_runtime(backend=backend, loop_fusion=False) as rt:
            out[backend] = np.asarray(BENCHMARKS["heat_equation"](3, 200))
            if backend == "triton":
                assert rt.executor.stats["triton_blocks"] > 0
    np.testing.assert_array_equal(out["triton"], out["torch"])


def test_integer_block_bitwise(cuda):
    """int32 arithmetic in one kernel: jnp.mod's sign rule (and its
    divisor-zero guard), integer max/sign/where, and a gather from an int64
    table whose out-of-range lanes read the most negative int64."""
    n = 3001
    a, b, o, s, w = (_base(n, np.int32) for _ in range(5))
    tbl, g = _base(97, np.int64), _base(n, np.int64)
    va, vb, vo, vs, vw, vg = (View.contiguous(x, (n,)) for x in
                              (a, b, o, s, w, g))
    ops = [
        Op("mod", vo, (va, vb), new_bases=frozenset({o})),
        Op("maximum", vo, (vo, 3)),
        Op("sign", vs, (va,), new_bases=frozenset({s})),
        Op("greater", vw, (va, vb), new_bases=frozenset({w})),
        Op("where", vw, (vw, va, vb)),
        Op("gather", vg, (View.contiguous(tbl, (97,)), va), axis=0,
           new_bases=frozenset({g})),
    ]
    rng = np.random.default_rng(5)
    bufs = [torch.from_numpy(rng.integers(-150, 150, n).astype(np.int32)),
            torch.from_numpy(rng.integers(-4, 5, n).astype(np.int32)),
            torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, 97))]
    got, *wants = _run_all(ops, bufs, cuda)
    assert (got[-1] == torch.iinfo(torch.int64).min).any()
    _assert_same(got, *wants)


# ---------------------------------------------------------------------------
# kernel B1, one launch a block: in-kernel draws, stores, mod by 2**k
# ---------------------------------------------------------------------------

_INT = {np.float64: torch.int64, np.float32: torch.int32,
        np.float16: torch.int16}


def _bits_equal(got, want):
    """Bit for bit, NaN as NaN (whatever its payload)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    it = _INT[np.dtype(str(got.dtype).split(".")[1]).type]
    assert torch.equal(got.view(it)[~nan], want.view(it)[~nan])


def _compiled_variants(jit_fn) -> int:
    """Compiled specializations of a Triton JIT function (its cache layout
    differs across Triton versions)."""
    caches = getattr(jit_fn, "device_caches", None)
    if caches is not None:
        return sum(len(c[0]) for c in caches.values())
    return sum(len(c) for c in jit_fn.cache.values())


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16])
@pytest.mark.parametrize("shape", [(1,), (4097,), (1_000_003,), (33, 1537),
                                   (5, 7, 300), (2, 3, 4099)])
def test_in_kernel_random_is_uniform_at(cuda, shape, dtype):
    """Every element draws ``prng.uniform_at``'s bits at its flat index —
    ragged rows and columns, 1-D to 3-D domains, three widths — for salts
    whose key words are small, past 2**31 and anything between, and one
    compiled kernel serves them all."""
    from repro_torch.core import prng
    n = int(np.prod(shape))
    r = _base(n, dtype)
    ops = [Op("random", View.contiguous(r, shape), (),
              new_bases=frozenset({r}))]
    fn, _, _ = codegen.build_block_kernel(ops, seed=2 ** 40 + 3, device=cuda)
    idx = torch.arange(n, device=cuda)
    salts = (0, 1, 17, 2 ** 31 - 2, 123456789)
    for salt in salts:
        got, = fn((salt,))
        _bits_equal(got, prng.uniform_at(2 ** 40 + 3, salt, idx, dtype))
    assert _compiled_variants(fn._gen[False][0].block_kernel) == 1


def _rmw_ops(m):
    g, r, h = _base(m * m), _base((m - 2) ** 2), _base(m * m)
    win = View(g, m + 1, (m - 2, m - 2), (m, 1))
    hwin = View(h, m + 1, (m - 2, m - 2), (m, 1))
    vr = View.contiguous(r, (m - 2, m - 2))
    return [Op("add", win, (vr, 1.0)), Op("mul", win, (win, 0.5)),
            Op("add", hwin, (hwin, win))]


@pytest.mark.parametrize("m", [10, 300, 2049])
def test_window_writes_copy_and_in_place_bitwise(cuda, m):
    """Window writes stored in-kernel: without a grant into copies, with
    one into the granted input's own storage; a buffer outside the grant
    never changes; both equal the floor and the plain version."""
    ops = _rmw_ops(m)
    fn, ins, outs = codegen.build_block_kernel(ops, device=cuda)
    floor, _, _ = make_block_fn(ops, device=cuda)
    rng = np.random.default_rng(m)
    bufs = [torch.from_numpy(rng.standard_normal(fn.plan.base_meta[u][0]))
            .to(cuda) for u in ins]
    keep = [b.clone() for b in bufs]
    want, plain = floor(*bufs, ()), fn.plain(*bufs, ())
    copied = fn(*bufs, ())
    assert all(torch.equal(b, k) for b, k in zip(bufs, keep))
    pos = {u: k for k, u in enumerate(ins)}
    g, h = (pos[u] for u in outs)
    got = fn(*bufs, (), reuse=frozenset({g}))
    assert got[0] is bufs[g] and torch.equal(bufs[h], keep[h])
    for x in (copied, got):
        for a, w, p in zip(x, want, plain):
            _bits_equal(a, w)
            _bits_equal(a, p)


def test_stencil_with_shifted_reads_takes_the_copy(cuda):
    """Reads of ``g`` at shifted views and a write of its interior in one
    (hand-built) block: granted reuse, the kernel still stores into a copy
    — in place, other programs would read overwritten elements — and
    equals the floor bit for bit."""
    m = 1500
    g, inner = _base(m * m), _base((m - 2) ** 2)
    win = lambda i0, j0: View(g, i0 * m + j0, (m - 2, m - 2), (m, 1))  # noqa: E731
    vin = View.contiguous(inner, (m - 2, m - 2))
    ops = [Op("add", vin, (win(1, 0), win(1, 2)), new_bases=frozenset({inner})),
           Op("add", vin, (vin, win(0, 1))), Op("add", vin, (vin, win(2, 1))),
           Op("mul", vin, (vin, 0.25)), Op("copy", win(1, 1), (vin,)),
           Op("del", None, del_bases=frozenset({inner}))]
    fn, _, _ = codegen.build_block_kernel(ops, device=cuda)
    floor, _, _ = make_block_fn(ops, device=cuda)
    assert not fn.plan.in_place
    buf = torch.from_numpy(np.random.default_rng(2).standard_normal(m * m)) \
        .to(cuda)
    keep = buf.clone()
    got, = fn(buf, (), reuse=frozenset({0}))
    assert got is not buf and torch.equal(buf, keep)
    _bits_equal(got, floor(buf, ())[0])


def test_overlapping_writes_and_reduction_outputs_bitwise(cuda):
    """Two overlapping window writes of one base (the earlier masked off
    the later's elements) and a full reduction stored by its combine pass
    into a float32 base (cast from its float64 sum in-kernel)."""
    n = 100_003
    a, o, s = _base(n), _base(n + 10), _base(1, np.float32)
    va = View.contiguous(a, (n,))
    ops = [Op("mul", View(o, 0, (n,), (1,)), (va, 2.0)),
           Op("add", View(o, 5, (n,), (1,)), (va, 1.0)),
           Op("reduce_sum", View.contiguous(s, ()), (va,), axis=0,
              new_bases=frozenset({s}))]
    rng = np.random.default_rng(8)
    bufs = [torch.from_numpy(rng.integers(-9, 9, n).astype(np.float64)),
            torch.from_numpy(rng.standard_normal(n + 10))]
    got, floor, plain = _run_all(ops, bufs, cuda)
    for g, f, p in zip(got, floor, plain):
        _bits_equal(g, f)
        _bits_equal(g, p)


def _mod_edges(dtype, k):
    fi = np.finfo(dtype)
    b = 2.0 ** k
    t = float(fi.smallest_subnormal)
    vals = [0.0, -0.0, t, -t, 3 * t, -3 * t, float(fi.tiny) / 2,
            -float(fi.tiny) / 2, float(fi.tiny), -float(fi.tiny),
            -4 * b, -b, b, 4 * b, -3 * b, -1e-20, 1e-20, -b / 3, b / 3,
            7.25, -7.25, float(fi.max), -float(fi.max), float(fi.max) / 2,
            -2.0 ** (fi.nmant + k), 2.0 ** (fi.nmant + k) - b,
            np.inf, -np.inf, np.nan]
    rng = np.random.default_rng(k + 10)
    vals += list(rng.standard_normal(4000) * b * 10)
    vals += list(-(rng.integers(1, 1000, 100) * b))
    return np.array(vals, dtype=dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("k", [-3, 1, 5])
def test_mod_by_power_of_two_bitwise(cuda, dtype, k):
    """``mod`` by a literal ``2**k`` (the formula, no ``fmod``) gives the
    floor's bits — signed zeros included — on ±0, subnormals of both
    signs, negative exact multiples, overflowing ``x·2⁻ᵏ``, ±inf and
    NaN."""
    x = _mod_edges(dtype, k)
    n = x.size
    a, o = _base(n, dtype), _base(n, dtype)
    ops = [Op("mod", View.contiguous(o, (n,)), (View.contiguous(a, (n,)),
                                                2.0 ** k),
              new_bases=frozenset({o}))]
    got, floor, plain = _run_all(ops, [torch.from_numpy(x)], cuda)
    _bits_equal(got[0], floor[0])
    _bits_equal(got[0], plain[0])


# ---------------------------------------------------------------------------
# kernel B2: the row-replay generator
# ---------------------------------------------------------------------------

def _replay_ops(r, c):
    """Two reductions re-read in-block through trailing broadcasts, every
    reduction output and dense result live, a bool mask broadcast over the
    rows and a column operand: ``s = sum(x*x)``, ``o = where(mask, x*s,
    col)``, ``m = max(o)``, ``o2 = o - m``."""
    f32 = np.float32
    x, sq, s, o, m, o2 = (_base(r * c, f32), _base(r * c, f32), _base(r, f32),
                          _base(r * c, f32), _base(r, f32), _base(r * c, f32))
    mask, col = _base(c, np.bool_), _base(r, f32)
    d = (r, c)
    vx, vsq, vo, vo2 = (View.contiguous(b, d) for b in (x, sq, o, o2))
    return [
        Op("mul", vsq, (vx, vx), new_bases=frozenset({sq})),
        Op("reduce_sum", View.contiguous(s, (r,)), (vsq,), axis=1,
           new_bases=frozenset({s})),
        Op("mul", vo, (vx, View(s, 0, d, (1, 0))), new_bases=frozenset({o})),
        Op("where", vo, (View(mask, 0, d, (0, 1)), vo,
                         View(col, 0, d, (1, 0)))),
        Op("reduce_max", View.contiguous(m, (r,)), (vo,), axis=1,
           new_bases=frozenset({m})),
        Op("sub", vo2, (vo, View(m, 0, d, (1, 0))), new_bases=frozenset({o2})),
        Op("del", None, del_bases=frozenset({sq})),
    ]


@pytest.mark.parametrize("r,c", [(3, 5), (40, 64), (7, 300), (2048, 2560),
                                 (80, 1024), (5, 4097)])
def test_rowblock_kernel_bitwise_and_deterministic(cuda, r, c):
    """Integer-valued data: every row sum is exact, so the kernel equals
    the floor and its plain version bit for bit, and two runs agree."""
    ops = _replay_ops(r, c)
    fn, ins, outs = rowblock.build_rowblock_kernel(ops, device=cuda)
    floor, fins, fouts = make_block_fn(ops, device=cuda)
    assert list(ins) == list(fins) and list(outs) == list(fouts)
    rng = np.random.default_rng(r * c)
    bufs = [torch.from_numpy(rng.integers(-8, 8, r * c).astype(np.float32)),
            torch.from_numpy(rng.random(c) < 0.7),
            torch.from_numpy(rng.integers(-8, 8, r).astype(np.float32))]
    bufs = [b.to(cuda) for b in bufs]
    before = rowblock.LAUNCHES["rowblock"]
    got = fn(*bufs, ())
    assert rowblock.LAUNCHES["rowblock"] == before + 1
    _assert_same(got, floor(*bufs, ()), fn.plain(*bufs, ()))
    _assert_same(fn(*bufs, ()), got)


@pytest.mark.parametrize("seed", range(8))
def test_check_lm_on_card(cuda, seed):
    """The lm stack against the torch floor on the LM grammars: bitwise
    where the row sums are exact, else within the summation bound."""
    from repro_torch.testing.tapegen import check_lm
    before = rowblock.LAUNCHES["rowblock"]
    check_lm(seed, device=cuda)
    if seed % 4 != 2:                  # moe has no claimant
        assert rowblock.LAUNCHES["rowblock"] > before


def test_lazy_transformer_on_card(cuda):
    """The tiny LM through the lm stack, the torch floor and the direct
    model on the card: logits and caches within 1e-5 (order-1 logits;
    float32 sums over 64-128 terms in other orders), full-float32 matmuls.
    Two heads of 32: the direct model's prefill attention is kernel B3,
    built for head dims 32-256."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.lazy_transformer import LazyTransformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="lm_tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=97,
                      dtype="float32", param_dtype="float32",
                      norm_plus_one=True, tie_embeddings=False)
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    tokens = np.asarray([[3, 14, 15, 92, 65, 35], [8, 9, 79, 3, 2, 38]],
                        np.int32)
    lm = LazyTransformer(params, cfg)
    floor = LazyTransformer(params, cfg, backend="torch")
    tol = dict(rtol=0, atol=1e-5)
    before = rowblock.LAUNCHES["rowblock"]
    got = lm.forward(tokens)
    np.testing.assert_allclose(got, floor.forward(tokens), **tol)
    np.testing.assert_allclose(got, T.forward(params, tokens, cfg)[0]
                               .cpu().numpy(), **tol)
    d_l, d_c = T.serve_prefill(params, tokens, cfg, 16)
    got = lm.prefill(tokens, 16)
    np.testing.assert_allclose(got, floor.prefill(tokens, 16), **tol)
    np.testing.assert_allclose(got, d_l.cpu().numpy(), **tol)
    for step in range(3):
        tok = np.asarray([[5 + step], [11 + step]], np.int32)
        d_l, d_c = T.serve_decode(params, d_c, tok, cfg)
        got = lm.decode(tok)
        np.testing.assert_allclose(got, floor.decode(tok), **tol)
        np.testing.assert_allclose(got, d_l.cpu().numpy(), **tol)
        claims = lm.rt.history[-1]["exec"]["backend_blocks"]
        assert claims["rmsnorm"] >= 2 * cfg.n_layers + 1
        assert claims["flash_attention"] >= 2 * cfg.n_layers
    for li, (k, v) in enumerate(lm.cache_numpy()):
        np.testing.assert_allclose(k, d_c["l0"]["k"][li].cpu().numpy(), **tol)
        np.testing.assert_allclose(v, d_c["l0"]["v"][li].cpu().numpy(), **tol)
    assert rowblock.LAUNCHES["rowblock"] > before


# ---------------------------------------------------------------------------
# the standalone model kernels B3-B7 against their plain versions on the card
# ---------------------------------------------------------------------------

#: kernel vs plain version on the card, per element |err| <= rtol·|plain| +
#: atol: atol the reference's own float32 tolerances (attention and norm
#: 2e-5, scans 3e-4: sums in other orders); rtol 0 for float32 outputs and
#: one bf16 ulp, 2^-7 of the value, for bfloat16 outputs (both sides compute
#: in float32 and round once)
F32_TOL = {"attention": 2e-5, "rmsnorm": 2e-5, "scan": 3e-4}
BF16_RTOL = 2.0 ** -7


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev, scale=1.0):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            * scale).to(dev, dtype)


def _hold(got, want, kind):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    rtol = BF16_RTOL if got.dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.double(), want.double(), rtol=rtol,
                               atol=F32_TOL[kind])


def _twice_same(fn, launches, key):
    """Run ``fn`` twice: one launch each, bitwise-equal results."""
    before = launches[key]
    a = fn()
    b = fn()
    torch.cuda.synchronize()
    assert launches[key] == before + 2
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y)
    return a


@pytest.mark.parametrize("sq,sk,hq,hkv,d,causal,window,softcap,dtype", [
    (100, 100, 4, 2, 64, True, None, None, torch.float32),     # ragged, GQA
    (64, 256, 2, 1, 128, True, None, None, torch.float32),     # cross-length
    (130, 77, 2, 2, 32, False, None, None, torch.float32),     # ragged, MHA
    (200, 200, 4, 2, 256, True, 64, 50.0, torch.float32),      # D 256
    (256, 256, 2, 2, 128, True, 8, None, torch.float32),       # masked tiles
    (160, 64, 2, 1, 64, False, 16, None, torch.float32),       # masked rows
    (150, 20, 2, 1, 128, True, None, 50.0, torch.float32),     # Sk < a tile
    (90, 90, 2, 1, 32, True, 4, 20.0, torch.float32),          # window 4
    (128, 128, 2, 1, 256, True, 32, 50.0, torch.bfloat16),
    (300, 300, 4, 1, 64, True, None, 30.0, torch.bfloat16),    # MQA
    (70, 20, 4, 2, 32, False, None, None, torch.bfloat16),     # Sk < a tile
    (200, 333, 4, 2, 128, True, 48, 50.0, torch.bfloat16),     # window 48
    (100, 40, 2, 2, 128, False, 8, None, torch.bfloat16),      # masked rows
    (129, 129, 3, 1, 256, False, None, None, torch.bfloat16),  # one row over
])
def test_flash_attention_kernel(card, sq, sk, hq, hkv, d, causal, window,
                                softcap, dtype):
    """B3 against its plain version on every (dtype, D) instance: Sq and Sk
    that are not multiples of the query tiles (64 or 128 rows) and the key
    tiles (16, 32 or 64 keys), Sk shorter than one key tile, windows narrower
    than a key tile (whole tiles masked for some rows), rows with no
    unmasked key at all (which average v, as the plain version does), MQA
    and GQA, softcap in both dtypes."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import reference_attention
    rng = np.random.default_rng(sq * sk + d)
    q = _randn(rng, (2, hq, sq, d), dtype, card)
    k = _randn(rng, (2, hkv, sk, d), dtype, card)
    v = _randn(rng, (2, hkv, sk, d), dtype, card)
    got = _twice_same(lambda: attention(q, k, v, causal, window, softcap),
                      fa.LAUNCHES, "flash_attention")
    want = reference_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    _hold(got, want, "attention")


def test_flash_attention_refuses(card):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    x = torch.zeros((1, 2, 8, 64), device=card)
    with pytest.raises(TypeError):
        flash_attention(x.double(), x.double(), x.double())
    with pytest.raises(TypeError):
        flash_attention(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(torch.zeros((1, 8, 2, 64), device=card)
                        .transpose(1, 2), x, x)
    with pytest.raises(ValueError, match="head dim"):
        y = torch.zeros((1, 2, 8, 48), device=card)
        flash_attention(y, y, y)
    with pytest.raises(ValueError, match="aligned"):
        z = torch.zeros(x.numel() + 1, device=card)[1:].view(x.shape)
        flash_attention(z, x, x)


# ---------------------------------------------------------------------------
# the decode-attention kernel: a decode step's one-token attention over its
# KV caches where they lie
# ---------------------------------------------------------------------------

#: (B, T, H, Hkv, hd, dtype, ring, window, softcap, idx): the benchmark's
#: served shapes (OLMoE-1B-7B chat and rag, Jamba-v0.1 chat), Gemma2-9B's
#: 256-deep ring with its softcap (filling and past the window), a linear
#: cache with a window, the groups of Qwen3-MoE (16) and StarCoder2 (12),
#: float32 caches, every head dim and the first and last slots
DECODE_CASES = {
    "olmoe_chat": (32, 1280, 16, 16, 128, torch.bfloat16, False, None, None,
                   1151),
    "olmoe_chat_last": (32, 1280, 16, 16, 128, torch.bfloat16, False, None,
                        None, 1279),
    "olmoe_rag": (8, 3600, 16, 16, 128, torch.bfloat16, False, None, None,
                  3591),
    "jamba_chat": (32, 1280, 32, 8, 128, torch.bfloat16, False, None, None,
                   1100),
    "gemma2_ring_past": (2, 256, 16, 8, 256, torch.bfloat16, True, 256, 50.0,
                         700),
    "gemma2_ring_filling": (2, 256, 16, 8, 256, torch.bfloat16, True, 256,
                            50.0, 100),
    "window": (3, 512, 8, 2, 64, torch.bfloat16, False, 100, None, 400),
    "group16": (2, 700, 64, 4, 128, torch.bfloat16, False, None, None, 650),
    "group12": (2, 300, 24, 2, 128, torch.bfloat16, False, None, None, 299),
    "bf16_hd32": (2, 64, 4, 2, 32, torch.bfloat16, False, None, None, 33),
    "f32_gqa": (4, 300, 8, 2, 64, torch.float32, False, None, None, 150),
    "f32_hd128": (4, 1000, 8, 8, 128, torch.float32, False, None, None, 777),
    "f32_hd256_window_softcap": (2, 200, 4, 1, 256, torch.float32, False, 48,
                                 30.0, 199),
    "f32_hd32_first": (3, 40, 4, 4, 32, torch.float32, False, None, None, 0),
    "f32_ring": (2, 8, 4, 2, 32, torch.float32, True, 8, None, 20),
}


def _decode_inputs(case, dev):
    """q, k, v and idx of a ``DECODE_CASES`` case, drawn on the card, and
    the call's mask options."""
    b, t, h, hkv, hd, dtype, ring, window, softcap, at = DECODE_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(t + h + hd)
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, t, hkv, hd), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    idx = torch.tensor(at, dtype=torch.int32, device=dev)
    return (q, k, v, idx), dict(ring=ring, window=window, softcap=softcap)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_attention_kernel(card, case):
    """The kernel against its plain version (B3's tolerance), one launch a
    call, two calls bitwise equal."""
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention.ref import \
        reference_decode_attention
    args, kw = _decode_inputs(case, card)
    got = _twice_same(lambda: da.decode_attention(*args, **kw), da.LAUNCHES,
                      "decode_attention")
    _hold(got, reference_decode_attention(*args, **kw), "attention")


@pytest.mark.parametrize("case", ["olmoe_chat", "window",
                                  "gemma2_ring_filling", "f32_gqa"])
def test_decode_attention_reads_only_the_valid_keys(card, case):
    """Keys and values outside the valid range (past the index, before
    the window, a ring's empty slots) filled with NaN change no bit of
    the output: the kernel uses nothing there."""
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention.ref import valid_keys
    (q, k, v, idx), kw = _decode_inputs(case, card)
    want = da.decode_attention(q, k, v, idx, **kw)
    keep = valid_keys(idx, k.shape[1], ring=kw["ring"],
                      window=kw["window"])[0]
    assert not keep.all()
    k[:, ~keep] = float("nan")
    v[:, ~keep] = float("nan")
    assert torch.equal(da.decode_attention(q, k, v, idx, **kw), want)


def test_decode_attention_split_count_is_the_shapes(card):
    """The split counts of the served shapes on this card: a function of
    the shapes alone, more splits where there are fewer (row, head)
    pairs, no more than ``BLOCKS_PER_SM`` blocks an SM but with one
    split."""
    from repro_torch.kernels.decode_attention import kernel as da
    sms = da._sm_count(card)
    chat = da.split_count(32, 16, 1, 1280, 128, 2, sms)
    rag = da.split_count(8, 16, 1, 3600, 128, 2, sms)
    jamba = da.split_count(32, 8, 4, 1280, 128, 2, sms)
    assert 1 <= chat < rag and chat <= jamba
    for blocks, n in ((32 * 16, chat), (8 * 16, rag), (32 * 8 * 2, jamba)):
        assert n == 1 or blocks * n <= da.BLOCKS_PER_SM * sms


def test_decode_attention_refuses(card):
    from repro_torch.kernels.decode_attention.kernel import decode_attention
    q = torch.zeros((2, 1, 4, 64), device=card)
    k = torch.zeros((2, 16, 2, 64), device=card)
    idx = torch.tensor(3, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        decode_attention(q.double(), k.double(), k.double(), idx)
    with pytest.raises(TypeError):
        decode_attention(q, k.bfloat16(), k.bfloat16(), idx)
    with pytest.raises(TypeError, match="int32"):
        decode_attention(q, k, k, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, torch.zeros((2, 2, 16, 64), device=card)
                         .transpose(1, 2), k, idx)
    with pytest.raises(ValueError, match="head dim"):
        y, z = torch.zeros((2, 1, 4, 48), device=card), \
            torch.zeros((2, 16, 2, 48), device=card)
        decode_attention(y, z, z, idx)
    with pytest.raises(ValueError, match="aligned"):
        w = torch.zeros(q.numel() + 1, device=card)[1:].view(q.shape)
        decode_attention(w, k, k, idx)
    with pytest.raises(ValueError, match="shapes"):
        decode_attention(q.expand(2, 2, 4, 64), k, k, idx)
    with pytest.raises(ValueError, match="softcap"):
        decode_attention(q, k, k, idx, softcap=-1.0)
    with pytest.raises(ValueError, match="window"):
        decode_attention(q, k, k, idx, window=0)


@pytest.mark.parametrize("shape,plus_one,dtype", [
    ((8, 128), False, torch.float32),
    ((100, 2560), True, torch.float32),
    ((3, 5, 1000), False, torch.float32),
    ((300, 3584), True, torch.bfloat16),
])
def test_rmsnorm_kernel(cuda, shape, plus_one, dtype):
    """B4 against its plain version; ``y`` from the float32 sum."""
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm.ops import add_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import reference_add_rmsnorm
    rng = np.random.default_rng(shape[-1])
    x, r = (_randn(rng, shape, dtype, cuda) for _ in range(2))
    g = _randn(rng, shape[-1:], dtype, cuda)
    got = _twice_same(lambda: add_rmsnorm(x, r, g, 1e-6, plus_one),
                      rk.LAUNCHES, "rmsnorm")
    want = reference_add_rmsnorm(x, r, g, plus_one=plus_one)
    for a, b in zip(got, want):
        _hold(a, b, "rmsnorm")


def test_rmsnorm_reads_strided_rows_and_refuses(cuda):
    from repro_torch.kernels.rmsnorm.kernel import fused_add_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import reference_add_rmsnorm
    rng = np.random.default_rng(5)
    wide = _randn(rng, (64, 700), torch.float32, cuda)
    x, r = wide[:, :640], wide[:, 60:]         # row stride 700, no copy
    g = _randn(rng, (640,), torch.float32, cuda)
    for a, b in zip(fused_add_rmsnorm(x, r, g),
                    reference_add_rmsnorm(x, r, g)):
        _hold(a, b, "rmsnorm")
    with pytest.raises(TypeError):
        fused_add_rmsnorm(x.double(), r.double(), g)
    with pytest.raises(RuntimeError, match="view"):
        t = torch.zeros((4, 3, 640), device=cuda)[:, :2]   # rows need a copy
        fused_add_rmsnorm(t.transpose(0, 1), t.transpose(0, 1), g)


def _mamba_inputs(rng, b, t, di, ds, dtype, dev):
    softplus = torch.nn.functional.softplus
    return (_randn(rng, (b, t, di), dtype, dev),
            (softplus(_randn(rng, (b, t, di), torch.float32, dev)) * 0.1)
            .to(dtype),
            _randn(rng, (b, t, ds), dtype, dev),
            _randn(rng, (b, t, ds), dtype, dev),
            (-softplus(_randn(rng, (di, ds), torch.float32, dev)) - 0.2)
            .to(dtype),
            _randn(rng, (di,), dtype, dev))


@pytest.mark.parametrize("b,t,di,ds,chunk,dtype", [
    (2, 64, 32, 8, 32, torch.float32),        # T a multiple of chunk
    (1, 100, 130, 16, 64, torch.float32),     # ragged T and channels
    (2, 40, 64, 5, 64, torch.float32),        # T below chunk, odd d_state
    (1, 70, 96, 64, 32, torch.float32),       # the widest state
    (1, 64, 64, 16, 64, torch.bfloat16),
])
def test_mamba_kernel(card, b, t, di, ds, chunk, dtype):
    from repro_torch.kernels.mamba_scan import kernel as mk
    from repro_torch.kernels.mamba_scan.ops import mamba
    from repro_torch.kernels.mamba_scan.ref import reference_mamba
    ins = _mamba_inputs(np.random.default_rng(t * di), b, t, di, ds, dtype,
                        card)
    got = _twice_same(lambda: mamba(*ins, chunk), mk.LAUNCHES, "mamba_scan")
    _hold(got, reference_mamba(*ins), "scan")


@pytest.mark.parametrize("ds,dtype", [
    (1, torch.float32),                       # 1 lane x 2 states
    (2, torch.bfloat16),
    (4, torch.float32),                       # 1 lane x 4
    (5, torch.float32),                       # 2 lanes x 4, plain loads
    (16, torch.float32),                      # 4 lanes x 4, Jamba's
    (16, torch.bfloat16),
    (64, torch.bfloat16),                     # 16 lanes x 4, the widest
])
def test_mamba_kernel_layouts(card, ds, dtype):
    """Both kernel instances (2 and 4 states a lane) in the layouts
    :func:`kernel.layout` gives, on ragged T (three tiles and 9 steps) and
    channels (200, not a multiple of a block's 64), against the plain
    version; rows that are not 16-byte multiples (d_state 1 and 5 in
    float32) take the plain-load ring."""
    from repro_torch.kernels.mamba_scan import kernel as mk
    from repro_torch.kernels.mamba_scan.ref import reference_mamba
    ins = _mamba_inputs(np.random.default_rng(ds), 2, 105, 200, ds, dtype,
                        card)
    got = _twice_same(lambda: mk.mamba_scan(*ins), mk.LAUNCHES,
                      "mamba_scan")
    _hold(got, reference_mamba(*ins), "scan")


@pytest.mark.parametrize("ds", [2, 5, 16, 64])
def test_mamba_kernel_follows_its_route(card, ds):
    """The kernel against ``ref.py:route_mamba``, its operations in its
    order in plain PyTorch, run on the card in the kernel's layout for
    that d_state: within 4 float32 ulps of y (4·eps·|y|), where the plain
    version is held to 3e-4.  On the card the route's ``torch.exp2`` is
    CUDA's ``exp2f``, the same ``ex2.approx`` the kernel issues, so a
    different reduction order, a lost FMA or another decay shows here."""
    from repro_torch.kernels.mamba_scan import kernel as mk
    from repro_torch.kernels.mamba_scan.ref import route_mamba
    ins = _mamba_inputs(np.random.default_rng(50 + ds), 2, 105, 200, ds,
                        torch.float32, card)
    lanes, spl = mk.layout(ds)
    got = mk.mamba_scan(*ins)
    want = route_mamba(*ins, lanes=lanes, spl=spl)
    err = (got - want).abs()
    limit = 4 * torch.finfo(torch.float32).eps * want.abs()
    assert (err <= limit).all(), (
        f"max |kernel - route| {err.max().item():.3g}, "
        f"{(err / want.abs().clamp_min(1e-30)).max().item() / 2 ** -23:.3g}"
        f" eps of |y| at most")


def test_mamba_kernel_jamba_row(card):
    """Jamba-v0.1's widths (d_inner 8192, d_state 16) over one 4096-token
    row, the default layout."""
    from repro_torch.kernels.mamba_scan import kernel as mk
    from repro_torch.kernels.mamba_scan.ref import reference_mamba
    ins = _mamba_inputs(np.random.default_rng(4096), 1, 4096, 8192, 16,
                        torch.float32, card)
    got = _twice_same(lambda: mk.mamba_scan(*ins), mk.LAUNCHES, "mamba_scan")
    _hold(got, reference_mamba(*ins), "scan")


def test_mamba_kernel_reads_views_off_alignment(card):
    """Inputs that start off 16 bytes take the plain-load ring: the same
    arithmetic, so the same bits as the cp.async ring."""
    from repro_torch.kernels.mamba_scan import kernel as mk
    ins = _mamba_inputs(np.random.default_rng(9), 1, 70, 64, 16,
                        torch.float32, card)
    flat = torch.empty(ins[0].numel() + 1, device=card)
    moved = flat[1:].view(ins[0].shape)
    moved.copy_(ins[0])
    assert moved.data_ptr() % 16
    assert torch.equal(mk.mamba_scan(moved, *ins[1:]), mk.mamba_scan(*ins))


def test_mamba_refuses(card):
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan
    ins = _mamba_inputs(np.random.default_rng(0), 1, 8, 16, 8, torch.float32,
                        card)
    with pytest.raises(TypeError):
        mamba_scan(*(z.double() for z in ins))
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros((1, 16, 8), device=card).transpose(1, 2)
        mamba_scan(x, *ins[1:])
    wide = _mamba_inputs(np.random.default_rng(0), 1, 8, 16, 65,
                         torch.float32, card)
    with pytest.raises(ValueError, match="d_state"):
        mamba_scan(*wide)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 100])
def test_mamba_kernel_state_form(card, t, dtype):
    """B5 from a given float32 state, its final state returned: one decode
    token and a prompt over several tiles (100 steps, tiles of at most 32),
    Jamba's d_state 16 on 200 channels, against ``reference_mamba(state=,
    return_state=True)``; twice, one launch each, bitwise."""
    from repro_torch.kernels.mamba_scan import kernel as mk
    from repro_torch.kernels.mamba_scan.ref import reference_mamba
    rng = np.random.default_rng(70 + t)
    ins = _mamba_inputs(rng, 2, t, 200, 16, dtype, card)
    h0 = _randn(rng, (2, 200, 16), torch.float32, card, 0.5)
    y, h = _twice_same(lambda: mk.mamba_scan(*ins, state=h0,
                                             return_state=True),
                       mk.LAUNCHES, "mamba_scan")
    want_y, want_h = reference_mamba(*ins, state=h0, return_state=True)
    _hold(y, want_y, "scan")
    _hold(h, want_h, "scan")
    # no state: the zero state, as before
    _, hz = mk.mamba_scan(*ins, return_state=True)
    _hold(hz, reference_mamba(*ins, return_state=True)[1], "scan")


def test_mamba_kernel_writes_the_state_in_place(card):
    """``out_state`` aliasing ``state``: the final state overwrites the
    initial one, bitwise what a separate output gets, y unchanged; a
    prompt's final state carried into one more token equals the scan of
    both at once (within the scan tolerance)."""
    from repro_torch.kernels.mamba_scan import kernel as mk
    rng = np.random.default_rng(80)
    ins = _mamba_inputs(rng, 2, 37, 130, 16, torch.float32, card)
    h0 = _randn(rng, (2, 130, 16), torch.float32, card, 0.5)
    y_sep, h_sep = mk.mamba_scan(*ins, state=h0, return_state=True)
    inout = h0.clone()
    y_in, h_in = mk.mamba_scan(*ins, state=inout, out_state=inout)
    torch.cuda.synchronize()
    assert h_in is inout
    assert torch.equal(h_in, h_sep) and torch.equal(y_in, y_sep)
    head = [z[:, :36].contiguous() if z.dim() == 3 and z.shape[1] == 37
            else z for z in ins]
    tail = [z[:, 36:].contiguous() if z.dim() == 3 and z.shape[1] == 37
            else z for z in ins]
    _, st = mk.mamba_scan(*head, state=h0, return_state=True)
    y1, _ = mk.mamba_scan(*tail, state=st, out_state=st)
    _hold(y1, y_sep[:, 36:], "scan")
    _hold(st, h_sep, "scan")


def test_mamba_kernel_in_a_cuda_graph(card):
    """B5's decode form (T = 1, the state written in place) captured in a
    CUDA graph and replayed 5 times: each replay bitwise the eager calls
    on the same inputs, the state carried replay to replay."""
    from repro_torch.core.cuda_graph import capture
    from repro_torch.kernels.mamba_scan import kernel as mk
    rng = np.random.default_rng(90)
    steps = [_mamba_inputs(rng, 2, 1, 256, 16, torch.float32, card)
             for _ in range(5)]
    h0 = _randn(rng, (2, 256, 16), torch.float32, card, 0.5)
    static = [z.clone() for z in steps[0]]
    state = h0.clone()

    def run():
        return mk.mamba_scan(*static, state=state, out_state=state)[0]

    graph, out = capture(card, run, run)
    state.copy_(h0)
    eager = h0.clone()
    for ins in steps:
        for dst, src in zip(static, ins):
            dst.copy_(src)
        graph.replay()
        want, _ = mk.mamba_scan(*ins, state=eager, out_state=eager)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(state, eager)


def _rwkv_inputs(rng, bh, t, n, dtype, dev):
    return (_randn(rng, (bh, t, n), dtype, dev),
            _randn(rng, (bh, t, n), dtype, dev, 0.3),
            _randn(rng, (bh, t, n), dtype, dev),
            (torch.sigmoid(_randn(rng, (bh, t, n), torch.float32, dev)) * 0.5
             + 0.45).to(dtype),
            _randn(rng, (n,), dtype, dev, 0.1))


@pytest.mark.parametrize("bh,t,n,chunk,dtype", [
    (2, 64, 32, 32, torch.float32),           # T a multiple of chunk
    (4, 128, 64, 32, torch.float32),
    (3, 20, 64, 64, torch.float32),           # T below chunk
    (2, 96, 64, 32, torch.bfloat16),
])
def test_rwkv6_kernel(card, bh, t, n, chunk, dtype):
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6
    from repro_torch.kernels.rwkv6_scan.ref import reference_rwkv6
    ins = _rwkv_inputs(np.random.default_rng(bh * t), bh, t, n, dtype, card)
    got = _twice_same(lambda: rwkv6(*ins, chunk), rk.LAUNCHES, "rwkv6_scan")
    _hold(got, reference_rwkv6(*ins), "scan")


def test_rwkv6_refuses(card):
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan
    ins = _rwkv_inputs(np.random.default_rng(0), 2, 64, 64, torch.float32,
                       card)
    with pytest.raises(AssertionError):
        rwkv6_scan(*(z[:, :40] if z.dim() == 3 else z for z in ins),
                   chunk=32)
    with pytest.raises(TypeError):
        rwkv6_scan(*(z.double() for z in ins))
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan(ins[0].transpose(1, 2).contiguous().transpose(1, 2),
                   *ins[1:])
    narrow = _rwkv_inputs(np.random.default_rng(0), 2, 8, 48, torch.float32,
                          card)
    with pytest.raises(ValueError, match="head size"):
        rwkv6_scan(*narrow)


# ---------------------------------------------------------------------------
# B7: the RWKV6 chunk algebra, and B6 carrying a state
# ---------------------------------------------------------------------------

def _rwkv_model_inputs(rng, bh, t, n, dtype, dev, heads):
    """r, k, v in ``dtype``; w, the per-head u and a state in float32, as
    the model hands them over."""
    r, k, v, _, _ = _rwkv_inputs(rng, bh, t, n, dtype, dev)
    w = torch.sigmoid(_randn(rng, (bh, t, n), torch.float32, dev)) * 0.5 \
        + 0.45
    u = _randn(rng, (heads, n), torch.float32, dev, 0.1)
    s0 = _randn(rng, (bh, n, n), torch.float32, dev, 0.5)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("t", [64, 100, 512])
def test_rwkv6_chunked_kernel(card, t, n, dtype, with_state):
    """B7 against its plain version (the same algebra: the scans' 3e-4,
    one bf16 ulp for bf16 outputs; the final state in float32 at 3e-4) and
    against the token loop (the reference's 2e-3); twice, bitwise."""
    from repro_torch.kernels.rwkv6_scan import kernel_chunked as kc
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_chunked
    from repro_torch.kernels.rwkv6_scan.ref import (reference_rwkv6,
                                                    reference_rwkv6_chunked)
    r, k, v, w, u, s0 = _rwkv_model_inputs(np.random.default_rng(t + n), 6,
                                           t, n, dtype, card, heads=3)
    s0 = s0 if with_state else None
    o, s = _twice_same(lambda: rwkv6_chunked(r, k, v, w, u, state=s0,
                                             return_state=True),
                       kc.LAUNCHES, "rwkv6_chunked")
    po, ps = reference_rwkv6_chunked(r, k, v, w, u, state=s0,
                                     return_state=True)
    _hold(o, po, "scan")
    _hold(s, ps, "scan")
    lo, ls = reference_rwkv6(r, k, v, w, u, state=s0, return_state=True)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(o.double(), lo.double(), rtol=2e-3 + rtol,
                               atol=2e-3)
    torch.testing.assert_close(s, ls, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("t", [1, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rwkv6_kernel_state_form(card, t, dtype):
    """B6 with a state in and out and a per-head bonus, as decode runs it
    (T = 1 over B·H rows), against its plain version."""
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6
    from repro_torch.kernels.rwkv6_scan.ref import reference_rwkv6
    r, k, v, w, u, s0 = _rwkv_model_inputs(np.random.default_rng(t), 160, t,
                                           64, dtype, card, heads=40)
    o, s = _twice_same(lambda: rwkv6(r, k, v, w, u, state=s0,
                                     return_state=True),
                       rk.LAUNCHES, "rwkv6_scan")
    po, ps = reference_rwkv6(r, k, v, w, u, state=s0, return_state=True)
    _hold(o, po, "scan")
    _hold(s, ps, "scan")


def test_rwkv_model_path_launches_b7_per_prefill_and_b6_per_decode(card):
    """The direct model's RWKV layers reach the kernels: one B7 launch per
    layer for a prompt, one B6 launch per layer for each decode token."""
    from repro_torch.configs import rwkv6_3b
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    from repro_torch.kernels.rwkv6_scan import kernel_chunked as kc
    from repro_torch.models import transformer as T
    cfg = rwkv6_3b.SMOKE.scaled(n_layers=3)
    params = T.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                           card)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 45))
    rk.LAUNCHES["rwkv6_scan"] = kc.LAUNCHES["rwkv6_chunked"] = 0
    logits, cache = T.serve_prefill(params, tokens, cfg, 64)
    assert kc.LAUNCHES["rwkv6_chunked"] == 3 and rk.LAUNCHES["rwkv6_scan"] == 0
    for step in range(2):
        logits, cache = T.serve_decode(params, cache, tokens[:, :1], cfg)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rwkv6_scan"] == 6
    assert kc.LAUNCHES["rwkv6_chunked"] == 3
    assert torch.isfinite(logits).all()


def test_rwkv6_chunked_refuses(card):
    from repro_torch.kernels.rwkv6_scan.kernel_chunked import rwkv6_chunked
    r, k, v, w, u, s0 = _rwkv_model_inputs(np.random.default_rng(0), 2, 64,
                                           64, torch.float32, card, heads=2)
    with pytest.raises(ValueError, match="head size"):
        rwkv6_chunked(*(z[..., :48].contiguous() for z in (r, k, v, w, u)))
    with pytest.raises(ValueError, match="span devices"):
        rwkv6_chunked(r, k, v, w.cpu(), u)
    with pytest.raises(ValueError, match="span devices"):
        rwkv6_chunked(r, k, v, w, u, state=s0.cpu())
    with pytest.raises(ValueError, match="chunk"):
        rwkv6_chunked(r, k, v, w, u, chunk=64)
    with pytest.raises(TypeError):
        rwkv6_chunked(r.double(), k.double(), v.double(), w, u)
    with pytest.raises(TypeError):
        rwkv6_chunked(r, k, v, w, u, state=s0.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shapes"):
        rwkv6_chunked(r, k, v, w, u[:, :32])
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_chunked(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                      w, u)


@pytest.mark.parametrize("op", ["rwkv6_scan", "rwkv6_chunked"])
def test_rwkv6_kernels_with_no_steps_pass_the_state_through(card, op):
    from repro_torch.kernels.rwkv6_scan import kernel, kernel_chunked
    fn = {"rwkv6_scan": kernel.rwkv6_scan,
          "rwkv6_chunked": kernel_chunked.rwkv6_chunked}[op]
    r, k, v, w, u, s0 = _rwkv_model_inputs(np.random.default_rng(1), 4, 0,
                                           64, torch.float32, card, heads=2)
    o, s = fn(r, k, v, w, u, state=s0, return_state=True)
    torch.cuda.synchronize()
    assert o.shape == (4, 0, 64) and torch.equal(s, s0)
    o, s = fn(r, k, v, w, u, return_state=True)
    assert torch.equal(s, torch.zeros_like(s0))


@pytest.mark.parametrize("bh,t,n,chunk,dtype", [
    (5, 1, 64, 32, torch.float32),            # one token, one short chunk
    (7, 45, 32, 7, torch.float32),            # chunk 7, ragged last chunk
    (3, 130, 64, 16, torch.bfloat16),         # chunk 16, BH odd
    (161, 96, 64, 32, torch.bfloat16),        # BH past the model's 160
])
def test_rwkv6_chunked_on_odd_shapes(card, bh, t, n, chunk, dtype):
    """B7 against its plain version and its route in plain PyTorch
    (``chunk_products``) on chunks shorter than 32, one token, and row
    counts that fill no wave of column tiles: the scans' 3e-4 plus one
    bf16 ulp for bf16 outputs, the final state at 3e-4; twice, bitwise."""
    from repro_torch.kernels.rwkv6_scan import kernel_chunked as kc
    from repro_torch.kernels.rwkv6_scan.ref import (chunk_products,
                                                    reference_rwkv6_chunked)
    r, k, v, w, u, s0 = _rwkv_model_inputs(np.random.default_rng(bh + t), bh,
                                           t, n, dtype, card,
                                           heads=1 if bh % 2 else bh)
    o, s = _twice_same(lambda: kc.rwkv6_chunked(r, k, v, w, u, chunk=chunk,
                                                state=s0, return_state=True),
                       kc.LAUNCHES, "rwkv6_chunked")
    for plain in (reference_rwkv6_chunked, chunk_products):
        po, ps = plain(r, k, v, w, u, chunk=chunk, state=s0,
                       return_state=True)
        _hold(o, po, "scan")
        _hold(s, ps, "scan")


@pytest.mark.parametrize("bh,t,n,dtype", [
    (160, 1, 64, torch.bfloat16),             # a decode step's layer
    (5, 1, 64, torch.float32),                # BH not a multiple of 8
    (7, 1, 32, torch.float32),                # the step form at N 32
    (3, 4, 64, torch.bfloat16),               # the long form, in place
])
def test_rwkv6_short_form_in_place_and_not(card, bh, t, n, dtype):
    """B6's decode form (T = 1: 8 threads a state column, N / 16 blocks a
    row) and, at T = 4, its long form, against the plain version, with the
    final state in a new tensor and in place over the initial one
    (``out_state=state``, as the decode graph writes it)."""
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    from repro_torch.kernels.rwkv6_scan.ref import reference_rwkv6
    r, k, v, w, u, s0 = _rwkv_model_inputs(np.random.default_rng(bh * t), bh,
                                           t, n, dtype, card, heads=1)
    po, ps = reference_rwkv6(r, k, v, w, u, state=s0, return_state=True)
    o, s = _twice_same(lambda: rk.rwkv6_scan(r, k, v, w, u, state=s0,
                                             return_state=True),
                       rk.LAUNCHES, "rwkv6_scan")
    _hold(o, po, "scan")
    _hold(s, ps, "scan")
    inplace = s0.clone()
    o2, s2 = rk.rwkv6_scan(r, k, v, w, u, state=inplace, out_state=inplace)
    torch.cuda.synchronize()
    assert s2.data_ptr() == inplace.data_ptr()
    assert torch.equal(o2, o) and torch.equal(s2, s)


def _with_gains(tree, gen):
    """Every norm gain ``g`` drawn around 1 (the zero init would zero every
    activation of a plain-``g`` config, and every greedy token with it)."""
    for key, v in tree.items():
        if isinstance(v, dict):
            _with_gains(v, gen)
        elif key == "g":
            v.copy_(1.0 + 0.1 * torch.randn(v.shape, generator=gen,
                                            device=v.device))


def _serve_graph_model(card, arch):
    """The ``rwkv6-3b`` SMOKE config, or a dense one the direct model runs
    (float32 attention + MLP, ``norm_plus_one``, two heads of 32: its
    prefill attention is kernel B3, its decode attention the
    decode-attention kernel; ``dense_gqa_bf16`` the same in bfloat16 with
    4 query heads of 64 on 2 KV heads), with random weights."""
    from repro_torch.configs import rwkv6_3b
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    if arch == "rwkv6-3b":
        cfg = rwkv6_3b.SMOKE
    elif arch == "dense_gqa_bf16":
        cfg = ModelConfig(name="dense_gqa", family="dense", n_layers=2,
                          d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
                          d_ff=128, vocab_size=97, dtype="bfloat16",
                          param_dtype="float32", norm_plus_one=True,
                          tie_embeddings=False)
    else:
        cfg = ModelConfig(name="dense_tiny", family="dense", n_layers=2,
                          d_model=64, n_heads=2, n_kv_heads=2, d_ff=64,
                          vocab_size=97, dtype="float32",
                          param_dtype="float32", norm_plus_one=True,
                          tie_embeddings=False)
    gen = torch.Generator(device=card).manual_seed(0)
    params = T.init_params(cfg, gen, card)
    _with_gains(params, gen)
    return cfg, params


@pytest.mark.parametrize("arch", ["rwkv6-3b", "dense", "dense_gqa_bf16"])
def test_decode_graph_replays_are_eager_decoding(card, arch):
    """``serve.DecodeStep`` on the card captures ``serve_decode`` (caches
    updated in place) and the greedy pick once and replays them: logits,
    tokens and caches bitwise equal to the same steps run eagerly, step
    after step, while the write index advances.  B6's wrapper (RWKV6) or
    the decode-attention kernel's (the dense models) runs for the warm-up
    and the capture only, a layer's launch each, and the replays do not
    pass through it; the graph's attention layers write their keys and
    values into the static caches, which never move."""
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg, params = _serve_graph_model(card, arch)
    sp = T.serving_params(params, cfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 21))
    graph, eager = serve.DecodeStep(sp, cfg), serve.DecodeStep(
        sp, cfg, graph=False)
    assert graph.graph and not eager.graph
    logits, gc = T.serve_prefill(sp, tokens, cfg, 32)
    ec = gc
    gt = et = serve._greedy(logits)
    counted = {"rwkv6_scan": 0, "decode_attention": 0}
    ptrs = None
    for _ in range(5):
        before = {"rwkv6_scan": rk.LAUNCHES["rwkv6_scan"],
                  "decode_attention": da.LAUNCHES["decode_attention"]}
        gl, gt, gc = graph(gc, gt)
        for key, n in before.items():
            counted[key] += {**rk.LAUNCHES, **da.LAUNCHES}[key] - n
        if ptrs is None:
            ptrs = [z.data_ptr() for z in serve._leaves(gc)]
        assert [z.data_ptr() for z in serve._leaves(gc)] == ptrs
        el, et, ec = eager(ec, et)
        assert torch.equal(gl, el) and torch.equal(gt, et)
        for a, b in zip(serve._leaves(gc), serve._leaves(ec)):
            assert torch.equal(a, b)
    assert graph.captures == 1 and graph.replays == 5
    rwkv = arch == "rwkv6-3b"
    assert counted == {"rwkv6_scan": 2 * cfg.n_layers if rwkv else 0,
                       "decode_attention": 0 if rwkv else 2 * cfg.n_layers}


def test_a_decode_capture_that_fails_raises(card, monkeypatch):
    """A step that reads the card on the host cannot be captured: the step
    raises and never decodes eagerly instead."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg, params = _serve_graph_model(card, "rwkv6-3b")
    sp = T.serving_params(params, cfg)
    real = serve.serve_decode

    def reads_the_host(*args, **kw):
        logits, caches = real(*args, **kw)
        float(logits.sum())                       # a host read
        return logits, caches

    monkeypatch.setattr(serve, "serve_decode", reads_the_host)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9))
    logits, cache = T.serve_prefill(sp, tokens, cfg, 16)
    step = serve.DecodeStep(sp, cfg)
    with pytest.raises(RuntimeError):
        step(cache, serve._greedy(logits))
    assert step.replays == 0


def test_decode_graph_device_spans_and_counters(card):
    """A decode graph captured with the tracer on (OLMoE-1B-7B's widths at
    2 layers, a batch of 32): its device spans (``model.embed``, the
    layers, ``model.head``, ``model.pick``) add up to 95-101% of the
    step's CUDA-event time; its logits are bitwise the uninstrumented
    graph's; its counters after one replay are the eager step's."""
    from repro_torch.configs import get_config
    from repro_torch.core.obs import trace
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = get_config("olmoe-1b-7b").scaled(n_layers=2)
    gen = torch.Generator(device=card).manual_seed(0)
    sp = T.serving_params(T.init_params(cfg, gen, card), cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (32, 256))
    logits, caches = T.serve_prefill(sp, tokens, cfg, 264)
    tok = serve._greedy(logits)
    # the second step of each graph is timed: the first loads the caches
    plain = serve.DecodeStep(sp, cfg)
    _, t1, c1 = plain(serve._clone(caches), tok)
    want = plain(c1, t1)[0].clone()
    tracer = trace.enable()
    try:
        graph = serve.DecodeStep(sp, cfg)
        eager = serve.DecodeStep(sp, cfg, graph=False)
        _, t1, c1 = graph(serve._clone(caches), tok)      # the capture
        state = serve._clone(c1)
        graph.record.reset()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        got, _, _ = graph(c1, t1)
        b.record()
        torch.cuda.synchronize()
        counted = graph.record.counters()
        eager(state, t1)
        torch.cuda.synchronize()
        by_eager = eager.record.counters()
    finally:
        trace.disable()
    same = torch.equal(got, want)
    spans = graph.record.spans()
    step_ms = a.elapsed_time(b)
    # the graphs' pools, the weights and the caches go before the asserts:
    # later card tests in the process need the memory
    del plain, graph, eager, sp, logits, caches, c1, state, got, want
    gc.collect()
    torch.cuda.empty_cache()
    assert same
    names = sorted(n for n, _, _, _ in spans)
    assert names == sorted(["model.embed", "model.head", "model.pick"]
                           + ["layer.attn", "layer.moe"] * 2)
    share = sum(ms for _, _, _, ms in spans) / step_ms
    assert 0.95 <= share <= 1.01, share
    assert counted == by_eager
    assert counted["moe.slots"] == 2 * 32 * cfg.moe.n_experts
    # each attention layer's one launch of the decode-attention kernel, at
    # the split count of its shapes
    from repro_torch.kernels.decode_attention import kernel as da
    splits = da.split_count(32, cfg.n_kv_heads, 1, 264, cfg.hd, 2,
                            da._sm_count(card))
    assert counted["attention.decode_kernel_calls"] == 2
    assert counted["attention.decode_splits"] == 2 * splits
    assert counted["moe.pairs_kept"] == 2 * 32 * cfg.moe.top_k
    assert tracer.counters["serve.cache_load_bytes"] > 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "dense"])
def test_prefill_graph_replays_are_eager_prefills(card, arch):
    """``serve.PrefillStep`` on the card captures ``serve_prefill`` and the
    greedy pick once per prompt shape and replays them: two batches through
    one capture, each bitwise equal to the eager prefill in logits, token
    and caches.  B7's wrapper runs for the warm-up and the capture only."""
    from repro_torch.kernels.rwkv6_scan import kernel_chunked as ck
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg, params = _serve_graph_model(card, arch)
    sp = T.serving_params(params, cfg)
    step = serve.PrefillStep(sp, cfg)
    assert step.graph
    rng = np.random.default_rng(3)
    before = ck.LAUNCHES["rwkv6_chunked"]
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
        logits, tok, caches = step(toks, 48)
        want_l, want_c = T.serve_prefill(sp, toks, cfg, 48)
        assert torch.equal(logits, want_l)
        assert torch.equal(tok, serve._greedy(want_l))
        for a, b in zip(serve._leaves(caches), serve._leaves(want_c)):
            assert torch.equal(a, b)
    assert step.captures == 1 and step.replays == 2
    # the warm-up, the capture and the two eager prefills, a layer each
    want = 4 * cfg.n_layers if arch == "rwkv6-3b" else 0
    assert ck.LAUNCHES["rwkv6_chunked"] - before == want


def test_a_prefill_capture_that_fails_raises(card, monkeypatch):
    """A prefill that reads the card on the host cannot be captured: the
    step raises and never prefills eagerly instead."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg, params = _serve_graph_model(card, "rwkv6-3b")
    sp = T.serving_params(params, cfg)
    real = serve.serve_prefill

    def reads_the_host(*args, **kw):
        logits, caches = real(*args, **kw)
        float(logits.sum())                       # a host read
        return logits, caches

    monkeypatch.setattr(serve, "serve_prefill", reads_the_host)
    step = serve.PrefillStep(sp, cfg)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9))
    with pytest.raises(RuntimeError):
        step(tokens, 16)
    assert step.replays == 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "dense"])
def test_served_graphs_hand_over_between_batches(card, arch):
    """``serve_requests`` on the card, three batches through one prefill
    capture and one decode capture: each batch's prefill replay overwrites
    the static caches the last batch's first decode step copied from, and
    the tokens are those of eager serving (``graph=False``)."""
    from repro_torch.launch import serve
    cfg, params = _serve_graph_model(card, arch)
    prompts = serve.draw_prompts(5, 6, 24, cfg.vocab_size)
    kw = dict(batch=2, max_prompt=24, new_tokens=4)
    tokens, times = serve.serve_requests(cfg, params, prompts, **kw)
    eager, _ = serve.serve_requests(cfg, params, prompts, graph=False, **kw)
    for a, b in zip(tokens, eager):
        np.testing.assert_array_equal(a, b)
    pre, step = times[-1]["prefill"], times[-1]["step"]
    assert pre.captures == 1 and pre.replays == 3
    assert step.captures == 1 and step.replays == 3 * 3


def test_rwkv6_chunked_reads_views_off_16_byte_alignment(card):
    """B7 loads r, k, v and w 16 bytes at a time; a contiguous view that
    starts off that alignment is copied first, with the same result."""
    from repro_torch.kernels.rwkv6_scan.kernel_chunked import rwkv6_chunked
    from repro_torch.kernels.rwkv6_scan.ref import reference_rwkv6_chunked
    r, k, v, w, u, s0 = _rwkv_model_inputs(np.random.default_rng(3), 2, 40,
                                           32, torch.bfloat16, card, heads=2)

    def shifted(z):
        flat = torch.empty(z.numel() + 1, dtype=z.dtype, device=card)
        out = flat[1:].view(z.shape)
        out.copy_(z)
        return out

    moved = [shifted(z) for z in (r, k, v, w)]
    assert all(z.data_ptr() % 16 for z in moved)
    got = rwkv6_chunked(*moved, u, state=s0, return_state=True)
    want = rwkv6_chunked(r, k, v, w, u, state=s0, return_state=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    po, ps = reference_rwkv6_chunked(r, k, v, w, u, state=s0,
                                     return_state=True)
    _hold(got[0], po, "scan")
    _hold(got[1], ps, "scan")


# ---------------------------------------------------------------------------
# Cross-flush loop fusion: a drain replays one captured CUDA graph
# ---------------------------------------------------------------------------

def _chain(iters, draw=False, **rt_kw):
    """x <- x * 1.01 + 0.5 (+ a quantized draw) with a flush per step, on
    the card; returns the final x and the runtime's stats."""
    from repro_torch.core import lazy as bh
    with bh.fresh_runtime(**rt_kw) as rt:
        x = bh.full((64, 1000), 1.0)
        bh.flush()
        for _ in range(iters):
            y = x * 1.01 + 0.5
            if draw:
                r = bh.floor(bh.random((64, 1000)) * 8.0)
                z = y + r
                r.delete()
                y.delete()
                y = z
            x.delete()
            x = y
            bh.flush()
        out = x.numpy()
        st = rt.executor.stats.snapshot()
        x._alive = False
    return out, st, rt


@pytest.mark.parametrize("backend", ["triton", "torch"])
@pytest.mark.parametrize("iters", [2 + 4, 2 + 4 + 4 + 3])
def test_loop_graph_drains_are_per_flush(cuda, backend, iters):
    """Full drains (4 iterations) and a tail drain replay the captured
    iteration and give the per-flush bits."""
    ref, *_ = _chain(iters, backend=backend, loop_fusion=False)
    got, st, _ = _chain(iters, backend=backend, loop_threshold=2,
                        loop_unroll=4)
    assert got.tobytes() == ref.tobytes()
    assert st["loop_captures"] == 1
    assert st["loop_replays"] == st["loop_iterations"] == iters - 2


@pytest.mark.parametrize("backend", ["triton", "torch"])
def test_loop_graph_draws_fresh_numbers_each_iteration(cuda, backend):
    """A random-bearing body: each replay reads its iteration's key words
    from the key table, so the iterations of one drain and of two drains
    draw different numbers — the per-flush ones (every per-flush step
    draws under its own salt, so a frozen key would not match)."""
    from repro_torch.core.backends.loop_body import LoopBody
    ref, *_ = _chain(2 + 4 + 4, draw=True, backend=backend,
                     loop_fusion=False)
    got, st, rt = _chain(2 + 4 + 4, draw=True, backend=backend,
                         loop_threshold=2, loop_unroll=4)
    assert st["loop_flushes"] == 2 and st["loop_replays"] == 8
    assert got.tobytes() == ref.tobytes()
    body, = [b for b in rt.executor._cache.values()
             if isinstance(b, LoopBody)]
    rows = body.keys.table.view(torch.int32).cpu().numpy().reshape(4, -1)
    assert len({r.tobytes() for r in rows}) == 4


def test_loop_capture_that_fails_raises(cuda, monkeypatch):
    """A loop body that reads the card on the host cannot be captured: the
    drain raises and never runs the iterations eagerly instead."""
    from repro_torch.core.backends import loop_body
    real = loop_body.LoopBody._step

    def reads_the_host(self, slots):
        n = real(self, slots)
        float(slots[0].sum())                     # a host read
        return n

    monkeypatch.setattr(loop_body.LoopBody, "_step", reads_the_host)
    with pytest.raises(RuntimeError):
        _chain(2 + 4, backend="triton", loop_threshold=2, loop_unroll=4)


def test_loop_sync_snapshot_is_copied_not_overwritten(cuda):
    """A SYNC snapshot holding a state buffer (the mid-loop ``.numpy()``
    right after a drain) keeps its values through the next drain."""
    from repro_torch.core import lazy as bh
    with bh.fresh_runtime(backend="triton", loop_threshold=2,
                          loop_unroll=4) as rt:
        x = bh.full(4096, 1.0)
        bh.flush()
        for i in range(12):
            y = x * 1.01 + 0.5
            x.delete()
            x = y
            bh.flush()
            if i == 5:
                seen = x.numpy()
                uid = x.view.base.uid
        x.numpy()
        snap = rt.executor.sync_store[uid].cpu().numpy()
        x._alive = False
    assert snap.tobytes() == seen.tobytes()


def test_loop_warm_up_leaves_the_state_alone(cuda):
    """The capture's eager warm-up runs on scratch copies of the state:
    after the first drain (warm-up, capture, replays) the state is the
    per-flush state, not one iteration further."""
    ref, *_ = _chain(2 + 1, backend="triton", loop_fusion=False)
    got, st, _ = _chain(2 + 1, backend="triton", loop_threshold=2,
                        loop_unroll=4)
    assert (st["loop_captures"], st["loop_replays"]) == (1, 1)
    assert got.tobytes() == ref.tobytes()


# ---------------------------------------------------------------------------
# Calibration, the ILP partitioner and explain on the card
# ---------------------------------------------------------------------------

def test_profiler_on_the_card_records_warm_samples_above_kernel_time(
        cuda, monkeypatch):
    """Only warm dispatches are recorded, and each triton sample's wall
    (a synchronize to a synchronize) is at least its kernel's time by
    CUDA events recorded around the wrapper call inside it."""
    from repro_torch.core import lazy as bh
    from repro_torch.core.tuning import Profiler
    events, pairs = [], []
    call = codegen.FusedBlockKernel.__call__

    def timed(kernel, *args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = call(kernel, *args, **kw)
        b.record()
        events.append((a, b))
        return out

    class Spy(Profiler):
        def record(self, backend, ops, plan, ctx, wall_s):
            super().record(backend, ops, plan, ctx, wall_s)
            if backend == "triton":
                a, b = events[-1]
                pairs.append((wall_s, a.elapsed_time(b) / 1e3))

    monkeypatch.setattr(codegen.FusedBlockKernel, "__call__", timed)
    p = Spy()
    with bh.fresh_runtime(backend="triton", profiler=p) as rt:
        x = bh.asarray(np.linspace(0.0, 1.0, 2 ** 20))
        for _ in range(4):
            y = bh.sin(x) * 0.5 + x * 0.25
            float((y * y).sum().numpy())
        misses = rt.executor.stats["exec_cache_misses"]
        dispatched = rt.executor.stats["blocks_run"]
    assert len(p) == dispatched - misses > 0
    assert pairs and all(wall >= kernel > 0 for wall, kernel in pairs)
    assert all(s.backend == "triton" for s in p.profile.samples)


def test_calibrate_on_the_card_fits_both_backends(cuda, tmp_path):
    """A fit for each backend from warm samples on the card, each launch
    price positive (the fit clamps an intercept that least squares drives
    to or below zero at ``MIN_LAUNCH_S``, as the reference's does: on the
    card the large blocks' walls dominate the unweighted fit, PERF.md),
    and the saved profile refits to the same prices."""
    from repro_torch.core import tuning
    from repro_torch.core.tuning.calibrate import MIN_LAUNCH_S
    try:
        fit = tuning.calibrate(seeds=range(2), sizes=(2 ** 10, 2 ** 16),
                               save=str(tmp_path / "p.json"))
        assert set(fit.launch_s) == {"torch", "triton"}
        assert all(v >= MIN_LAUNCH_S > 0 for v in fit.launch_s.values()), fit
        assert fit.n_samples >= fit.n_keys > 0
        assert all(s.wall_s > 0 for s in
                   tuning.Profile.load(str(tmp_path / "p.json")).samples)
        again = tuning.load_and_install(str(tmp_path / "p.json"))
        assert (again.launch_s, again.hbm_slope_s) == (fit.launch_s,
                                                       fit.hbm_slope_s)
    finally:
        tuning.clear_fit()


@pytest.mark.parametrize("seed", (17, 3))
def test_ilp_planned_exact_program_bitwise_to_greedy(cuda, seed):
    from repro_torch.testing.tapegen import TapeProgram
    prog = TapeProgram(seed, n_actions=20, size=4096, exact=True)
    greedy = prog.run(backend="triton", cost_model="gpu")
    ilp = prog.run(backend="triton", cost_model="gpu",
                   partition_backend="ilp", time_budget_s=1.0)
    assert len(ilp) == len(greedy)
    for a, b in zip(ilp, greedy):
        assert a.tobytes() == b.tobytes()


def test_explain_cli_json_on_the_card_names_triton_winners(cuda):
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "tools" /
                                              "explain_torch.py"), "--json"],
                         capture_output=True, text=True, timeout=600,
                         cwd=root)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert doc["schema"] == "repro_explain_v1"
    winners = {b["backend"] for b in doc["blocks"] if b["backend"]}
    assert "triton" in winners
    assert any(m["action"] == "rejected" and m["saving"] > 0
               for m in doc["merges"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_repeats_are_bitwise(card, dtype):
    """ROADMAP C21's standing check: B3's Qwen1.5-4B case (B 4, Hq 20, S
    512, D 128, causal) and, in bfloat16, its split-P form, 50 runs on the
    same inputs: every output equals the first bit for bit and stays
    within the plain version's tolerance."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import reference_attention
    rng = np.random.default_rng(21)
    q, k, v = (_randn(rng, (4, 20, 512, 128), dtype, card) for _ in range(3))
    want = reference_attention(q, k, v, causal=True)
    first = attention(q, k, v, True)
    _hold(first, want, "attention")
    for _ in range(49):
        assert torch.equal(attention(q, k, v, True), first)


def _serve_requests(size, n_tenants=4, rounds=2):
    rng = np.random.default_rng(20)
    datas = [np.floor(rng.random(size) * 16.0) for _ in range(n_tenants)]

    def request(data, with_random):
        def fn():
            from repro_torch.core import lazy as bh
            a = bh.asarray(data)
            b = bh.floor((a * 2.0 + 3.0) % 1021.0)
            c = bh.maximum(b, a) + b.sum().broadcast_to(a.shape)
            if with_random:
                c = c + bh.floor(bh.random(a.shape) * 8.0)
            return c
        return fn

    return [[request(datas[t], r % 2 == 1) for r in range(rounds)]
            for t in range(n_tenants)]


def _serve_concurrently(srv, load):
    import threading
    n = len(load)
    out, errors = {}, []
    barrier = threading.Barrier(n)

    def tenant(t):
        try:
            for r, fn in enumerate(load[t]):
                barrier.wait(120)
                out[(t, r)] = srv.submit(t, fn)
        except BaseException as e:      # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=tenant, args=(t,), daemon=True)
               for t in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    return out


@pytest.mark.parametrize("backend", ["torch", "triton"])
def test_server_on_the_card_is_bitwise_serial(cuda, backend):
    """The multi-tenant server on the card at 2**20 elements a request, 4
    tenants x 2 rounds with a barrier each (``random`` in the second):
    bitwise to a batching-off server driven serially.  On the floor the
    rounds batch; under ``backend="triton"`` B1 claims the blocks, so
    every request runs solo and launches it."""
    from repro_torch.core.serve import Server
    load = _serve_requests(2 ** 20)
    ref = Server(batching=False, backend=backend)
    refs = {(t, r): ref.submit(t, load[t][r]) for r in range(2)
            for t in range(len(load))}
    srv = Server(window_s=0.5, max_batch=4, backend=backend)
    before = codegen.LAUNCHES["fused_block"]
    got = _serve_concurrently(srv, load)
    launched = codegen.LAUNCHES["fused_block"] - before
    for key in refs:
        assert refs[key].tobytes() == got[key].tobytes(), key
    batches = srv.metrics.counter("serve.batches").get()
    if backend == "torch":
        assert batches == 2 and launched == 0
        assert srv.metrics.counter("serve.batched_requests").get() == 8
    else:
        assert batches == 0 and launched >= 8
        assert srv.metrics.counter("serve.singles").get() == 8


def test_plan_store_warm_start_on_the_card(cuda, tmp_path):
    """A cold server over an empty store writes its plans; a fresh one
    over the same directory hits, plans no partition, and gives the same
    bits."""
    from repro_torch.core.obs import trace
    from repro_torch.core.serve import Server
    load = _serve_requests(2 ** 16, n_tenants=2)
    cold = Server(store=str(tmp_path), batching=False, backend="triton")
    want = [cold.submit(t, fn) for t, fns in enumerate(load) for fn in fns]
    assert cold.metrics.counter("cache.plan_store.write").get() >= 1
    warm = Server(store=str(tmp_path), batching=False, backend="triton")
    tr = trace.enable()
    try:
        got = [warm.submit(t, fn) for t, fns in enumerate(load)
               for fn in fns]
    finally:
        trace.disable()
    assert warm.metrics.counter("cache.plan_store.hit").get() >= 1
    assert not any(e["name"] == "stage.partition" for e in tr.events)
    for a, b in zip(want, got):
        assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the attention families on the card: every multi-token attention and every
# cross-attention through B3
# ---------------------------------------------------------------------------

def _family_cfg(arch, **kw):
    """``arch``'s SMOKE config in float32 with head dims B3 is built for."""
    from repro_torch.configs import get_config
    return get_config(arch, smoke=True).scaled(dtype="float32", **kw)


def _family_params(cfg, card, seed=0):
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=card).manual_seed(seed)
    params = T.init_params(cfg, gen, card)
    for key, v in _named_leaves(params):
        if key in ("bq", "bk", "bv", "q_norm", "k_norm") or (
                key == "g" and not cfg.norm_plus_one):
            base = 1.0 if key == "g" else 0.0
            v.copy_(base + 0.1 * torch.randn(v.shape, generator=gen,
                                             device=card))
    return params


def _named_leaves(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v)
        else:
            yield k, v


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


#: the card's model (B3 in 3xTF32) against the same weights on the CPU
#: (the reference's dense attention in float32): 1e-4 of the largest
#: logit, as the CPU tests hold the port to the JAX package
FAMILY_F32 = 1e-4


def _rel_close(got, want, tol=FAMILY_F32):
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = float((got - want).abs().max()) / max(1e-6,
                                                float(want.abs().max()))
    assert err <= tol, (err, tol)


def test_gemma2_ring_decode_past_the_window_on_the_card(card):
    """Gemma2 at 2 layers (one local, window 8; one global), 4 heads of
    256: a 20-token prompt (its ring rolled) and 12 decode steps past the
    window, as graph replays bitwise to eager steps, each step's logits and
    the final caches within ``FAMILY_F32`` of the same model on the CPU;
    B3 once a layer for the prompt and never for a decode step."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = _family_cfg("gemma2-9b", head_dim=256)
    sp = T.serving_params(_family_params(cfg, card), cfg)
    cpu = _to_cpu(sp)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20))
    before = fa.LAUNCHES["flash_attention"]
    logits, gc = T.serve_prefill(sp, toks, cfg, 40)
    assert fa.LAUNCHES["flash_attention"] - before == cfg.n_layers
    assert gc["l0"]["k"].shape[2] == cfg.sliding_window      # the ring
    want_l, cc = T.serve_prefill(cpu, toks, cfg, 40)
    _rel_close(logits, want_l)
    graph, eager = serve.DecodeStep(sp, cfg), serve.DecodeStep(
        sp, cfg, graph=False)
    ec = gc
    gt = et = ct = serve._greedy(logits)
    before = fa.LAUNCHES["flash_attention"]
    for _ in range(12):
        gl, gt, gc = graph(gc, gt)
        el, et, ec = eager(ec, et)
        assert torch.equal(gl, el) and torch.equal(gt, et)
        for a, b in zip(serve._leaves(gc), serve._leaves(ec)):
            assert torch.equal(a, b)
        cl, cc = T.serve_decode(cpu, cc, ct.cpu(), cfg)
        ct = gt.cpu()
        _rel_close(gl, cl)
    assert fa.LAUNCHES["flash_attention"] == before
    for a, b in zip(serve._leaves(gc), serve._leaves(cc)):
        if a.dtype == torch.int32:
            assert torch.equal(a.cpu(), b)
        else:
            _rel_close(a, b)


def test_whisper_cross_attention_runs_b3(card):
    """Whisper's decoder cross-attends to 24 encoder frames through B3
    (non-causal, ``sq != sk``): the recorded call against B3's plain
    version, and the layer against the same layer on the CPU."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.models import layers as L
    cfg = _family_cfg("whisper-tiny", encoder_seq=24)      # 2 heads of 32
    p = {k: v[0] for k, v in _family_params(cfg, card)["groups"]["l0"][
        "cross"].items()}
    rng = np.random.default_rng(1)
    x = _randn(rng, (2, 9, cfg.d_model), torch.float32, card)
    enc = _randn(rng, (2, 24, cfg.d_model), torch.float32, card)
    seen = []
    real = ops.attention

    def spy(*args):
        seen.append((args, real(*args)))
        return seen[-1][1]

    ops.attention = spy
    try:
        before = fa.LAUNCHES["flash_attention"]
        got, cache = L.attention(p, x, cfg, kv_src=enc, causal=False)
        assert fa.LAUNCHES["flash_attention"] == before + 1 and cache is None
    finally:
        ops.attention = real
    (q, k, v, causal, window, softcap, scale), out = seen[0]
    assert not causal and window is None and softcap is None
    assert q.shape == (2, 2, 9, 32) and k.shape == v.shape == (2, 2, 24, 32)
    _hold(out, reference_attention(q, k, v, causal=False, scale=scale),
          "attention")
    want, _ = L.attention({k_: t.cpu() for k_, t in p.items()}, x.cpu(), cfg,
                          kv_src=enc.cpu(), causal=False)
    _rel_close(got, want)


_CARD_FEATURES = {
    "bias": dict(qkv_bias=True),
    "qk_norm": dict(qk_norm=True),
    "gqa": dict(n_kv_heads=1),
    "softcap": dict(attn_softcap=2.0),
    "window": dict(sliding_window=8),
    "cross": dict(),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("feature", list(_CARD_FEATURES))
def test_attention_feature_runs_b3(card, feature, dtype):
    """Each attention feature on the card, 4 heads of 32 over a 40-token
    prompt: one B3 launch, its call against B3's plain version (the
    kernel's own tolerance), and the layer's output against the same layer
    on the CPU (float32: ``FAMILY_F32``)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.models import layers as L
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="attn_card", family="dense", n_layers=1,
                      d_model=64, n_heads=4, head_dim=32, d_ff=64,
                      vocab_size=32, dtype=dtype,
                      **{"n_kv_heads": 2, **_CARD_FEATURES[feature]})
    gen = torch.Generator(device=card).manual_seed(2)
    p = L.init_attention(gen, cfg, card)
    for key in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if key in p:
            p[key] = 0.1 * torch.randn(p[key].shape, generator=gen,
                                       device=card)
    rng = np.random.default_rng(3)
    x = _randn(rng, (2, 40, 64), cfg.compute_dtype, card)
    kv = _randn(rng, (2, 17, 64), cfg.compute_dtype, card) \
        if feature == "cross" else None
    seen = []
    real = ops.attention

    def spy(*args):
        seen.append((args, real(*args)))
        return seen[-1][1]

    ops.attention = spy
    try:
        before = fa.LAUNCHES["flash_attention"]
        got, _ = L.attention(p, x, cfg, local=feature == "window",
                             kv_src=kv, causal=True)
        assert fa.LAUNCHES["flash_attention"] == before + 1
    finally:
        ops.attention = real
    (q, k, v, causal, window, softcap, scale), out = seen[0]
    assert causal == (feature != "cross")
    assert window == (8 if feature == "window" else None)
    assert softcap == cfg.attn_softcap
    _hold(out, reference_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale),
          "attention")
    if dtype == "float32":
        want, _ = L.attention({k_: t.cpu() for k_, t in p.items()}, x.cpu(),
                              cfg, local=feature == "window",
                              kv_src=None if kv is None else kv.cpu(),
                              causal=True)
        _rel_close(got, want)


def test_families_serve_on_the_card(card):
    """``serve_requests`` on the card for Whisper (frames encoded once, the
    decode graph cross-attending through B3) and LLaVA (patches before the
    prompt): the tokens of eager serving, and of the same weights served
    on the CPU."""
    from repro_torch.launch import serve
    for arch, kw in (("whisper-tiny", dict(encoder_seq=24)),
                     ("llava-next-mistral-7b", dict(head_dim=32))):
        cfg = _family_cfg(arch, **kw)
        params = _family_params(cfg, card)
        prompts = serve.draw_prompts(6, 4, 24, cfg.vocab_size)
        rng = np.random.default_rng(7)
        extra = {}
        if cfg.family == "encdec":
            extra["frames"] = rng.standard_normal(
                (4, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        else:
            extra["patch_embeds"] = rng.standard_normal(
                (4, cfg.n_patches, cfg.d_model)).astype(np.float32)
        opts = dict(batch=2, max_prompt=24, new_tokens=5, **extra)
        tokens, times = serve.serve_requests(cfg, params, prompts, **opts)
        eager, _ = serve.serve_requests(cfg, params, prompts, graph=False,
                                        **opts)
        cpu, _ = serve.serve_requests(cfg, _to_cpu(params), prompts, **opts)
        for a, b, c in zip(tokens, eager, cpu):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert times[-1]["prefill"].captures == 1
        assert times[-1]["step"].replays == 2 * 4


def test_jamba_serves_on_the_card(card):
    """Jamba-v0.1's SMOKE config (8 layers: 7 Mamba, attention at 4, MoE on
    the odd layers; heads of 32 for B3) served on the card: the prefill
    and decode graphs give the tokens of eager serving and of the same
    weights served on the CPU (float32); one capture of each step serves
    both batches, so the wrappers count B5 once a Mamba layer in the
    prefill's warm-up and capture and the decode step's, and B3 once in
    each prefill run (decode attends without it); the decode graph writes
    every Mamba layer's ssm state into its static cache."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.mamba_scan import kernel as mk
    from repro_torch.launch import serve
    cfg = _family_cfg("jamba-v0.1-52b", head_dim=32)
    params = _family_params(cfg, card)
    prompts = serve.draw_prompts(11, 4, 24, cfg.vocab_size)
    opts = dict(batch=2, max_prompt=24, new_tokens=5)
    mk.LAUNCHES["mamba_scan"] = fa.LAUNCHES["flash_attention"] = 0
    tokens, times = serve.serve_requests(cfg, params, prompts, **opts)
    torch.cuda.synchronize()
    n_mamba = sum(m == "mamba" for m, _ in cfg.layer_pattern())
    assert n_mamba == 7
    assert mk.LAUNCHES["mamba_scan"] == 2 * n_mamba + 2 * n_mamba
    assert fa.LAUNCHES["flash_attention"] == 2
    eager, _ = serve.serve_requests(cfg, params, prompts, graph=False, **opts)
    cpu, _ = serve.serve_requests(cfg, _to_cpu(params), prompts, **opts)
    for a, b, c in zip(tokens, eager, cpu):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    step = times[-1]["step"]
    assert times[-1]["prefill"].captures == 1 and step.replays == 2 * 4
    # the static caches' ssm leaves are the ones B5 wrote: one more replay
    # moves each of them without a copy after the graph
    (_, (_, _, s_caches, _, _)), = step._static.items()
    ssm = [c["ssm"] for c in s_caches.values() if "ssm" in c]
    before = [z.clone() for z in ssm]
    step(s_caches, torch.zeros((2, 1), dtype=torch.int32, device=card))
    torch.cuda.synchronize()
    assert all(not torch.equal(a, b) for a, b in zip(before, ssm))


# ---------------------------------------------------------------------------
# training on the card: B3 in every attention forward and remat recompute
# ---------------------------------------------------------------------------

#: the card's train step against the same step on the CPU (float32, head
#: dim 64, float32 moments): each step's loss within TRAIN_LOSS_F32
#: relative, and after 3 steps every parameter within TRAIN_PARAM_LR x lr
#: of the CPU's (an Adam step moves a weight by about lr whatever its
#: gradient's size, so a weight whose gradient is near zero can move
#: differently on the two devices) with at most TRAIN_PARAM_SHARE of them
#: off by more than 1e-3 lr (measured on an H100: 289 of 164416, 0.18%)
TRAIN_LOSS_F32 = 1e-5
TRAIN_PARAM_LR = 4.0
TRAIN_PARAM_SHARE = 1e-2


def _train_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _train_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_train_step_on_the_card_follows_the_cpu(card):
    """Qwen3-4B's SMOKE config at head dim 64 with remat, 3 steps of
    ``make_train_step`` (2 microbatches) on the card, where B3 runs every
    attention forward and its recompute, against the same steps on the
    CPU (the plain attention)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    cfg = _family_cfg("qwen3-4b", head_dim=64, remat=True)
    params = _family_params(cfg, card, seed=3)
    cpu = _to_cpu(params)
    kw = dict(num_microbatches=2, opt_state_dtype="f32", peak_lr=1e-3,
              warmup=1, total_steps=100)
    step, _ = make_train_step(cfg, **kw)
    cstep, _ = make_train_step(cfg, device="cpu", **kw)
    opt, copt = adamw_init(params, state_dtype="f32"), adamw_init(
        cpu, state_dtype="f32")
    data = SyntheticLM(cfg, 4, 32, seed=1)
    fa.LAUNCHES["flash_attention"] = 0
    for s in range(3):
        params, opt, m = step(params, opt, data.batch_at(s))
        cpu, copt, cm = cstep(cpu, copt, data.batch_at(s))
        assert abs(float(m["loss"]) - float(cm["loss"])) \
            <= TRAIN_LOSS_F32 * float(cm["loss"])
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 3 * 2 * 2 * cfg.n_layers
    lr = float(m["lr"])
    off = n = 0
    for (path, g), (_, w) in zip(_train_leaves(params), _train_leaves(cpu)):
        d = (g.cpu() - w).abs()
        assert float(d.max()) <= TRAIN_PARAM_LR * lr, path
        off += int((d > 1e-3 * lr).sum())
        n += d.numel()
    assert off <= TRAIN_PARAM_SHARE * n, (off, n)


def test_adamw_tape_is_one_b1_block_bitwise_to_the_floor(cuda):
    from repro_torch.core import lazy
    from repro_torch.optim.fused import record_adamw_tape
    """The update's flush is one block; under triton every block run (the
    draws' and the update's) is one B1 launch, none declined, and the
    outputs are the floor's bit for bit."""
    outs = {}
    for backend in ("triton", "torch"):
        with lazy.fresh_runtime(backend=backend, loop_fusion=False) as rt:
            codegen.LAUNCHES["fused_block"] = 0
            res = record_adamw_tape(rt, 100_003, lr=1e-3, c1=0.1, c2=0.05)
            outs[backend] = [r.numpy() for r in res]
            update = max((h for h in rt.history if not h.get("cached")),
                         key=lambda h: h["n_ops"])
            assert update["n_blocks"] == 1 and update["n_ops"] > 10
            if backend == "triton":
                st = rt.executor.stats.snapshot()
                assert st["triton_fallback_blocks"] == 0
                assert codegen.LAUNCHES["fused_block"] \
                    == st["triton_blocks"] >= 2
    for a, b in zip(outs["triton"], outs["torch"]):
        assert a.tobytes() == b.tobytes()


def test_checkpoint_restores_to_the_card(card, tmp_path):
    """A tree saved from the card (float32, bf16, int8 and int32 leaves,
    an ``OptState``) restores onto the card bitwise, each leaf on its
    like-leaf's device and dtype."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import OptState
    gen = torch.Generator(device=card).manual_seed(0)
    tree = {"w": torch.randn((64, 32), generator=gen, device=card),
            "h": torch.randn(7, generator=gen, device=card).bfloat16(),
            "opt": OptState(step=torch.tensor(4, dtype=torch.int32,
                                              device=card),
                            m={"q": torch.randint(-127, 128, (3, 5),
                                                  generator=gen, device=card,
                                                  dtype=torch.int8),
                               "scale": torch.rand((3, 1), generator=gen,
                                                   device=card)},
                            v=torch.zeros(2, device=card))}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, tree)
    mgr.wait()
    like = {"w": torch.zeros((64, 32), device=card),
            "h": torch.zeros(7, device=card, dtype=torch.bfloat16),
            "opt": OptState(step=torch.zeros((), dtype=torch.int32,
                                             device=card),
                            m={"q": torch.zeros((3, 5), dtype=torch.int8,
                                                device=card),
                               "scale": torch.zeros((3, 1), device=card)},
                            v=torch.zeros(2, device=card))}
    step, got = mgr.restore(None, like)
    assert step == 4
    from repro_torch.checkpoint.manager import _flatten
    for (p, a), (_, b) in zip(_flatten(got), _flatten(tree)):
        assert a.device.type == "cuda" and a.dtype == b.dtype, p
        assert torch.equal(a, b), p


def test_mesh_world_of_one_over_nccl(cuda):
    """The mesh's production route on one card: a world of one over NCCL,
    ``backend="triton"`` under ``comm``.  The reference's window, aligned
    and reduction programs and three benchmark programs run bitwise to the
    same runs without a mesh, B1 runs the blocks ``shard_map`` declines,
    and a plan made under the mesh is keyed by its topology."""
    import torch.distributed as tdist
    from repro_torch.core import dist
    from repro_torch.core import lazy as bh
    from repro_torch.core.dist import host_mesh
    from repro_torch.testing import mesh as tmesh
    from repro_torch.testing.programs import BENCHMARKS
    if tdist.is_initialized():
        pytest.skip("a process group is already up")
    mesh = host_mesh()
    try:
        assert mesh.device_type == "cuda"
        assert tdist.get_backend(mesh.get_group()) == "nccl"
        todo = {k: (lambda f=f: f(bh, dist, 1, 2 ** 16))
                for k, f in tmesh.PROGRAMS.items()}
        for k, args in (("black_scholes", (2, 4096)),
                        ("game_of_life", (2, 64)),
                        ("heat_equation", (2, 64))):
            todo[k] = lambda f=BENCHMARKS[k], a=args: f(*a).numpy()
        for name, fn in todo.items():
            codegen.LAUNCHES["fused_block"] = 0
            got = tmesh.run_once(fn, "cuda", True, backend="triton",
                             cost_model="comm", mesh=mesh)
            assert codegen.LAUNCHES["fused_block"] > 0, name
            want = tmesh.run_once(fn, "cuda", True, backend="triton",
                              cost_model="comm")
            assert got["out"].tobytes() == want["out"].tobytes(), name
            assert got["collectives"] == got["shard_map_blocks"] == 0
        with bh.fresh_runtime(backend="triton", mesh=mesh) as rt:
            assert rt.executor.topology_key() == (("dev", 1), "cuda")
            assert rt.executor.backends == ("shard_map", "triton", "torch")
    finally:
        tdist.destroy_process_group()


#: the model on a 1 x 1 mesh: each kernel's arch (a small width whose heads
#: and channels the kernels take) and the op its model call site calls
MESH_KERNELS = {
    "flash_attention": ("qwen3-4b", "flash_attention.ops", "attention"),
    "mamba_scan": ("jamba-v0.1-52b", "mamba_scan.ops", "mamba"),
    "rwkv6_chunked": ("rwkv6-3b", "rwkv6_scan.ops", "rwkv6_chunked"),
    "rwkv6_scan": ("rwkv6-3b", "rwkv6_scan.ops", "rwkv6"),
    "decode_attention": ("qwen3-4b", "decode_attention.kernel",
                         "decode_attention"),
}


def _mesh_config(arch):
    from repro_torch.configs import get_config
    cfg = get_config(arch).scaled(dtype="float32", vocab_size=512,
                                  d_model=256, d_ff=512)
    if arch == "qwen3-4b":
        return cfg.scaled(n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64)
    return cfg.scaled(n_layers=2)


@pytest.mark.parametrize("kernel", list(MESH_KERNELS))
def test_kernel_through_its_local_call_on_a_one_by_one_mesh(card, kernel):
    """The model on a world of one over NCCL (``make_host_mesh()``, (1,
    1)): ``make_serve_steps``' prefill and two decode steps run each kernel
    through its call site's ``local_map`` (``models.layers.sharded_call``)
    on DTensor inputs; the kernel launches there, its first call is held
    against its plain version on the recorded inputs, and the logits are
    bitwise the mesh-less model's."""
    import importlib
    import torch.distributed as tdist
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.kernels.decode_attention.ref import \
        reference_decode_attention
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.kernels.mamba_scan.ref import reference_mamba
    from repro_torch.kernels.rwkv6_scan.ref import (reference_rwkv6,
                                                    reference_rwkv6_chunked)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_serve_steps
    from repro_torch.models import transformer as T
    from repro_torch.testing import mesh as tmesh
    if tdist.is_initialized():
        pytest.skip("a process group is already up")
    arch, module, name = MESH_KERNELS[kernel]
    ops = importlib.import_module(f"repro_torch.kernels.{module}")
    cfg = _mesh_config(arch)
    mesh = make_host_mesh()
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = T.init_params(cfg, gen, "cuda")
        tmesh.draw_gains(params, gen, cfg.norm_plus_one)
        sp = T.serving_params(params, cfg)
        prefill, decode, specs = make_serve_steps(cfg, mesh, 70, 2)
        dsp = shard_tree(sp, specs["params"], mesh)
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                             device="cuda")
        calls, real = [], getattr(ops, name)

        def spy(*args, **kw):
            out = real(*args, **kw)
            if not calls:
                calls.append(([a.clone() if torch.is_tensor(a) else a
                               for a in args], dict(kw), out))
            return out

        tmesh.zero_launches()
        setattr(ops, name, spy)
        try:
            got, cache = prefill(dsp, {"tokens": toks})
            gots = [got]
            for _ in range(2):
                tok = got.full_tensor()[:, -1].argmax(-1)[:, None]
                got, cache = decode(dsp, cache, tok)
                gots.append(got)
        finally:
            setattr(ops, name, real)
        assert tmesh.kernel_launches()[kernel] > 0
        assert all(type(g).__name__ == "DTensor" for g in gots)
        args, kw, out = calls[0]
        assert not any(type(a).__name__ == "DTensor" for a in args)
        if kernel == "flash_attention":
            _hold(out, reference_attention(*args[:3], causal=args[3],
                                           window=args[4], softcap=args[5],
                                           scale=args[6]), "attention")
        elif kernel == "decode_attention":
            _hold(out, reference_decode_attention(*args, **kw), "attention")
        else:
            plain = {"mamba_scan": reference_mamba,
                     "rwkv6_chunked": reference_rwkv6_chunked,
                     "rwkv6_scan": reference_rwkv6}[kernel]
            n_in = 6 if kernel == "mamba_scan" else 5
            want = plain(*args[:n_in], state=kw.get("state"),
                         return_state=True)
            for g, w in zip(out, want):
                _hold(g, w, "scan")
        want, wc = T.serve_prefill(sp, toks, cfg, 70)
        assert torch.equal(gots[0].full_tensor(), want)
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# B3, B5, B6 and B7 as custom operators: what a dry run's fake trace of the
# card's step passes through (launch/dryrun.py)
# ---------------------------------------------------------------------------

def _op_case(name, dev):
    """``(operator, positional arguments, plain outputs)`` on CUDA inputs
    at the existing tests' shapes; the state an in-place form writes (its
    last argument, the plain version's last output) is a tensor of its
    own (``opcheck`` runs the operator several times)."""
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.kernels.mamba_scan.ref import reference_mamba
    from repro_torch.kernels.rwkv6_scan.ref import (reference_rwkv6,
                                                    reference_rwkv6_chunked)
    ops = torch.ops.repro_torch
    rng = np.random.default_rng(len(name))
    if name.startswith("decode_attention"):
        from repro_torch.kernels.decode_attention.ref import \
            reference_decode_attention
        dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
        q = _randn(rng, (2, 1, 4, 64), dtype, dev)
        k, v = (_randn(rng, (2, 100, 2, 64), dtype, dev) for _ in range(2))
        idx = torch.tensor(70, dtype=torch.int32, device=dev)
        return ops.decode_attention, (q, k, v, idx, False, 48, 50.0), (
            reference_decode_attention(q, k, v, idx, window=48,
                                       softcap=50.0),)
    if name.startswith("flash_attention"):
        dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
        q = _randn(rng, (2, 4, 100, 64), dtype, dev)
        k, v = (_randn(rng, (2, 2, 100, 64), dtype, dev) for _ in range(2))
        args = (q, k, v, True, 48, 50.0, 0.125)
        return ops.flash_attention, args, (reference_attention(
            q, k, v, causal=True, window=48, softcap=50.0, scale=0.125),)
    if name.startswith("mamba_scan"):
        ins = _mamba_inputs(rng, 2, 40, 64, 16, torch.float32, dev)
        h0 = _randn(rng, (2, 64, 16), torch.float32, dev, 0.5)
        want = reference_mamba(*ins, state=h0, return_state=True)
        if name.endswith("_"):
            return ops.mamba_scan_, (*ins, h0, torch.empty_like(h0)), want
        return ops.mamba_scan, (*ins, h0, True), want
    r, k, v, w, u, s0 = _rwkv_model_inputs(rng, 8, 1 if name.endswith("_")
                                           else 64, 64, torch.float32, dev,
                                           heads=2)
    if name == "rwkv6_chunked":
        return ops.rwkv6_chunked, (r, k, v, w, u, s0, 32, True), \
            reference_rwkv6_chunked(r, k, v, w, u, state=s0,
                                    return_state=True)
    want = reference_rwkv6(r, k, v, w, u, state=s0, return_state=True)
    if name.endswith("_"):
        return ops.rwkv6_scan_, (r, k, v, w, u, s0, torch.empty_like(s0)), \
            want
    return ops.rwkv6_scan, (r, k, v, w, u, s0, True), want


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bf16",
                                  "mamba_scan", "mamba_scan_", "rwkv6_scan",
                                  "rwkv6_scan_", "rwkv6_chunked",
                                  "decode_attention",
                                  "decode_attention_bf16"])
def test_custom_op_on_the_card_is_the_kernel(card, name):
    """Each operator on CUDA tensors launches its kernel once a call (the
    dispatcher's CUDA implementation, no fallback), within the existing
    tolerances of its plain version; ``torch.library.opcheck`` passes."""
    from repro_torch.testing import mesh as tmesh
    op, args, want = _op_case(name, card)
    kernel = name.removesuffix("_bf16").rstrip("_")
    before = tmesh.kernel_launches()[kernel]
    got = op(*args)
    torch.cuda.synchronize()
    assert tmesh.kernel_launches()[kernel] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    if name.endswith("_"):              # the state written in place
        got += (args[-1],)
    kind = "attention" if kernel.endswith("attention") else "scan"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _hold(g, w, kind)
    torch.library.opcheck(op, args)


def test_fake_cuda_trace_of_a_layer_allocates_nothing(card):
    """A dry-run trace of one Qwen3-4B layer's train step over a fake
    (2, 2) group on fake CUDA tensors: B3 called (forward and the remat
    recompute), nothing launched and nothing allocated on the card."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.testing import mesh as tmesh
    if tdist.is_initialized():
        pytest.skip("a process group is already up")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    launches = tmesh.kernel_launches()
    cfg = get_config("qwen3-4b").scaled(n_layers=1)
    with D.fake_group(4):
        mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        rec = D.run_cell(cfg, ShapeSpec("t", 512, 4, "train"), "2x2",
                         out_dir=None, mesh=mesh, device="cuda",
                         train_kw=dict(num_microbatches=1))
    assert rec["kernel_calls"] == {"flash_attention": 2}
    assert rec["device"] == "cuda" and rec["flops_per_device"] > 0
    assert torch.cuda.memory_allocated() == before
    assert tmesh.kernel_launches() == launches


# ---------------------------------------------------------------------------
# B1's contracting form (the gpu_fma cost model's) and B5's backward operator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_contracting_block_within_its_pair_allowance(cuda, dtype):
    """``y = a·b + c`` then ``z = y·d + a`` (two pairs) and a plain
    ``w = y - c``, built with ``contract_fma``: each pair one ``tl.fma``
    (as many as ``gpu_fma``'s ``_fma_pairs`` counts), the outputs within
    ``u·(|a·b| + 2·|a·b + c|)`` a pair of the floor (plus the first
    pair's change carried through the second product), and some of them
    off the floor, so the pairs did contract."""
    from repro_torch.core.blocks import BlockInfo
    from repro_torch.core.cost import make_cost_model
    n = 1 << 14
    rng = np.random.default_rng(7)
    a, b, c, d = (_base(n, dtype) for _ in range(4))
    t, y, z, w = (_base(n, dtype) for _ in range(4))
    v = lambda x: View.contiguous(x, (n,))           # noqa: E731
    ops = [Op("mul", v(t), (v(a), v(b)), new_bases=frozenset({t})),
           Op("add", v(y), (v(t), v(c)), new_bases=frozenset({y})),
           Op("mul", v(t), (v(y), v(d))),
           Op("add", v(z), (v(t), v(a)), new_bases=frozenset({z})),
           Op("sub", v(w), (v(y), v(c)), new_bases=frozenset({w}))]
    fn, ins, outs = codegen.build_block_kernel(ops, device=cuda,
                                               contract_fma=True)
    ref, _, _ = make_block_fn(ops, device=cuda)
    pairs = make_cost_model("gpu_fma")._fma_pairs(BlockInfo.from_ops(ops))
    assert pairs == len(fn.plan.fma) == 2 == codegen.triton_source(
        fn.plan, contract_fma=True)[0].count("tl.fma(")
    data = {u.uid: torch.from_numpy(rng.standard_normal(n).astype(dtype))
            .to(cuda) for u in (a, b, c, d)}
    bufs = [data[u] for u in ins]
    before = codegen.LAUNCHES["fused_block"]
    got = dict(zip(outs, fn(*bufs, ())))
    assert codegen.LAUNCHES["fused_block"] == before + 1
    want = dict(zip(outs, ref(*bufs, ())))
    assert all(torch.equal(x, y_) for x, y_ in zip(fn.plain(*bufs, ()),
                                                   want.values()))
    unit = 2.0 ** (-53 if dtype == np.float64 else -24)
    A, B, Cc, D = (data[u.uid].double() for u in (a, b, c, d))
    ab = A * B
    allow_y = unit * (ab.abs() + 2 * (ab + Cc).abs())
    yd = (ab + Cc) * D
    allow_z = allow_y * D.abs() + unit * (yd.abs() + 2 * (yd + A).abs())
    # w = y - c: y's change and the subtraction's rounding in each form
    allow_w = allow_y + 2 * unit * ab.abs()
    off = 0
    for base, allow in ((y, allow_y), (z, allow_z), (w, allow_w)):
        diff = (got[base.uid].double() - want[base.uid].double()).abs()
        assert bool((diff <= allow * (1 + 1e-6)).all()), base
        off += int((diff > 0).sum())
    assert off > 0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_backward_op_on_the_card_is_the_plain_backward(card, dtype,
                                                             with_state):
    """B5's backward operator on CUDA tensors: bitwise the gradients of
    autograd through ``reference_mamba`` on the card, and ``opcheck``
    passes."""
    from repro_torch.kernels.mamba_scan import kernel as mk
    from repro_torch.kernels.mamba_scan.ops import mamba
    from repro_torch.kernels.mamba_scan.ref import reference_mamba
    rng = np.random.default_rng(5)
    ins = _mamba_inputs(rng, 2, 48, 64, 16, dtype, card)
    st = _randn(rng, (2, 64, 16), torch.float32, card) if with_state \
        else None
    gy = _randn(rng, (2, 48, 64), dtype, card)
    gh = _randn(rng, (2, 64, 16), torch.float32, card) if with_state \
        else None
    leaves = [z.clone().requires_grad_() for z in ins]
    s0 = None if st is None else st.clone().requires_grad_()
    wrt = leaves + ([] if s0 is None else [s0])
    with torch.enable_grad():
        outs = reference_mamba(*leaves, state=s0, return_state=with_state)
    outs = outs if with_state else (outs,)
    grads = [g for g in (gy, gh) if g is not None]
    want = torch.autograd.grad(list(outs), wrt, grads)
    leaves = [z.clone().requires_grad_() for z in ins]
    s0 = None if st is None else st.clone().requires_grad_()
    wrt = leaves + ([] if s0 is None else [s0])
    outs = mamba(*leaves, state=s0, return_state=with_state)
    outs = outs if with_state else (outs,)
    got = torch.autograd.grad(list(outs), wrt, grads)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g, w)
    torch.library.opcheck(mk.backward_op, (*ins, st, gy, gh))
