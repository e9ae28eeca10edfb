"""Card-only checks of the Triton kernels — the fused-block generator (B1)
and the row-replay generator (B2) — and of the LM lane that runs them
(skipped without a CUDA device and Triton).

Run on a GPU with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``.  Each case builds one block in the port's IR,
runs the generated kernel on CUDA tensors, and holds it against the torch
floor (``make_block_fn``) and the kernel's plain version on the same
inputs: bitwise for every elementwise op (libdevice is what PyTorch's CUDA
kernels call too) and for reductions over integer-valued data (every
summation order is exact there).  Real-valued row sums (softmax
normalizers, the LM's variances) are held to the summation error bound
``row * eps * magnitude``.
"""

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


def test_program_end_to_end_matches_floor(cuda):
    from repro_torch.core.lazy import fresh_runtime
    from repro_torch.testing.programs import BENCHMARKS
    out = {}
    for backend in ("torch", "triton"):
        with fresh_runtime(backend=backend) as rt:
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
    float32 sums over 32-64 terms in other orders), full-float32 matmuls."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.lazy_transformer import LazyTransformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="lm_tiny", family="dense", n_layers=2, d_model=32,
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
