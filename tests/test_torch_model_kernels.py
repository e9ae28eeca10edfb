"""The port's standalone model kernels against the JAX package, on the CPU.

B3 flash attention, B4 fused add+RMSNorm, B5 the Mamba scan and B6 the
RWKV6 scan: the same numpy inputs, made from a seed, go through the JAX
Pallas kernel in interpret mode, through the JAX ``ref.py``, and through
the port's public op on CPU tensors (which runs the kernel's plain
version; the CUDA kernels are held to it on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``).  Shapes mirror
``tests/test_kernels.py``.  Tolerances are the reference's own: float32
2e-5 for attention, 3e-4 for the scans, bfloat16 3e-2; the norm within 4
float32 ulps (ROADMAP C8: XLA's and PyTorch's CPU ``rsqrt`` differ in the
last ulp).  Gradients (the reference's backward is ``jax.vjp`` of its
reference; the port's is autograd through its plain version) agree within
1e-4, and the scans' ``state``/``return_state`` forms match the JAX
reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ops import attention as j_attention
from repro.kernels.flash_attention.ref import reference_attention as j_attn_ref
from repro.kernels.mamba_scan.kernel import mamba_scan as j_mamba_scan
from repro.kernels.mamba_scan.ops import mamba as j_mamba
from repro.kernels.mamba_scan.ref import reference_mamba as j_mamba_ref
from repro.kernels.rmsnorm.kernel import fused_add_rmsnorm as j_norm_kernel
from repro.kernels.rmsnorm.ops import add_rmsnorm as j_add_rmsnorm
from repro.kernels.rmsnorm.ref import reference_add_rmsnorm as j_norm_ref
from repro.kernels.rwkv6_scan.kernel import rwkv6_scan as j_rwkv6_scan
from repro.kernels.rwkv6_scan.ops import rwkv6 as j_rwkv6
from repro.kernels.rwkv6_scan.ref import reference_rwkv6 as j_rwkv6_ref
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.mamba_scan.ops import mamba
from repro_torch.kernels.mamba_scan.ref import reference_mamba
from repro_torch.kernels.rmsnorm.ops import add_rmsnorm
from repro_torch.kernels.rwkv6_scan.ops import rwkv6
from repro_torch.kernels.rwkv6_scan.ref import reference_rwkv6

F32 = dict(rtol=2e-5, atol=2e-5)
SCAN = dict(rtol=3e-4, atol=3e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _softplus(x):
    return np.logaddexp(0.0, x).astype(np.float32)


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, *wants, tol):
    for want in wants:
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), **tol)


def _attn_inputs(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, hq, sq, d)), _normal(rng, (b, hkv, sk, d)),
            _normal(rng, (b, hkv, sk, d)))


def _mamba_inputs(seed, b, t, di, ds):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, t, di)),
            _softplus(_normal(rng, (b, t, di))) * np.float32(0.1),
            _normal(rng, (b, t, ds)), _normal(rng, (b, t, ds)),
            -_softplus(_normal(rng, (di, ds))) - np.float32(0.2),
            _normal(rng, (di,)))


def _rwkv_inputs(seed, bh, t, n):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (bh, t, n)), _normal(rng, (bh, t, n), 0.3),
            _normal(rng, (bh, t, n)),
            _sigmoid(_normal(rng, (bh, t, n))) * np.float32(0.5)
            + np.float32(0.45),
            _normal(rng, (n,), 0.1))


# ---------------------------------------------------------------------------
# B3 flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk,hq,hkv,d", [
    (128, 128, 4, 4, 64),      # MHA
    (128, 128, 4, 2, 64),      # GQA 2:1
    (256, 256, 8, 1, 32),      # MQA
    (100, 100, 2, 2, 64),      # ragged
    (64, 256, 2, 1, 128),      # cross-length
])
def test_attention_shapes(sq, sk, hq, hkv, d):
    q, k, v = _attn_inputs(sq + sk + hq + hkv + d, 2, hq, hkv, sq, sk, d)
    got = attention(*_torch(q, k, v), True).numpy()
    _close(got, j_flash(*_jax(q, k, v), causal=True, interpret=True),
           j_attn_ref(*_jax(q, k, v), causal=True), tol=F32)


@pytest.mark.parametrize("window,softcap,causal", [
    (None, None, False),
    (64, None, True),          # sliding window (gemma2 local)
    (None, 30.0, True),        # logit softcap (gemma2)
    (32, 50.0, True),          # both
])
def test_attention_features(window, softcap, causal):
    q, k, v = _attn_inputs(2, 1, 4, 2, 256, 256, 64)
    got = attention(*_torch(q, k, v), causal, window, softcap).numpy()
    opts = dict(causal=causal, window=window, softcap=softcap)
    _close(got, j_flash(*_jax(q, k, v), interpret=True, **opts),
           j_attn_ref(*_jax(q, k, v), **opts), tol=F32)


def test_attention_bf16():
    """The same float32 numbers rounded to bfloat16 on both sides."""
    q, k, v = _attn_inputs(3, 1, 2, 2, 128, 128, 64)
    got = attention(*(t.to(torch.bfloat16) for t in _torch(q, k, v)))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (a.astype(jnp.bfloat16) for a in _jax(q, k, v))
    _close(got.float().numpy(),
           j_flash(jq, jk, jv, interpret=True).astype(jnp.float32),
           j_attn_ref(jq, jk, jv).astype(jnp.float32), tol=BF16)


def test_attention_gradients():
    q, k, v = _attn_inputs(9, 1, 4, 2, 48, 48, 32)
    g = _normal(np.random.default_rng(10), q.shape)
    opts = (True, 16, 30.0)
    _, vjp = jax.vjp(lambda *a: j_attention(*a, *opts), *_jax(q, k, v))
    want = vjp(jnp.asarray(g))
    ins = [t.requires_grad_() for t in _torch(q, k, v)]
    attention(*ins, *opts).backward(torch.from_numpy(g))
    for t, w in zip(ins, want):
        _close(t.grad.numpy(), w, tol=GRAD)


# ---------------------------------------------------------------------------
# B4 fused add + RMSNorm
# ---------------------------------------------------------------------------

def _assert_ulps(got, want, ulps=4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    spacing = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulps * spacing), \
        float(np.max(np.abs(got - want) / spacing))


@pytest.mark.parametrize("rows,d", [(8, 128), (100, 256), (512, 512)])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm(rows, d, plus_one):
    rng = np.random.default_rng(4 + rows + d)
    x, r, g = _normal(rng, (rows, d)), _normal(rng, (rows, d)), \
        _normal(rng, (d,))
    y, h = add_rmsnorm(*_torch(x, r, g), 1e-6, plus_one)
    for want in (j_norm_kernel(*_jax(x, r, g), plus_one=plus_one,
                               interpret=True),
                 j_norm_ref(*_jax(x, r, g), plus_one=plus_one)):
        _assert_ulps(y.numpy(), want[0])
        np.testing.assert_array_equal(h.numpy(), np.asarray(want[1]))


def test_rmsnorm_bf16_norms_the_float32_sum():
    """``y`` comes from the float32 ``x + r``, not from its bfloat16
    rounding, on both sides."""
    rng = np.random.default_rng(11)
    x, r, g = _normal(rng, (3, 7, 96)), _normal(rng, (3, 7, 96)), \
        _normal(rng, (96,))
    y, h = add_rmsnorm(*(t.to(torch.bfloat16) for t in _torch(x, r, g)),
                       1e-6, True)
    assert y.dtype == h.dtype == torch.bfloat16 and y.shape == (3, 7, 96)
    jx, jr, jg = (a.astype(jnp.bfloat16) for a in _jax(x, r, g))
    for want in (j_norm_kernel(jx, jr, jg, plus_one=True, interpret=True),
                 j_norm_ref(jx, jr, jg, plus_one=True)):
        _close(y.float().numpy(), want[0].astype(jnp.float32), tol=BF16)
        _close(h.float().numpy(), want[1].astype(jnp.float32), tol=BF16)


def test_rmsnorm_gradients():
    rng = np.random.default_rng(12)
    x, r, g = _normal(rng, (6, 64)), _normal(rng, (6, 64)), _normal(rng, (64,))
    gy, gh = _normal(rng, (6, 64)), _normal(rng, (6, 64))
    _, vjp = jax.vjp(lambda *a: j_add_rmsnorm(*a, 1e-6, True), *_jax(x, r, g))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    ins = [t.requires_grad_() for t in _torch(x, r, g)]
    y, h = add_rmsnorm(*ins, 1e-6, True)
    torch.autograd.backward((y, h), _torch(gy, gh))
    for t, w in zip(ins, want):
        _close(t.grad.numpy(), w, tol=GRAD)


# ---------------------------------------------------------------------------
# B6 RWKV6 scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,t,n", [(2, 64, 32), (4, 128, 64), (1, 96, 64)])
def test_rwkv6(bh, t, n):
    ins = _rwkv_inputs(5 + bh + t + n, bh, t, n)
    got = rwkv6(*_torch(*ins), 32).numpy()
    _close(got, j_rwkv6_scan(*_jax(*ins), chunk=32, interpret=True),
           j_rwkv6_ref(*_jax(*ins)), tol=SCAN)


def test_rwkv6_gradients():
    ins = _rwkv_inputs(13, 2, 16, 32)
    g = _normal(np.random.default_rng(14), ins[0].shape)
    _, vjp = jax.vjp(lambda *a: j_rwkv6(*a, 16), *_jax(*ins))
    want = vjp(jnp.asarray(g))
    tins = [t.requires_grad_() for t in _torch(*ins)]
    rwkv6(*tins, 16).backward(torch.from_numpy(g))
    for t, w in zip(tins, want):
        _close(t.grad.numpy(), w, tol=GRAD)


@pytest.mark.parametrize("t", [20, 512])     # 512: the reference's remat path
def test_rwkv6_state(t):
    ins = _rwkv_inputs(15 + t, 2, t, 32)
    s0 = _normal(np.random.default_rng(16), (2, 32, 32), 0.1)
    o, s = reference_rwkv6(*_torch(*ins), state=torch.from_numpy(s0),
                           return_state=True)
    jo, js = j_rwkv6_ref(*_jax(*ins), state=jnp.asarray(s0),
                         return_state=True)
    _close(o.numpy(), jo, tol=SCAN)
    _close(s.numpy(), js, tol=SCAN)


# ---------------------------------------------------------------------------
# B5 Mamba scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,di,ds", [(2, 64, 32, 8), (1, 128, 64, 16)])
def test_mamba(b, t, di, ds):
    ins = _mamba_inputs(6 + b + t + di + ds, b, t, di, ds)
    got = mamba(*_torch(*ins), 32).numpy()
    _close(got, j_mamba_scan(*_jax(*ins), chunk=32, interpret=True),
           j_mamba_ref(*_jax(*ins)), tol=SCAN)


def test_mamba_gradients():
    ins = _mamba_inputs(17, 2, 12, 16, 4)
    g = _normal(np.random.default_rng(18), ins[0].shape)
    _, vjp = jax.vjp(lambda *a: j_mamba(*a, 8), *_jax(*ins))
    want = vjp(jnp.asarray(g))
    tins = [t.requires_grad_() for t in _torch(*ins)]
    mamba(*tins, 8).backward(torch.from_numpy(g))
    for t, w in zip(tins, want):
        _close(t.grad.numpy(), w, tol=GRAD)


@pytest.mark.parametrize("t", [20, 512])     # 512: the reference's remat path
def test_mamba_state(t):
    ins = _mamba_inputs(19 + t, 2, t, 16, 8)
    h0 = _normal(np.random.default_rng(20), (2, 16, 8), 0.1)
    y, h = reference_mamba(*_torch(*ins), state=torch.from_numpy(h0),
                           return_state=True)
    jy, jh = j_mamba_ref(*_jax(*ins), state=jnp.asarray(h0),
                         return_state=True)
    _close(y.numpy(), jy, tol=SCAN)
    _close(h.numpy(), jh, tol=SCAN)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _hybrid_block(ops, fw, p):
    """Pre-norm, GQA attention with a window and softcap, then a Mamba and
    an RWKV6 mixer over the attention output.  ``ops`` are the four public
    ops; ``fw`` the framework's matmul, sigmoid, softplus and head
    split/merge."""
    norm, attn, mam, rk = ops
    mm, sig, splus, heads, merge = fw
    b, s, _ = p["x"].shape
    hkv_w = p["wkv"].shape[1] // 2
    y, h = norm(p["x"], p["res"], p["g"])
    kv = mm(y, p["wkv"])
    o = merge(attn(heads(mm(y, p["wq"])), heads(kv[..., :hkv_w]),
                   heads(kv[..., hkv_w:]))) + h
    bc = mm(o, p["bc_w"])
    z = mam(o, splus(mm(o, p["dt_w"])) * 0.1, bc[..., :8], bc[..., 8:],
            p["a"], p["d"])
    w = sig(mm(z, p["w_w"])) * 0.5 + 0.45
    flat = lambda t: heads(t).reshape(-1, s, p["u"].shape[0])  # noqa: E731
    return rk(flat(z), flat(o), flat(y), flat(w), p["u"])


def test_slice_as_a_whole():
    """The four ops chained into one small hybrid block, in the JAX
    package (Pallas kernels in interpret mode) and in the port (plain
    versions on the CPU)."""
    rng = np.random.default_rng(21)
    b, s, hq, hkv, hd = 2, 40, 4, 2, 16
    dm = hq * hd
    p = {"x": _normal(rng, (b, s, dm)), "res": _normal(rng, (b, s, dm)),
         "g": _normal(rng, (dm,), 0.1), "wq": _normal(rng, (dm, dm), 0.2),
         "wkv": _normal(rng, (dm, 2 * hkv * hd), 0.2),
         "dt_w": _normal(rng, (dm, dm), 0.05),
         "a": -_softplus(_normal(rng, (dm, 8))),
         "bc_w": _normal(rng, (dm, 16), 0.2), "d": _normal(rng, (dm,)),
         "w_w": _normal(rng, (dm, dm), 0.2), "u": _normal(rng, (hd,), 0.1)}

    def j_heads(t):
        return jnp.transpose(t.reshape(b, s, -1, hd), (0, 2, 1, 3))

    def j_merge(t):
        return jnp.transpose(t, (0, 2, 1, 3)).reshape(b, s, -1)

    def t_heads(t):
        return t.reshape(b, s, -1, hd).permute(0, 2, 1, 3).contiguous()

    def t_merge(t):
        return t.permute(0, 2, 1, 3).reshape(b, s, -1)

    want = _hybrid_block(
        (lambda *t: j_add_rmsnorm(*t, 1e-6, True),
         lambda q, k, v: j_attention(q, k, v, True, 24, 30.0),
         lambda *t: j_mamba(*t, 8), lambda *t: j_rwkv6(*t, 8)),
        (jnp.matmul, jax.nn.sigmoid, jax.nn.softplus, j_heads, j_merge),
        {k: jnp.asarray(v) for k, v in p.items()})
    got = _hybrid_block(
        (lambda *t: add_rmsnorm(*t, 1e-6, True),
         lambda q, k, v: attention(q, k, v, True, 24, 30.0),
         lambda *t: mamba(*t, 8), lambda *t: rwkv6(*t, 8)),
        (torch.matmul, torch.sigmoid, torch.nn.functional.softplus, t_heads,
         t_merge),
        {k: torch.from_numpy(v) for k, v in p.items()})
    assert got.shape == (b * hq, s, hd) and torch.isfinite(got).all()
    _close(got.numpy(), want, tol=SCAN)
