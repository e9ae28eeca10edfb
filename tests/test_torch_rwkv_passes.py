"""Kernel B7's route (``src/repro_torch/csrc/rwkv6_chunked.cu``) in plain
PyTorch on the CPU: ``ref.py:chunk_products`` — the chunks in order, the
scores, the outputs and the state contribution through the product the
kernel takes on the tensor cores — against the JAX package, and the
kernel's tensor-core arithmetic emulated.

The inputs are made with numpy from a seed and go through the JAX Pallas
``rwkv6_chunked`` (interpret mode), the JAX loop ``reference_rwkv6`` and
the port.  Tolerances: against the Pallas kernel, the same algebra in
float32 with sums in other orders, ``TIGHT`` (2e-5, as in
``tests/test_torch_rwkv.py``); against the loop, the reference's own 2e-3
(``tests/test_kernels.py``); bf16 r/k/v add one bf16 ulp of the output
(both sides compute in float32 and round once).

The rounding: the kernel takes all four products (the scores, their
product with V, ``r̃S`` and the state contribution ``k̃ᵀV``) on the FP64
tensor cores (``mma.sync`` m8n8k4): float32 operands, exact products,
float64 sums, each output rounded to its type once.  ``chip_smoke.py``
holds its final state to the plain version at
``MODEL_TOL["rwkv6_chunked"]`` = 3e-4 and its outputs at that plus one
bf16 ulp for bf16 outputs.  Emulated here at an RWKV6-3B prefill's widths
(64-channel heads, 512 tokens, RWKV-LM's decays), with B3's TF32
emulation (``tests/test_torch_flash_precision.py``): one TF32 product
misses the state's 3e-4, because ``k/Cum`` grows within a chunk (ROADMAP
C11); float64 meets both.  The 3xTF32 form (hi + lo split, three TF32
products) meets both here too, but that emulation sums in float32 rounded
to nearest, and on the card the same form failed: 1.26x the allowance on
the model's first layer (PERF.md §6, B7), whose outputs cancel
terms of the state's size (|S| to 766 there, 43 here) while the tensor
core truncates its float32 sums.  So a pass of this emulation does not
clear a float32 tensor-core route; the kernel takes float64.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.kernel_chunked import rwkv6_chunked as j_chunked
from repro.kernels.rwkv6_scan.ref import reference_rwkv6 as j_ref

from repro_torch.kernels.rwkv6_scan.ref import (chunk_products,
                                                reference_rwkv6_chunked)
from test_torch_flash_precision import mm_3xtf32, mm_tf32

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card's tolerance and its rule)

TIGHT = dict(rtol=2e-5, atol=2e-5)
LOOP = 2e-3
ATOL = chip_smoke.MODEL_TOL["rwkv6_chunked"]


def rwkv_lm_decays(rng, shape):
    """Decays across RWKV-LM's RWKV-v6 initialisation, ``exp(-exp(w0))``
    for ``w0`` from -6 to -1 over the channels, jittered per token and
    kept in its 0.69-0.9975 spread."""
    n = shape[-1]
    w0 = -6.0 + 5.0 * (np.arange(n) / (n - 1)) ** 0.7
    w = np.exp(-np.exp(w0 + 0.3 * rng.standard_normal(shape)))
    return np.clip(w, np.exp(-np.exp(-1.0)), np.exp(-np.exp(-6.0))).astype(
        np.float32)


def _inputs(seed, bh, t, n, *, heads=None, decay="spread", state=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, t, n)).astype(np.float32)
               for _ in range(3))
    if decay == "spread":
        w = rwkv_lm_decays(rng, (bh, t, n))
    else:          # C11's edge: a 32-token product near float32's 1e-38
        w = rng.uniform(0.1, 0.12, (bh, t, n)).astype(np.float32)
    u = (rng.standard_normal((n,) if heads is None else (heads, n)) * 0.1
         ).astype(np.float32)
    s0 = (rng.standard_normal((bh, n, n)) * 0.5).astype(np.float32) \
        if state else None
    return r, k, v, w, u, s0


def _loop(r, k, v, w, u, s0):
    """The JAX token loop, head by head when ``u`` is per head."""
    bh, t, n = r.shape
    if u.ndim == 1:
        o, s = j_ref(*(jnp.asarray(z) for z in (r, k, v, w, u)),
                     state=None if s0 is None else jnp.asarray(s0),
                     return_state=True)
        return np.asarray(o), np.asarray(s)
    o = np.zeros((bh, t, n), np.float32)
    s = np.zeros((bh, n, n), np.float32)
    for h in range(u.shape[0]):
        rows = np.arange(h, bh, u.shape[0])
        oh, sh = _loop(r[rows], k[rows], v[rows], w[rows], u[h],
                       None if s0 is None else s0[rows])
        o[rows], s[rows] = oh, sh
    return o, s


def _share(got, want, rtol, atol):
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (rtol * want.abs() + atol)).max())


CASES = {
    "ragged T": dict(bh=2, t=77, n=64),
    "state in and out": dict(bh=3, t=64, n=32, state=True),
    "per-head u": dict(bh=4, t=96, n=64, heads=2, state=True),
    "one chunk": dict(bh=2, t=20, n=32, heads=2),
    "C11's edge": dict(bh=2, t=64, n=32, decay="edge", state=True),
}


@pytest.mark.parametrize("case", CASES)
def test_route_matches_pallas_and_loop(case):
    kw = dict(CASES[case])
    bh, t, n = kw.pop("bh"), kw.pop("t"), kw.pop("n")
    r, k, v, w, u, s0 = _inputs(len(case) + t, bh, t, n, **kw)
    tr = [torch.from_numpy(z) for z in (r, k, v, w, u)]
    ts0 = None if s0 is None else torch.from_numpy(s0)
    o, s = chunk_products(*tr, state=ts0, return_state=True)
    assert o.shape == (bh, t, n) and s.shape == (bh, n, n)
    lo, ls = _loop(r, k, v, w, u, s0)
    np.testing.assert_allclose(o.numpy(), lo, rtol=LOOP, atol=LOOP)
    np.testing.assert_allclose(s.numpy(), ls, rtol=LOOP, atol=LOOP)
    if u.ndim == 1 and s0 is None:
        want = j_chunked(*(jnp.asarray(z) for z in (r, k, v, w, u)),
                         interpret=True)
        np.testing.assert_allclose(o.numpy(), np.asarray(want), **TIGHT)
    po, ps = reference_rwkv6_chunked(*tr, state=ts0, return_state=True)
    torch.testing.assert_close(o, po, **TIGHT)
    torch.testing.assert_close(s, ps, **TIGHT)


def test_route_matches_pallas_on_a_single_bonus():
    r, k, v, w, u, _ = _inputs(5, 3, 100, 64)
    o = chunk_products(*(torch.from_numpy(z) for z in (r, k, v, w, u)),
                     chunk=16)
    want = j_chunked(*(jnp.asarray(z) for z in (r, k, v, w, u)), chunk=16,
                     interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **TIGHT)


def test_route_takes_bf16_rkv():
    r, k, v, w, u, s0 = _inputs(6, 4, 70, 64, heads=2, state=True)
    rb, kb, vb = (torch.from_numpy(z).to(torch.bfloat16) for z in (r, k, v))
    o, s = chunk_products(rb, kb, vb, torch.from_numpy(w), torch.from_numpy(u),
                        state=torch.from_numpy(s0), return_state=True)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    lo, ls = _loop(*(z.float().numpy() for z in (rb, kb, vb)), w, u, s0)
    torch.testing.assert_close(o.float(), torch.from_numpy(lo),
                               rtol=LOOP + 2.0 ** -7, atol=LOOP)
    torch.testing.assert_close(s, torch.from_numpy(ls), rtol=LOOP, atol=LOOP)


def test_route_with_no_steps_passes_the_state_through():
    r, k, v, w, u, s0 = _inputs(7, 2, 0, 32, state=True)
    o, s = chunk_products(*(torch.from_numpy(z) for z in (r, k, v, w, u)),
                        state=torch.from_numpy(s0), return_state=True)
    assert o.shape == (2, 0, 32) and torch.equal(s, torch.from_numpy(s0))


def mm_f64(a, b):
    """The FP64 tensor cores: float32 operands, float64 products and sums."""
    return a.double() @ b.double()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_one_tf32_product_misses_the_tolerance_float64_meets_it(dtype):
    """An RWKV6-3B prefill's rows (64 channels, 512 tokens in chunks of 32,
    RWKV-LM's decays, a state in): the kernel's route with its products
    taken as the tensor cores take them, against the plain version
    (float32 products), per element ``|err| <= rtol·|plain| + atol``.
    The 3xTF32 emulation's pass is kept as read: the card failed that form
    (see the module doc), so it stands beside the float64 route the kernel
    takes, not in its place."""
    r, k, v, w, u, s0 = _inputs(8, 8, 512, 64, heads=4, state=True)
    rkv = [torch.from_numpy(z).to(dtype) for z in (r, k, v)]
    ins = (*rkv, torch.from_numpy(w), torch.from_numpy(u))
    s0 = torch.from_numpy(s0)
    po, ps = reference_rwkv6_chunked(*ins, state=s0, return_state=True)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    shares = {}
    for name, mm in (("tf32", mm_tf32), ("3xtf32", mm_3xtf32),
                     ("f64", mm_f64)):
        o, s = chunk_products(*ins, state=s0, return_state=True, mm=mm)
        shares[name] = (_share(o, po, rtol, ATOL), _share(s, ps, 0.0, ATOL))
    assert shares["tf32"][1] > 3.0, shares              # the state misses
    # float64 meets both; a bf16 output that rounds the other way across a
    # rounding boundary takes up to one ulp, nearly all its allowance
    assert shares["f64"][0] <= 1.0 and shares["f64"][1] <= 0.5, shares
    # rounded float32 sums: within the allowance here, 1.26x on the card
    assert max(shares["3xtf32"]) <= 1.0, shares
