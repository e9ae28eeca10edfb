"""B5's route on the CPU: ``ref.py:route_mamba``, the Mamba-scan kernel's
operations in the kernel's order (the decay as ``exp2`` of A pre-scaled
by log2(e) in float32, FMAs where the kernel fuses, each lane's partial
output summed over its states, the lanes' sums added in lane order), held
against the JAX package's ``reference_mamba`` and its Pallas
``mamba_scan`` in interpret mode on the same numpy inputs.

Tolerance: the reference's own scan tolerance, |err| <= 3e-4 (float32
sums in other orders, and a decay computed as ``2^(dt·A·log2 e)``: one
more float32 rounding of the exponent, a relative 1e-7 on each decay);
bfloat16 outputs may differ by one bf16 ulp beyond that (both sides
compute in float32 and round once), so rtol 2^-7 for them, as the card
checks use.  Every layout ``tools/mamba_layouts.py`` times at d_state 16
(16x1, 8x2, 4x4, 2x8, 1x16 lanes x states) and the layout the kernel
takes for each d_state bucket are emulated.  The kernel itself is held
to its plain version and to this route on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.kernel import mamba_scan as j_mamba_scan
from repro.kernels.mamba_scan.ref import reference_mamba as j_mamba_ref
from repro_torch.kernels.mamba_scan import kernel as mk
from repro_torch.kernels.mamba_scan.ref import reference_mamba, route_mamba

SCAN_ATOL = 3e-4
BF16_RTOL = 2.0 ** -7


def _inputs(seed, b, t, di, ds):
    """Jamba-like inputs as ``chip_smoke.py`` draws them: dt a softplus
    times 0.1, A = -softplus - 0.2."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def softplus(z):
        return np.logaddexp(0.0, z).astype(np.float32)

    return (normal(b, t, di), softplus(normal(b, t, di)) * np.float32(0.1),
            normal(b, t, ds), normal(b, t, ds),
            -softplus(normal(di, ds)) - np.float32(0.2), normal(di))


def _check(got, *wants, rtol=0.0):
    got = np.asarray(got, np.float64)
    for want in wants:
        want = np.asarray(want, np.float64)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=rtol, atol=SCAN_ATOL)


def _against_jax(ins, lanes, spl, chunk=64, dtype=torch.float32):
    tins = [torch.from_numpy(z).to(dtype) for z in ins]
    got = route_mamba(*tins, lanes=lanes, spl=spl)
    assert got.dtype == dtype
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jins = [jnp.asarray(z).astype(jdt) for z in ins]
    want_ref = j_mamba_ref(*jins)
    want_kernel = j_mamba_scan(*jins, chunk=chunk, interpret=True)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    _check(got.float(), np.asarray(want_ref, np.float32),
           np.asarray(want_kernel, np.float32), rtol=rtol)
    return got


#: every (lanes, states a lane) tools/mamba_layouts.py times at d_state 16
#: (the kernel takes 4 x 4; the channels a thread holds change no
#: operation's order)
D16_LAYOUTS = [(16, 1), (8, 2), (4, 4), (2, 8), (1, 16)]


@pytest.mark.parametrize("lanes,spl", D16_LAYOUTS)
def test_jamba_width_slice(lanes, spl):
    """Jamba-v0.1's d_state 16 and 4096-token rows, d_inner 8192 cut to 256
    channels and T to 1024, one batch row."""
    _against_jax(_inputs(1, 1, 1024, 256, 16), lanes, spl)


@pytest.mark.parametrize("ds", [1, 4, 5, 8, 16, 24, 32, 64])
def test_default_layout_of_each_d_state(ds):
    """The layout :func:`kernel.layout` gives each d_state, on a T (100)
    that is not a multiple of the kernel's 32-step tile, ragged channels
    (70) and two batch rows."""
    lanes, spl = mk.layout(ds)
    assert spl in (2, 4) and lanes * spl >= ds > (lanes - 1) * spl
    _against_jax(_inputs(ds, 2, 100, 70, ds), lanes, spl, chunk=32)


@pytest.mark.parametrize("ds,t", [(5, 37), (64, 70), (16, 33)])
def test_odd_shapes(ds, t):
    """d_state 5 (padded to 8 states) and 64 (4 lanes of 16), T of 37, 70
    and 33: the last tile partial, T shorter than the TPU kernel's chunk."""
    lanes, spl = mk.layout(ds)
    _against_jax(_inputs(100 + ds, 1, t, 48, ds), lanes, spl)


@pytest.mark.parametrize("lanes,spl", [(1, 16), (4, 4)])
def test_bfloat16(lanes, spl):
    """bfloat16 inputs and output: each side widens, computes in float32
    and rounds y once."""
    _against_jax(_inputs(7, 2, 80, 64, 16), lanes, spl,
                 dtype=torch.bfloat16)


def test_route_is_the_plain_version_within_the_tolerance():
    """The route and the port's plain version (the loop the CPU runs and the
    card checks against) on the same inputs."""
    ins = [torch.from_numpy(z) for z in _inputs(3, 2, 200, 64, 16)]
    lanes, spl = mk.layout(16)
    _check(route_mamba(*ins, lanes=lanes, spl=spl),
           reference_mamba(*ins).numpy())


def test_layout_table():
    assert mk.layout(16) == (4, 4)
    assert mk.layout(5) == (2, 4)
    assert mk.layout(3) == (1, 4)
    assert mk.layout(2) == (1, 2)
    assert mk.layout(1) == (1, 2)
    assert mk.layout(64) == (16, 4)
    for bad in (0, 65):
        with pytest.raises(ValueError, match="d_state"):
            mk.layout(bad)


def test_cpu_takes_the_plain_version_and_checks_a_layout():
    """On CPU tensors the wrapper runs ``reference_mamba`` and counts no
    launch, also for a d_state the kernel has no layout for."""
    before = mk.LAUNCHES["mamba_scan"]
    for ds in (8, 65):
        ins = [torch.from_numpy(z) for z in _inputs(4, 1, 40, 32, ds)]
        assert torch.equal(mk.mamba_scan(*ins), reference_mamba(*ins))
    with pytest.raises(ValueError, match="d_state"):
        mk.layout(65)
    assert mk.LAUNCHES["mamba_scan"] == before
