"""Why flash attention (B3) on the card does three products where
FlashAttention does two: its roundings, emulated on the CPU.

``src/repro_torch/csrc/flash_attention.cu`` computes both products of
attention on the tensor cores.  Two roundings there would break the
tolerance the kernel is held to (``chip_smoke.py``: per element ``|err| <=
rtol·|plain| + atol``, atol ``MODEL_TOL["flash_attention"]`` = 2e-5, rtol
0 for float32 outputs and ``BF16_RTOL`` = 2^-7 for bfloat16 ones):

* float32 inputs through one TF32 product (operands rounded to 10 mantissa
  bits): the kernel splits each operand into TF32 hi + lo and sums lo·hi +
  hi·lo + hi·hi (3xTF32);
* bfloat16 inputs with P rounded once to bfloat16 for P·V, as FlashAttention
  does: the kernel splits P into bfloat16 hi + lo and multiplies V twice.

Each test makes its inputs with numpy from a seed, takes the JAX
package's ``reference_attention`` as the oracle, and computes attention in
plain PyTorch with the kernel's roundings of the operands (cvt.rna.tf32
for a TF32 hi, truncation for a lo, round-to-nearest-even for bfloat16)
and float32 sums: the
emulation keeps the operand roundings, which is where the forms differ,
and not the tensor cores' order of additions.
"""

import functools
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import reference_attention

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card's tolerance and its rule)

ATOL = chip_smoke.MODEL_TOL["flash_attention"]

#: the two cases: (heads, S, D, causal, window, softcap, dtype) — a
#: Qwen1.5-4B-like float32 prefill and a Gemma2-9B-like bf16 local layer,
#: cut to a CPU's size
CASES = {
    "f32": (4, 512, 128, True, None, None, torch.float32),
    "bf16": (2, 1024, 256, True, 512, 50.0, torch.bfloat16),
}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 register taken as a TF32
    operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    """The kernel's split: hi = tf32(x); lo = x - hi (exact in float32),
    which the tensor core truncates to TF32."""
    hi = tf32(x)
    return hi, tf32_truncated(x - hi)


def mm_f32(a, b):
    return a @ b


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def mm_3xtf32(a, b):
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def _masked_softmax_terms(s, causal, window, softcap):
    """Softcap, mask and the shifted exponentials of float32 scores
    ``(H, Sq, Sk)``, as the kernel computes them; returns (p, l)."""
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    sq, sk = s.shape[-2:]
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.tensor(-1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p, p.sum(-1, keepdim=True)


def attend_f32(q, k, v, mm, *, causal, window, softcap):
    """float32 attention with both products through ``mm``; q is scaled
    before the product, as the kernel does."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm(q * scale, k.transpose(-1, -2))
    p, l = _masked_softmax_terms(s, causal, window, softcap)
    return mm(p, v) / l.clamp_min(1e-30)


def attend_bf16(q, k, v, p_form, *, causal, window, softcap):
    """bfloat16 attention: exact bf16 x bf16 products summed in float32,
    the scale on the float32 scores, P into P·V either rounded once to
    bfloat16 (``"once"``) or split into bfloat16 hi + lo (``"split"``);
    the float32 result rounded once to bfloat16."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    s = (qf @ kf.transpose(-1, -2)) * scale
    p, l = _masked_softmax_terms(s, causal, window, softcap)
    hi = p.to(torch.bfloat16).float()
    if p_form == "once":
        o = hi @ vf
    else:
        lo = (p - hi).to(torch.bfloat16).float()
        o = lo @ vf + hi @ vf
    return (o / l.clamp_min(1e-30)).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def case(name):
    """Inputs (H, S, D) from a seed, and the JAX oracle's output."""
    heads, s, d, causal, window, softcap, dtype = CASES[name]
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.standard_normal((heads, s, d))
                                .astype(np.float32)).to(dtype)
               for _ in range(3))
    jx = [jnp.asarray(t.float().numpy()[None]).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        for t in (q, k, v)]
    want = reference_attention(*jx, causal=causal, window=window,
                               softcap=softcap)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))[0]).to(dtype)
    return (q, k, v), dict(causal=causal, window=window, softcap=softcap), \
        want


def share(name, got) -> float:
    """The largest share of chip_smoke's per-element allowance that any
    element of ``got`` takes against the oracle (at most 1 passes)."""
    _, _, want = case(name)
    rtol = chip_smoke.BF16_RTOL if got.dtype == torch.bfloat16 else 0.0
    return chip_smoke._hold(got, want, rtol, ATOL)[1]


@pytest.mark.parametrize("form,within", [
    ("f32", True),       # float32 products: the baseline
    ("tf32", False),     # one TF32 product: 10 mantissa bits
    ("3xtf32", True),    # the kernel's form
])
def test_float32_needs_3xtf32(form, within):
    (q, k, v), opts, _ = case("f32")
    mm = {"f32": mm_f32, "tf32": mm_tf32, "3xtf32": mm_3xtf32}[form]
    got = share("f32", attend_f32(q, k, v, mm, **opts))
    assert (got <= 1.0) == within, got
    if within:
        assert got < 0.5, got     # well inside, not at the edge


@pytest.mark.parametrize("p_form,within", [
    ("once", False),     # FlashAttention's one bf16 rounding of P
    ("split", True),     # the kernel's hi + lo
])
def test_bfloat16_needs_split_p(p_form, within):
    (q, k, v), opts, _ = case("bf16")
    got = share("bf16", attend_bf16(q, k, v, p_form, **opts))
    assert (got <= 1.0) == within, got


def test_tf32_split_keeps_float32():
    """hi + lo (lo as the tensor core reads it) gives x back within 2^-21
    of |x| where hi alone is off by up to 2^-11; hi is what cvt.rna.tf32
    gives (ties away from zero)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
    hi, lo = split_tf32(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    rel_hi = ((hi.double() - x.double()).abs() / x.double().abs()).max()
    rel = (((hi.double() + lo.double()) - x.double()).abs()
           / x.double().abs()).max()
    assert 2.0 ** -13 < rel_hi <= 2.0 ** -11
    assert rel <= 2.0 ** -21
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_float32_bound_counts_three_tf32_passes():
    """chip_smoke.py's attention bound counts a float32 product on the
    faster float32-accurate route, three TF32 tensor-core passes, and a
    bfloat16 product at the bf16 tensor-core rate (the Qwen1.5-4B and
    Gemma2-9B cases; shapes only, on the meta device)."""
    q = torch.empty((4, 20, 512, 128), device="meta")
    nbytes, ops = chip_smoke._attention_work(q, q, True, None, None)
    pairs = 4 * 20 * 512 * 513 // 2
    assert ops == {"tensor_3xtf32": 3 * 2 * 128 * pairs,
                   "float32": 4 * pairs}
    bound_ms, by = chip_smoke._bound(nbytes, ops)
    assert by == "operations"
    assert bound_ms == pytest.approx(3 * 2 * 128 * pairs
                                     / chip_smoke.TC_TF32_MACS_PER_S * 1e3)
    assert 0.0326 < bound_ms < 0.0327
    qb = torch.empty((1, 16, 8192, 256), device="meta", dtype=torch.bfloat16)
    kb = torch.empty((1, 8, 8192, 256), device="meta", dtype=torch.bfloat16)
    _, ops = chip_smoke._attention_work(qb, kb, True, 4096, 50.0)
    assert set(ops) == {"tensor_bf16", "float32"}
