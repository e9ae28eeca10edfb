"""Kernels B3, B5, B6 and B7 as custom operators (``torch.ops.repro_torch``):
what a fake trace of the card's step passes through.  On fake CUDA, fake
CPU and ``meta`` tensors each output's shape, dtype and stride equal the
plain version's on real CPU tensors (the CPU implementation, which is
bitwise the plain version), the in-place forms return the state tensor
they were given, ``torch.library.opcheck`` passes on CPU inputs,
``FlopCounterMode`` reports each kernel's operation count and no call
moves a launch counter (only a launch on the card does)."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.flash_attention import kernel as b3
from repro_torch.kernels.flash_attention.ref import reference_attention
from repro_torch.kernels.mamba_scan import kernel as b5
from repro_torch.kernels.mamba_scan.ref import reference_mamba
from repro_torch.kernels.rwkv6_scan import kernel as b6
from repro_torch.kernels.rwkv6_scan import kernel_chunked as b7
from repro_torch.kernels.rwkv6_scan.ref import (reference_rwkv6,
                                                reference_rwkv6_chunked)


def _inputs(seed, *shapes, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in shapes]


def _mamba_inputs(t, state=True):
    x, dt, b, c, a, d, s = _inputs(1, (2, t, 16), (2, t, 16), (2, t, 4),
                                   (2, t, 4), (16, 4), (16,), (2, 16, 4))
    dt = torch.nn.functional.softplus(dt) * 0.1
    a = -torch.nn.functional.softplus(a) - 0.2
    return (x, dt, b, c, a, d), (s if state else None)


def _rwkv_inputs(t):
    r, k, v, w, u, s = _inputs(2, (4, t, 32), (4, t, 32), (4, t, 32),
                               (4, t, 32), (2, 32), (4, 32, 32))
    return (r, k * 0.3, v, torch.sigmoid(w) * 0.5 + 0.45, u * 0.1), s


def _b3(q_shape, k_shape, dtype=torch.float32, **opts):
    def make():
        q, k, v = _inputs(0, q_shape, k_shape, k_shape, dtype=dtype)
        return (q, k, v), opts
    return make


#: name -> (its inputs and keywords, the public wrapper, the plain version)
CASES = {
    "b3_causal": (_b3((2, 4, 16, 32), (2, 2, 16, 32)), b3.flash_attention,
                  reference_attention),
    "b3_window_softcap": (_b3((1, 4, 24, 64), (1, 1, 24, 64), window=5,
                              softcap=20.0), b3.flash_attention,
                          reference_attention),
    "b3_cross": (_b3((2, 2, 8, 32), (2, 2, 12, 32), causal=False),
                 b3.flash_attention, reference_attention),
    "b3_decode": (_b3((2, 4, 1, 32), (2, 2, 16, 32), causal=False),
                  b3.flash_attention, reference_attention),
    "b3_bf16": (_b3((1, 2, 16, 32), (1, 2, 16, 32), dtype=torch.bfloat16),
                b3.flash_attention, reference_attention),
}


def _mamba_case(t, mode):
    def make():
        ins, s = _mamba_inputs(t, state=mode != "plain")
        kw = {}
        if mode == "state":
            kw = dict(state=s, return_state=True)
        elif mode == "in_place":
            kw = dict(state=s, out_state=s)
        return ins, kw
    return make


def _rwkv_case(t, mode, chunked=False):
    def make():
        ins, s = _rwkv_inputs(t)
        kw = {"state": s, "return_state": True}
        if mode == "in_place":
            kw = {"state": s, "out_state": s}
        if chunked:
            kw["chunk"] = 32
        return ins, kw
    return make


def _plain_mamba(*ins, state=None, return_state=False, out_state=None):
    return reference_mamba(*ins, state=state, return_state=return_state
                           or out_state is not None)


def _plain_rwkv(*ins, state=None, return_state=False, out_state=None):
    return reference_rwkv6(*ins, state=state, return_state=return_state
                           or out_state is not None)


def _plain_chunked(*ins, chunk=32, state=None, return_state=False):
    return reference_rwkv6_chunked(*ins, chunk=chunk, state=state,
                                   return_state=return_state)


CASES.update({
    "b5_plain": (_mamba_case(12, "plain"), b5.mamba_scan, _plain_mamba),
    "b5_state": (_mamba_case(12, "state"), b5.mamba_scan, _plain_mamba),
    "b5_in_place": (_mamba_case(1, "in_place"), b5.mamba_scan,
                    _plain_mamba),
    "b6_state": (_rwkv_case(8, "state"), b6.rwkv6_scan, _plain_rwkv),
    "b6_decode_in_place": (_rwkv_case(1, "in_place"), b6.rwkv6_scan,
                           _plain_rwkv),
    "b7_state": (_rwkv_case(40, "state", chunked=True), b7.rwkv6_chunked,
                 _plain_chunked),
})


def _launches():
    return {**b3.LAUNCHES, **b5.LAUNCHES, **b6.LAUNCHES, **b7.LAUNCHES}


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def _on(device, t):
    """``t``'s shape, dtype and strides on ``device`` (no values)."""
    if t is None:
        return None
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=device)


def _call(fn, ins, kw, device):
    """``fn`` on tensors like ``ins`` and ``kw``'s on ``device``, an
    ``out_state`` that is ``state`` kept the same tensor."""
    args = [_on(device, t) for t in ins]
    kwargs = {k: _on(device, v) if isinstance(v, torch.Tensor) else v
              for k, v in kw.items()}
    if kw.get("out_state") is not None and kw["out_state"] is kw["state"]:
        kwargs["out_state"] = kwargs["state"]
    return fn(*args, **kwargs), kwargs


@pytest.mark.parametrize("case", CASES)
def test_cpu_operator_is_the_plain_version_bitwise(case):
    make, fn, plain = CASES[case]
    ins, kw = make()
    before = _launches()
    want = _outs(plain(*[t.clone() for t in ins], **{
        k: v.clone() if isinstance(v, torch.Tensor) else v
        for k, v in kw.items()}))
    got = _outs(fn(*ins, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    if kw.get("out_state") is not None:
        assert got[1] is kw["out_state"]
    assert _launches() == before


@pytest.mark.parametrize("where", ["fake_cuda", "fake_cpu", "meta"])
@pytest.mark.parametrize("case", CASES)
def test_fake_outputs_are_the_plain_versions_shapes(case, where):
    make, fn, _ = CASES[case]
    ins, kw = make()
    before = _launches()
    want = [(t.shape, t.dtype, t.stride()) for t in _outs(fn(*ins, **kw))]
    if where == "meta":
        got, kwargs = _call(fn, ins, kw, "meta")
    else:
        with FakeTensorMode():
            got, kwargs = _call(fn, ins, kw, where.split("_")[1])
    got = _outs(got)
    assert [(t.shape, t.dtype, t.stride()) for t in got] == want
    device = "meta" if where == "meta" else where.split("_")[1]
    assert all(t.device.type == device for t in got)
    if kw.get("out_state") is not None:
        assert got[1] is kwargs["out_state"] is kwargs["state"]
    assert _launches() == before


def _op_args(case):
    """The operator and its positional arguments for ``case``."""
    make, fn, _ = CASES[case]
    ins, kw = make()
    ops = torch.ops.repro_torch
    if fn is b3.flash_attention:
        q, k, v = ins
        return ops.flash_attention, (q, k, v, kw.get("causal", True),
                                     kw.get("window"), kw.get("softcap"),
                                     1.0 / q.shape[3] ** 0.5)
    s = kw.get("state")
    if fn is b5.mamba_scan:
        if "out_state" in kw:
            return ops.mamba_scan_, (*ins, s, s.clone())
        return ops.mamba_scan, (*ins, s, bool(kw.get("return_state")))
    if fn is b6.rwkv6_scan:
        if "out_state" in kw:
            return ops.rwkv6_scan_, (*ins, s, s.clone())
        return ops.rwkv6_scan, (*ins, s, True)
    return ops.rwkv6_chunked, (*ins, s, kw["chunk"], True)


@pytest.mark.parametrize("case", ["b3_causal", "b3_window_softcap",
                                  "b5_state", "b5_in_place", "b6_state",
                                  "b6_decode_in_place", "b7_state"])
def test_opcheck_on_cpu(case):
    op, args = _op_args(case)
    before = _launches()
    torch.library.opcheck(op, args)
    assert _launches() == before


def _formula(case, kw, ins):
    if case.startswith("b3"):
        q, k, _ = ins
        ops = b3.attention_ops(tuple(q.shape), tuple(k.shape),
                               kw.get("causal", True), kw.get("window"),
                               kw.get("softcap"))
        return 2 * ops["macs"] + ops["float32"]
    if case.startswith("b5"):
        x, _, b = ins[:3]
        return sum(b5.mamba_ops(*x.shape, b.shape[-1]).values())
    if case.startswith("b6"):
        return sum(b6.rwkv6_ops(*ins[0].shape).values())
    ops = b7.chunked_ops(*ins[0].shape, kw["chunk"])
    return 2 * ops["tensor_f64"] + ops["float32"]


@pytest.mark.parametrize("where", ["cpu", "meta"])
@pytest.mark.parametrize("case", CASES)
def test_flop_counter_reports_the_formula(case, where):
    make, fn, _ = CASES[case]
    ins, kw = make()
    with FlopCounterMode(display=False) as fc:
        _call(fn, ins, kw, where) if where == "meta" else fn(*ins, **kw)
    want = _formula(case, kw, ins)
    assert want > 0
    assert fc.get_total_flops() == want


def test_attention_pairs_count_the_computed_pairs():
    """A causal row sees its own and the earlier keys; a window row the
    last ``window`` of them; a row with none visits every key."""
    assert b3.attention_pairs(4, 4, True, None) == 1 + 2 + 3 + 4
    assert b3.attention_pairs(4, 6, False, None) == 24
    assert b3.attention_pairs(5, 5, True, 2) == 1 + 2 + 2 + 2 + 2
    assert b3.attention_pairs(1, 7, False, None) == 7


def test_fake_cuda_refuses_what_the_kernel_refuses():
    """A fake trace of the card's step stops where the card would: a head
    dim the kernel is not built for, a chunk above B7's."""
    with FakeTensorMode():
        q = torch.empty(1, 2, 8, 48, device="cuda")
        with pytest.raises(ValueError, match="head dim 48"):
            b3.flash_attention(q, q, q)
        r = torch.empty(2, 64, 32, device="cuda")
        u = torch.empty(32, device="cuda")
        with pytest.raises(ValueError, match="chunk 64"):
            b7.rwkv6_chunked(r, r, r, r, u, chunk=64)
        # the CPU's fake tensors take what the plain version takes
        qc = torch.empty(1, 2, 8, 48)
        assert b3.flash_attention(qc, qc, qc).shape == qc.shape
