"""The dry run's two repaired cells (ROADMAP C31) and B5's backward operator.

SMOKE Jamba-v0.1 ``train_4k`` traces over the fake group of 256 ranks on
the card's route (fake CPU tensors, as in ``test_torch_dryrun_traces.py``):
B5's backward is one operator, ``torch.ops.repro_torch.mamba_scan_backward``,
called once a Mamba layer and microbatch, where the trace used to record
the plain backward's loop token by token.  SMOKE OLMoE-1B-7B and
Qwen3-MoE-235B ``prefill_32k`` trace on this torch: the MoE layer's output
is regrouped on each rank's whole rows.  The operator's CPU gradients are
bitwise those of autograd through ``reference_mamba``, and its fake
implementation's temporaries stand within 10% of ``MemTracker``'s peak for
the plain backward on a small real shape.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker

from repro_torch import configs as PC
from repro_torch.kernels.mamba_scan import kernel as b5
from repro_torch.kernels.mamba_scan import ops as b5_ops
from repro_torch.kernels.mamba_scan.ref import reference_mamba
from repro_torch.launch import dryrun as D

from test_torch_dryrun_traces import check_cell

TRACES = [("jamba-v0.1-52b", "train_4k"), ("olmoe-1b-7b", "prefill_32k"),
          ("qwen3-moe-235b-a22b", "prefill_32k")]


@pytest.fixture(scope="module")
def traced():
    """The (16, 16) production mesh over a fake group of 256 ranks and
    the cells' records."""
    with D.fake_group(256):
        mesh = D.make_production_mesh(device="cpu")
        yield mesh, {cell: D.run_cell(PC.get_config(cell[0], smoke=True),
                                      cell[1], "single", out_dir=None,
                                      mesh=mesh, device="cpu")
                     for cell in TRACES}


@pytest.mark.parametrize("cell", TRACES, ids=["/".join(c) for c in TRACES])
def test_c31_cells_trace(traced, cell):
    mesh, recs = traced
    check_cell(mesh, cell, recs[cell])


def test_jamba_train_calls_b5_backward_once_a_layer_and_microbatch(traced):
    from repro_torch.launch.steps import _dp_total, microbatch_count
    mesh, recs = traced
    cfg = PC.get_config("jamba-v0.1-52b", smoke=True)
    shape = PC.SHAPES["train_4k"]
    n_micro = microbatch_count(cfg, shape.global_batch, shape.seq_len,
                               dp_total=_dp_total(mesh))
    layers = sum(m == "mamba" for m, _ in cfg.layer_pattern())
    calls = recs[("jamba-v0.1-52b", "train_4k")]["kernel_calls"]
    # the forward runs again under remat; the backward once
    assert calls["mamba_scan"] == layers * n_micro * (2 if cfg.remat else 1)
    assert calls["mamba_scan_backward"] == layers * n_micro


def _inputs(bsz, t, d_inner, d_state, dtype, with_state, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    ins = [rnd(bsz, t, d_inner), rnd(bsz, t, d_inner).abs() * 0.1,
           rnd(bsz, t, d_state), rnd(bsz, t, d_state),
           -rnd(d_inner, d_state).abs(), rnd(d_inner)]
    ins = [z.to(dtype) for z in ins]
    state = rnd(bsz, d_inner, d_state) if with_state else None
    gy = rnd(bsz, t, d_inner).to(dtype)
    gh = rnd(bsz, d_inner, d_state) if with_state else None
    return ins, state, gy, gh


def _plain_grads(ins, state, gy, gh):
    """Autograd through ``reference_mamba``: the backward before the
    operator, as ``ops._Mamba`` ran it."""
    ins = [z.detach().requires_grad_() for z in ins]
    st = None if state is None else state.detach().requires_grad_()
    with torch.enable_grad():
        outs = reference_mamba(*ins, state=st, return_state=st is not None)
    outs = outs if st is not None else (outs,)
    pairs = [(o, g) for o, g in zip(outs, (gy, gh)) if g is not None]
    wrt = ins + ([] if st is None else [st])
    return torch.autograd.grad([o for o, _ in pairs], wrt,
                               [g for _, g in pairs])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
def test_backward_op_is_bitwise_the_plain_backward(dtype, with_state):
    ins, state, gy, gh = _inputs(2, 9, 6, 4, dtype, with_state)
    want = _plain_grads(ins, state, gy, gh)
    leaves = [z.clone().requires_grad_() for z in ins]
    st = None if state is None else state.clone().requires_grad_()
    out = b5_ops.mamba(*leaves, state=st, return_state=with_state)
    outs = out if with_state else (out,)
    got = torch.autograd.grad(
        list(outs), leaves + ([] if st is None else [st]),
        [g for g in (gy, gh) if g is not None])
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the operator alone: the same gradients, and ``work`` of the plain
    # backward's peak (zeros, the shape its fake gives)
    *direct, gstate, work = b5.backward_op(*ins, state, gy, gh)
    for w, g in zip(want, direct + ([gstate] if with_state else [])):
        assert torch.equal(g, w)
    assert work.shape == (b5.backward_work(2, 9, 6, 4),) and not work.any()
    torch.library.opcheck(b5.backward_op, (*ins, state, gy, gh))


def _peak(fn) -> int:
    mt = MemTracker()
    with mt:
        fn()
    snap = mt.get_tracker_snapshot("peak")
    return sum(v for dev in snap.values() for k, v in dev.items()
               if k == "Total")


@pytest.mark.parametrize("shape", [(2, 64, 128, 16), (1, 128, 256, 8)],
                         ids=["2x64x128x16", "1x128x256x8"])
def test_fake_backward_holds_the_plain_backwards_peak(shape):
    """The fake operator's gradients and ``work`` against the peak of the
    plain backward (a forward recorded with autograd, then its gradients)
    that ``MemTracker`` sees on real tensors."""
    ins, state, gy, gh = _inputs(*shape, torch.float32, True)
    real = _peak(lambda: _plain_grads(ins, state, gy, gh))
    with FakeTensorMode() as fm:
        fake = [None if z is None else fm.from_tensor(z)
                for z in (*ins, state, gy, gh)]
        traced = _peak(lambda: b5.backward_op(*fake))
    assert abs(traced - real) <= 0.1 * real, (traced, real)
    bsz, t, d_inner, d_state = shape
    assert traced >= 4 * b5.backward_work(bsz, t, d_inner, d_state)
