"""Selective state-space (Mamba) scan in CUDA C++ — kernel B5, the Hopper
port of ``repro/kernels/mamba_scan/kernel.py:mamba_scan``.

The kernel is ``src/repro_torch/csrc/mamba_scan.cu`` (its header says what
bounds it and how it is laid out): one loop over T inside each block, work
split over (batch, channel, state), a thread holding 2 channels x ``spl``
states in float32 registers (``lanes`` threads a channel, 64 channels a
block), the decay as one ``ex2`` of a pre-scaled A, x/dt/B/C tiles
streamed into shared memory by ``cp.async`` while the scan runs, and the
lanes' partial outputs summed once a tile.  :func:`layout` picks
``lanes`` and ``spl`` for each ``d_state``.  The state may start from a
given one and its final value may be written out, over the initial one
in place if asked (``out_state=state``, as a served decode step's static
cache has it).  It is built by :mod:`..cuda_build` at first use.

It runs as two custom operators, ``torch.ops.repro_torch.mamba_scan``
(:func:`scan_op`) and its in-place form ``mamba_scan_`` (:func:`scan_op_`,
which writes the final state into ``out_state``), whose implementation the
dispatcher picks by the tensors' device: the kernel on CUDA tensors (it
launches or raises), the plain version (``ref.py:reference_mamba``;
``ref.py:route_mamba`` emulates the kernel's roundings) on CPU tensors,
and on fake or ``meta`` tensors a fake one that makes the outputs' shapes,
dtypes and strides and, on fake CUDA tensors, refuses what the kernel
refuses.  Its operation count (:func:`mamba_ops`) is both its FLOP formula
and the work ``chip_smoke.py``'s bound reads.

Its backward is a third operator, ``torch.ops.repro_torch.
mamba_scan_backward`` (:func:`backward_op`): on CPU and CUDA tensors alike
the plain backward (autograd through ``reference_mamba``, as the
reference's is ``jax.vjp`` of its reference), no kernel; on fake tensors
the gradients and a buffer of the plain backward's peak temporaries
(:func:`backward_work`), so a traced step passes it as one operation, not
as the plain loop's ops token by token.  Its operation count is
:func:`mamba_backward_ops`.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from ...core.device import op_device
from .. import cuda_build
from .ref import reference_mamba

MAX_STATE = 64                      # the widest d_state the kernel holds
DTYPES = (torch.float32, torch.bfloat16)


def layout(d_state: int) -> tuple:
    """``(lanes, spl)`` of the kernel for ``d_state``: ``lanes`` threads a
    channel, each holding ``spl`` of its states — 4 (2 for a d_state of 1
    or 2), the fastest of ``tools/mamba_layouts.py``'s sweep on an H100 —
    and as few lanes as cover ``d_state``."""
    if not 1 <= d_state <= MAX_STATE:
        raise ValueError(f"mamba_scan: d_state {d_state} (the kernel holds "
                         f"1 to {MAX_STATE})")
    spl = 2 if d_state <= 2 else 4
    return -(-d_state // spl), spl


#: launches of the kernel (one per call on CUDA tensors); reset it to 0 to
#: count the launches of one run
LAUNCHES = {"mamba_scan": 0}


def mamba_scan(x, dt, b, c, a, d, *, chunk: int = 64, state=None,
               return_state: bool = False, out_state=None):
    """x, dt: ``(B, T, d_inner)``; b, c: ``(B, T, d_state)``; a: ``(d_inner,
    d_state)``; d: ``(d_inner,)``.  Returns y: ``(B, T, d_inner)`` in
    ``x.dtype``, and with ``return_state`` the final float32 ``(B,
    d_inner, d_state)`` state too; ``state`` is the initial one (zeros
    when None; float32 on the card).  ``out_state``: a float32 ``(B,
    d_inner, d_state)`` tensor the final state is written into and
    returned as (it may be ``state`` itself, updated in place); implies
    ``return_state``.  ``chunk`` is the TPU kernel's sequence tile: it must
    be positive and changes nothing else, as there."""
    bsz, t, d_inner = x.shape
    d_state = b.shape[-1]
    hs = (bsz, d_inner, d_state)
    if dt.shape != x.shape or b.shape != (bsz, t, d_state) \
            or c.shape != b.shape or a.shape != (d_inner, d_state) \
            or d.shape != (d_inner,) \
            or (state is not None and state.shape != hs) \
            or (out_state is not None and out_state.shape != hs):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, b "
            f"{tuple(b.shape)}, c {tuple(c.shape)}, a {tuple(a.shape)}, d "
            f"{tuple(d.shape)}, state "
            f"{None if state is None else tuple(state.shape)}, out_state "
            f"{None if out_state is None else tuple(out_state.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk {chunk}")
    ins = {"x": x, "dt": dt, "b": b, "c": c, "a": a, "d": d}
    states = {k: v for k, v in (("state", state), ("out_state", out_state))
              if v is not None}
    op_device({**ins, **states}, "mamba_scan")
    if out_state is not None:
        return scan_op_(x, dt, b, c, a, d, state, out_state), out_state
    y, h = scan_op(x, dt, b, c, a, d, state, return_state)
    return (y, h) if return_state else y


def _refuse(x, dt, b, c, a, d, state, out_state) -> None:
    """Raise for what the kernel does not take (on the card and in a fake
    trace of it): inputs not contiguous or not of one dtype of
    :data:`DTYPES`, states that are not float32 and contiguous, a
    ``d_state`` above :data:`MAX_STATE`."""
    cuda_build.require({"x": x, "dt": dt, "b": b, "c": c, "a": a, "d": d},
                       DTYPES, "mamba_scan")
    states = {k: v for k, v in (("state", state), ("out_state", out_state))
              if v is not None}
    if states:
        cuda_build.require(states, (torch.float32,), "mamba_scan")
    layout(b.shape[-1])


def _launch(x, dt, b, c, a, d, state, h_out):
    """Launch the kernel: y returned, the final state written into
    ``h_out`` when it is not None."""
    _refuse(x, dt, b, c, a, d, state, h_out)
    bsz, t, d_inner = x.shape
    d_state = b.shape[-1]
    lanes, spl = layout(d_state)
    y = torch.empty_like(x)
    if y.numel() == 0:            # no step to take: h_T is h_0
        if h_out is not None and state is not None:
            h_out.copy_(state)
        elif h_out is not None:
            h_out.zero_()
        return y
    cuda_build.launch(
        "repro_mamba_scan_fwd", "pppppppppiiiiiiip",
        [x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
         a.data_ptr(), d.data_ptr(),
         None if state is None else state.data_ptr(),
         None if h_out is None else h_out.data_ptr(), y.data_ptr(),
         cuda_build.DTYPE_CODES[x.dtype], bsz, t, d_inner, d_state, lanes,
         spl], x.device)
    LAUNCHES["mamba_scan"] += 1
    return y


def _plain(x, dt, b, c, a, d, state):
    """The plain version's y (contiguous) and final state (never one of
    the inputs' tensors)."""
    y, h = reference_mamba(x, dt, b, c, a, d, state=state, return_state=True)
    if state is not None and h is state:      # no step: h_T is h_0
        h = h.clone()
    return y.contiguous(), h


@torch.library.custom_op("repro_torch::mamba_scan", mutates_args=(),
                         device_types="cpu")
def scan_op(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
            state: Optional[torch.Tensor],
            return_state: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator: ``(y, final state)``, the state an empty ``(0,)``
    tensor unless ``return_state``; on CPU tensors the plain version."""
    y, h = _plain(x, dt, b, c, a, d, state)
    return y, h if return_state else h.new_empty((0,))


@scan_op.register_kernel("cuda")
def _scan_cuda(x, dt, b, c, a, d, state, return_state):
    h_out = torch.empty((x.shape[0], x.shape[2], b.shape[-1]),
                        dtype=torch.float32, device=x.device) \
        if return_state else None
    y = _launch(x, dt, b, c, a, d, state, h_out)
    return y, h_out if return_state else y.new_empty((0,), dtype=torch.float32)


@scan_op.register_fake
def _scan_fake(x, dt, b, c, a, d, state, return_state):
    if x.device.type == "cuda":
        _refuse(x, dt, b, c, a, d, state, None)
    hs = (x.shape[0], x.shape[2], b.shape[-1]) if return_state else (0,)
    return x.new_empty(x.shape), x.new_empty(hs, dtype=torch.float32)


@torch.library.custom_op("repro_torch::mamba_scan_",
                         mutates_args=("out_state",), device_types="cpu")
def scan_op_(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
             state: Optional[torch.Tensor],
             out_state: torch.Tensor) -> torch.Tensor:
    """The in-place operator: y, the final state written into
    ``out_state`` (which may be ``state``); on CPU tensors the plain
    version."""
    y, h = _plain(x, dt, b, c, a, d, state)
    out_state.copy_(h)
    return y


@scan_op_.register_kernel("cuda")
def _scan_cuda_(x, dt, b, c, a, d, state, out_state):
    return _launch(x, dt, b, c, a, d, state, out_state)


@scan_op_.register_fake
def _scan_fake_(x, dt, b, c, a, d, state, out_state):
    if x.device.type == "cuda":
        _refuse(x, dt, b, c, a, d, state, out_state)
    return x.new_empty(x.shape)


def mamba_ops(bsz, t, d_inner, d_state) -> dict:
    """B5's operations: per (token, channel, state) one exponential and 4
    float32 operations (dt·A', dx·B, the state's FMA, h·C's FMA); per
    (token, channel) dt·x and D·x."""
    return {"float32": bsz * t * d_inner * (4 * d_state + 2),
            "exp2": bsz * t * d_inner * d_state}


@register_flop_formula([torch.ops.repro_torch.mamba_scan,
                        torch.ops.repro_torch.mamba_scan_])
def scan_flops(x_shape, dt_shape, b_shape, *args, out_shape=None,
               **kw) -> int:
    """FLOPs of one call: :func:`mamba_ops`' operations, one each."""
    bsz, t, d_inner = x_shape
    return sum(mamba_ops(bsz, t, d_inner, b_shape[-1]).values())


def mamba_backward_ops(bsz, t, d_inner, d_state) -> dict:
    """The plain backward's operations (:func:`backward_op`): its forward
    recompute, per (token, channel, state) dt·A, the exponential, decay·h,
    dx·B, their sum and h·C's multiply-add (6 float32 and one exp), per
    (token, channel) dt·x, D·x and y's sum (3); then the VJP, per (token,
    channel, state) h's gradient from y and from the next token (3), C's,
    B's and dx's multiply-adds (6), the decay's and the exponent's
    products (2), dt's and A's multiply-adds (4), per (token, channel)
    dt's, x's and D's products and sums (6)."""
    return {"float32": bsz * t * d_inner * (21 * d_state + 9),
            "exp": bsz * t * d_inner * d_state}


def backward_work(bsz, t, d_inner, d_state) -> int:
    """float32 elements the plain backward holds at its peak besides the
    gradients it returns (measured with ``MemTracker``: within 10% on
    small shapes, ``tests/test_torch_dryrun_c31.py``): per (row, token)
    the decay and h, each ``d_inner × d_state``, that the recorded loop
    keeps for the VJP, and about 8 ``d_inner``-wide and 2
    ``d_state``-wide vectors (each token's dt·x and y, and the full-size
    gradient buffers each token's slice adds into)."""
    return bsz * t * (2 * d_inner * d_state + 8 * d_inner + 2 * d_state)


@contextlib.contextmanager
def _autograd():
    """Autograd inside an operator's implementation, which the dispatcher
    runs with the autograd keys excluded: the plain backward records and
    differentiates the plain version there."""
    keys = torch._C.DispatchKey
    ex = torch._C._dispatch_tls_local_exclude_set()
    for k in (keys.AutogradFunctionality, keys.AutogradOther,
              keys.AutogradNestedTensor):
        ex = ex.remove(k)
    with torch._C._ForceDispatchKeyGuard(
            torch._C._dispatch_tls_local_include_set(), ex), \
            torch.enable_grad():
        yield


def _plain_backward(x, dt, b, c, a, d, state, gy, gh):
    """The plain backward: autograd through ``reference_mamba`` from the
    outputs that have a gradient (y's, the final state's) and depend on
    an input (with no token, y does not); an input no such output depends
    on gets zeros."""
    with _autograd():
        ins = [z.detach().requires_grad_() for z in (x, dt, b, c, a, d)]
        st = None if state is None else state.detach().requires_grad_()
        outs = reference_mamba(*ins, state=st, return_state=True)
        pairs = [(o, g) for o, g in zip(outs, (gy, gh))
                 if g is not None and o.requires_grad]
        wrt = ins + ([] if st is None else [st])
        got = torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True, materialize_grads=True) if pairs \
            else [torch.zeros_like(z) for z in wrt]
    grads = [g.detach() for g in got]
    if state is None:
        grads.append(x.new_empty((0,), dtype=torch.float32))
    return grads


#: the backward operator's outputs: seven gradients and ``work``
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@torch.library.custom_op("repro_torch::mamba_scan_backward",
                         mutates_args=(), device_types=("cpu", "cuda"))
def backward_op(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                state: Optional[torch.Tensor], gy: Optional[torch.Tensor],
                gh: Optional[torch.Tensor]) -> Grads:
    """The gradients of x, dt, b, c, a, d and the initial state (an empty
    ``(0,)`` tensor without one) given y's gradient ``gy`` and the final
    state's ``gh`` (either may be None), then ``work``: a zeroed
    float32 buffer of the :func:`backward_work` elements the plain
    backward holds at its peak, made after its temporaries are freed, so
    that a trace on fake tensors (where nothing runs) sees that peak in
    the operator's outputs; the caller drops it at once."""
    grads = _plain_backward(x, dt, b, c, a, d, state, gy, gh)
    ins = [z for z in (x, dt, b, c, a, d, state, gy, gh)
           if z is not None and z.numel()]
    # no output may alias an input (with no token, the state's gradient
    # is ``gh`` itself)
    grads = [g.clone() if g.numel() and any(
        g.untyped_storage().data_ptr() == z.untyped_storage().data_ptr()
        for z in ins) else g for g in grads]
    return (*grads, _work(x, b))


def _work(x, b):
    return x.new_zeros((backward_work(x.shape[0], x.shape[1], x.shape[2],
                                      b.shape[-1]),), dtype=torch.float32)


@backward_op.register_fake
def _backward_fake(x, dt, b, c, a, d, state, gy, gh):
    grads = [z.new_empty(z.shape) for z in (x, dt, b, c, a, d)]
    grads.append(x.new_empty((0,), dtype=torch.float32) if state is None
                 else state.new_empty(state.shape))
    return (*grads, _work(x, b))


@register_flop_formula(torch.ops.repro_torch.mamba_scan_backward)
def backward_flops(x_shape, dt_shape, b_shape, *args, out_shape=None,
                   **kw) -> int:
    """FLOPs of one call: :func:`mamba_backward_ops`' operations, one
    each."""
    bsz, t, d_inner = x_shape
    return sum(mamba_backward_ops(bsz, t, d_inner, b_shape[-1]).values())
