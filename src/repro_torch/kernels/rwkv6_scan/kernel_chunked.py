"""The RWKV6 recurrence in chunks of 32 tokens in CUDA C++ — kernel B7,
the Hopper port of ``repro/kernels/rwkv6_scan/kernel_chunked.py:
rwkv6_chunked``.

The kernel is ``src/repro_torch/csrc/rwkv6_chunked.cu`` (its header says
what bounds it and how it is laid out): one launch, one block per (batch
x head row, tile of 32 state columns) walking the chunks in order with
its slice of the float32 state in shared memory; per chunk all four
products (the scores ``r̃k̃ᵀ``, masked, and their product with V, ``r̃S``
and the state contribution ``k̃ᵀV``) on the FP64 tensor cores
(``mma.sync`` m8n8k4: float32 operands, exact products, float64 sums),
``Cum``, ``r̃``, ``k̃``, the bonus diagonal and the state update in
float32.  It is built by :mod:`..cuda_build` at first use, with B6.

It runs as the custom operator ``torch.ops.repro_torch.rwkv6_chunked``
(:func:`chunked_op`), whose implementation the dispatcher picks by the
tensors' device: the kernel on CUDA tensors (it launches or raises), the
plain version (``ref.py:reference_rwkv6_chunked``, the same chunk algebra
in PyTorch) on CPU tensors, and on fake or ``meta`` tensors a fake one
that makes the outputs' shapes, dtypes and strides and, on fake CUDA
tensors, refuses what the kernel refuses.  Its operation count
(:func:`chunked_ops`) is both its FLOP formula and the work
``chip_smoke.py``'s bound reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import cuda_build
from .kernel import check_inputs, fake_outputs, fresh_state, launch_args, \
    refuse
from .ref import reference_rwkv6_chunked

#: the longest chunk the kernel stages (the reference's C)
MAX_CHUNK = 32

#: launches of the kernel (one per call on CUDA tensors); reset it to 0 to
#: count the launches of one run
LAUNCHES = {"rwkv6_chunked": 0}


def rwkv6_chunked(r, k, v, w, u, *, chunk: int = 32, state=None,
                  return_state: bool = False):
    """:func:`..kernel.rwkv6_scan`'s contract (r, k, v, w ``(BH, T, N)``; u
    ``(N,)`` or ``(H, N)``; optional initial state, optional final state)
    computed in chunks of ``min(chunk, T)`` tokens; any ``T``, a ragged last
    chunk padded with decay 1.  The kernel takes chunks of at most
    :data:`MAX_CHUNK` tokens."""
    check_inputs(r, k, v, w, u, state, "rwkv6_chunked")
    o, s = chunked_op(r, k, v, w, u, state, int(chunk), return_state)
    return (o, s) if return_state else o


def _refuse(r, k, v, w, u, state, chunk) -> None:
    """Raise for what the kernel does not take (on the card and in a fake
    trace of it): :func:`..kernel.refuse`'s, and a chunk above
    :data:`MAX_CHUNK`."""
    c = max(1, min(chunk, r.shape[1]))
    if not 1 <= chunk or c > MAX_CHUNK:
        raise ValueError(f"rwkv6_chunked: chunk {chunk} (the kernel takes "
                         f"1 to {MAX_CHUNK})")
    refuse(r, k, v, w, u, state, "rwkv6_chunked")


@torch.library.custom_op("repro_torch::rwkv6_chunked", mutates_args=(),
                         device_types="cpu")
def chunked_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor], chunk: int,
               return_state: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator: ``(o, final state)``, the state an empty ``(0,)``
    tensor unless ``return_state``; on CPU tensors the plain version."""
    o, s = reference_rwkv6_chunked(r, k, v, w, u, chunk=chunk, state=state,
                                   return_state=True)
    s = fresh_state(s, state) if return_state else s.new_empty((0,))
    return o.contiguous(), s


@chunked_op.register_kernel("cuda")
def _launch(r, k, v, w, u, state, chunk, return_state):
    _refuse(r, k, v, w, u, state, chunk)
    bh, t, n = r.shape
    c = max(1, min(chunk, t))
    # the kernel reads r, k, v and w in 16-byte loads: a view that starts
    # off that alignment is copied
    r, k, v, w = (z if z.data_ptr() % 16 == 0 else z.clone()
                  for z in (r, k, v, w))
    o, s_out, ptrs, h, _keep = launch_args(r, k, v, w, u, state,
                                           return_state, "rwkv6_chunked")
    if bh:                             # else no block to launch
        cuda_build.launch(
            "repro_rwkv6_chunked_fwd", "ppppppppiiiiiip",
            [*ptrs, cuda_build.DTYPE_CODES[r.dtype], bh, t, n, h, c],
            r.device)
        LAUNCHES["rwkv6_chunked"] += 1
    return o, s_out if return_state else o.new_empty((0,),
                                                     dtype=torch.float32)


@chunked_op.register_fake
def _fake(r, k, v, w, u, state, chunk, return_state):
    if r.device.type == "cuda":
        _refuse(r, k, v, w, u, state, chunk)
    return fake_outputs(r, return_state)


def chunked_ops(bh, t, n, chunk=32) -> dict:
    """B7's operations on the route it takes: per row and chunk of m steps
    the four products' multiply-adds — ``k̃ᵀV`` (N² m), ``r̃S`` (m N²),
    the scores ``r̃k̃ᵀ`` and their product with V (N·m(m-1)/2 each, the
    strictly causal pairs) — on the FP64 tensor cores (``tensor_f64``),
    and on the CUDA cores 5 float32 operations an element (Cum's product,
    ``r̃``, ``k̃``'s division, the bonus's two) and 2 a state element a
    chunk (the update's add and multiply)."""
    c = max(1, min(chunk, t))
    lengths = [c] * (t // c) + ([t % c] if t % c else [])
    macs = sum(2 * n * n * m + 2 * (m * (m - 1) // 2) * n for m in lengths)
    return {"tensor_f64": bh * macs,
            "float32": 5 * bh * t * n + 2 * bh * len(lengths) * n * n}


@register_flop_formula(torch.ops.repro_torch.rwkv6_chunked)
def chunked_flops(r_shape, k_shape, v_shape, w_shape, u_shape, state,
                  chunk, return_state, *, out_shape=None, **kw) -> int:
    """FLOPs of one call: two a multiply-add of the products (as
    ``FlopCounterMode`` counts a matmul's), one each other operation."""
    ops = chunked_ops(*r_shape, chunk)
    return 2 * ops["tensor_f64"] + ops["float32"]
