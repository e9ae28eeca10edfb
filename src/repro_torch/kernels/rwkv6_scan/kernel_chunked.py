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

On CPU tensors :func:`rwkv6_chunked` runs the plain version
(``ref.py:reference_rwkv6_chunked``, the same chunk algebra in PyTorch);
on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from .. import cuda_build
from .kernel import check_inputs, launch_args
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
    device = check_inputs(r, k, v, w, u, state, "rwkv6_chunked")
    bh, t, n = r.shape
    if device is None:
        return reference_rwkv6_chunked(r, k, v, w, u, chunk=chunk,
                                       state=state, return_state=return_state)
    c = max(1, min(chunk, t))
    if not 1 <= chunk or c > MAX_CHUNK:
        raise ValueError(f"rwkv6_chunked: chunk {chunk} (the kernel takes "
                         f"1 to {MAX_CHUNK})")
    # the kernel reads r, k, v and w in 16-byte loads: a view that starts
    # off that alignment is copied
    r, k, v, w = (z if z.data_ptr() % 16 == 0 else z.clone()
                  for z in (r, k, v, w))
    o, s_out, ptrs, h, _keep = launch_args(r, k, v, w, u, state,
                                           return_state, "rwkv6_chunked")
    if bh == 0:                        # no block to launch
        return (o, s_out) if return_state else o
    cuda_build.launch(
        "repro_rwkv6_chunked_fwd", "ppppppppiiiiiip",
        [*ptrs, cuda_build.DTYPE_CODES[r.dtype], bh, t, n, h, c], device)
    LAUNCHES["rwkv6_chunked"] += 1
    return (o, s_out) if return_state else o
