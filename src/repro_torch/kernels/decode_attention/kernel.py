"""Decode attention in CUDA C++: one new token a row attends over its KV
cache where the cache lies.  It replaces no TPU kernel (the JAX package's
decode step attends in plain jnp); it was added because the port's plain
decode step copied and widened whole caches a layer (PERF.md §5-6).

The kernel is ``src/repro_torch/csrc/decode_attention.cu`` (its header
says what bounds it and how it is laid out): split-KV decode attention,
one block per (row, KV head, pair of its query heads) and split of the
valid keys, which it finds on the device from the cache's
write index, so a CUDA graph that captured the call stays right as the
index advances; 16-byte loads of the cache in its own dtype, an online
softmax in float32, the splits merged in a fixed order by a second small
kernel.  It is built by :mod:`..cuda_build` at first use.

It runs as the custom operator ``torch.ops.repro_torch.decode_attention``
(:func:`decode_attention_op`): the kernel on CUDA tensors (it launches or
raises), the plain version (``ref.py``) on CPU tensors, and on fake or
``meta`` tensors a fake that makes the output and, on fake CUDA tensors,
refuses what the kernel refuses, so a dry run traces the card's decode
step through it (``launch/dryrun.py``).  Its FLOP formula counts what the
plain version's two products count, over the cache's whole length.

With a tracer installed (``core.obs.trace``) each launch counts
``attention.decode_kernel_calls`` (one) and ``attention.decode_splits``
(the split count it chose), host numbers of the open record.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from ...core.device import op_device
from ...core.obs import trace
from .. import cuda_build
from .ref import reference_decode_attention, valid_keys

HEAD_DIMS = (32, 64, 128, 256)      # the head widths the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)
#: query heads a block serves, largest first: the largest that divides the
#: group is taken (the kernel is built for these)
HEADS_PER_BLOCK = (2, 1)
#: blocks a launch may give each SM: the splits stop where one more would
#: pass it.  Four blocks of four warps keep an SM's share of the card's
#: memory busy; more leave a tail of half-filled waves (swept on an H100
#: at the served shapes: OLMoE-1B-7B chat 0.1004 ms at 1 split against
#: 0.1069 at 3, rag 0.0837 at 4 against 0.0939 at 9)
BLOCKS_PER_SM = 4
#: the least K and V bytes a split reads
MIN_SPLIT_BYTES = 32 * 1024

#: launches of the kernel (one a call on CUDA tensors); reset it to 0 to
#: count the launches of one run
LAUNCHES = {"decode_attention": 0}


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     idx: torch.Tensor, *, ring: bool = False,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q ``(B, 1, H, hd)``; k, v ``(B, T, Hkv, hd)`` caches that already
    hold the token's key and value at its slot; ``idx`` the token's
    position, a one-element integer tensor on their device.  ``ring``: the
    cache is a ``window``-deep ring (every filled slot is valid); else
    keys up to ``idx`` (and past ``idx - window`` with a window).  Returns
    ``(B, 1, H, hd)`` in ``q.dtype``."""
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 \
            or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2] \
            or idx.numel() != 1:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, idx "
                         f"{tuple(idx.shape)}")
    op_device({"q": q, "k": k, "v": v, "idx": idx}, "decode_attention")
    return decode_attention_op(q, k, v, idx.reshape(()), bool(ring),
                               None if window is None else int(window),
                               None if softcap is None else float(softcap))


def heads_per_block(group: int) -> int:
    """Query heads a block serves: the largest of ``HEADS_PER_BLOCK``
    dividing the group."""
    return next(n for n in HEADS_PER_BLOCK if group % n == 0)


def split_count(b: int, hkv: int, group: int, t: int, hd: int,
                itemsize: int, sms: int) -> int:
    """How many splits a launch cuts the valid keys into, from the shapes
    and the card's SM count alone (never the write index, so a captured
    graph keeps its schedule): as many as keep the blocks within
    ``BLOCKS_PER_SM`` on each SM (at least one), but no split shorter than
    ``MIN_SPLIT_BYTES`` of keys and values when the cache is full."""
    blocks = b * hkv * (group // heads_per_block(group))
    want = BLOCKS_PER_SM * sms // blocks
    keys = max(1, MIN_SPLIT_BYTES // (2 * hd * itemsize))
    return max(1, min(want, t // keys, 65535))


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _refuse(q, k, v, idx, window, softcap) -> None:
    """Raise for what the kernel does not take (on the card and in a fake
    trace of it): q, k, v not contiguous or not of one dtype of
    :data:`DTYPES`, a head dim outside :data:`HEAD_DIMS`, an empty cache,
    an index that is not one int32, a window below 1, a softcap that is
    not positive."""
    cuda_build.require({"q": q, "k": k, "v": v}, DTYPES, "decode_attention")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {q.shape[3]} (the "
                         f"kernel is built for {HEAD_DIMS})")
    if k.shape[1] == 0 or q.shape[0] == 0:
        raise ValueError("decode_attention: an empty cache or batch")
    if idx.dtype != torch.int32:
        raise TypeError(f"decode_attention: idx is {idx.dtype}, the kernel "
                        "reads one int32")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window {window} (must be >= 1)")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"decode_attention: softcap {softcap} (must be "
                         "> 0)")


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(),
                         device_types="cpu")
def decode_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        idx: torch.Tensor, ring: bool, window: Optional[int],
                        softcap: Optional[float]) -> torch.Tensor:
    """The operator; on CPU tensors the plain version."""
    return reference_decode_attention(q, k, v, idx, ring=ring, window=window,
                                      softcap=softcap).contiguous()


@decode_attention_op.register_kernel("cuda")
def _launch(q, k, v, idx, ring, window, softcap):
    _refuse(q, k, v, idx, window, softcap)
    b, _, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} is not 16-byte "
                             "aligned (the kernel loads 16-byte pieces)")
    group = h // hkv
    splits = split_count(b, hkv, group, t, hd, q.element_size(),
                         _sm_count(q.device))
    out = torch.empty_like(q)
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((b * h * splits * hd,), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((b * h * splits * 2,), dtype=torch.float32,
                              device=q.device)
    cuda_build.launch(
        "repro_decode_attention", "pppppppiiiiiiiiiififp",
        [q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
         out.data_ptr(), 0 if part_o is None else part_o.data_ptr(),
         0 if part_ml is None else part_ml.data_ptr(),
         cuda_build.DTYPE_CODES[q.dtype], b, h, hkv, t, hd,
         heads_per_block(group), splits, int(bool(ring)),
         # sqrt(hd), which ctypes rounds to the plain version's float32
         0 if window is None else int(window), math.sqrt(hd),
         int(softcap is not None), 0.0 if softcap is None else float(softcap)],
        q.device)
    LAUNCHES["decode_attention"] += 1
    trace.count("attention.decode_kernel_calls", 1)
    trace.count("attention.decode_splits", splits)
    return out


@decode_attention_op.register_fake
def _fake(q, k, v, idx, ring, window, softcap):
    if q.device.type == "cuda":
        _refuse(q, k, v, idx, window, softcap)
    return q.new_empty(q.shape)


def decode_bytes(q_shape, k_shape, itemsize: int, idx: int, *, ring: bool,
                 window: Optional[int]) -> int:
    """The bytes one call must move: the valid keys and values
    (:func:`..ref.valid_keys` of a token at ``idx``) read once, q read and
    the output written once."""
    n = int(valid_keys(torch.tensor(idx), k_shape[1], ring=ring,
                       window=window).sum())
    kv = 2 * k_shape[0] * n * k_shape[2] * k_shape[3]
    return (kv + 2 * math.prod(q_shape)) * itemsize


def decode_ops(q_shape, k_shape) -> int:
    """FLOPs of one call as ``FlopCounterMode`` counts the plain version's
    two products (scores and their product with the values, two FLOPs a
    multiply-add) over the cache's whole length: a trace cannot read the
    write index, so the count is the most the call may need."""
    b, s, h, hd = q_shape
    return 2 * 2 * b * h * s * k_shape[1] * hd


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def decode_attention_flops(q_shape, k_shape, v_shape, idx_shape, ring,
                           window, softcap, *, out_shape=None, **kw) -> int:
    return decode_ops(q_shape, k_shape)
