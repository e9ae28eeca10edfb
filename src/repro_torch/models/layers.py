"""Model building blocks: the port of ``repro/models/layers.py`` for the
layers the port's models run: RMSNorm, RoPE, attention (GQA, RoPE,
qk-norm, QKV bias, logit softcap, sliding window with a ring-buffer KV
cache, cross-attention onto an encoder output) for prefill and decode,
the SwiGLU / GeGLU MLP, the GShard-style MoE layer (grouped capacity
dispatch, the router's aux losses), the Mamba mixer (causal conv, the
selective scan through kernel B5) and the RWKV6 mixer (token shift,
data-dependent decay, the recurrence through kernels B6/B7, per-head group
norm and gate), the last two with their carried state.  Pure functions
over dictionaries of tensors, in the reference's layouts (``x`` is ``(B,
S, D)``, q/k/v ``(B, S, H, hd)``, caches ``(B, T, Hkv, hd)``, Mamba states
``(B, d_inner, d_state)``, RWKV states ``(B, H, N, N)``), so the tests
compare like with like.

On the card every multi-token attention and every cross-attention runs
kernel B3 and every Mamba scan kernel B5; on the CPU the reference's own
``_dense_attn`` / ``_chunked_attn`` and the scan's plain version
(``reference_mamba``).

On a mesh (the model's parameters as DTensors, ``launch/steps.py``) the
kernels' call sites (B3 in ``_attend``, B5 in ``mamba_mixer``, B6 and B7
in ``rwkv_mixer``) run on each rank's local shards through ``local_map``
(:func:`sharded_call`), the einsums as each rank's local einsum
(:func:`einsum`), and the KV cache's write rank by rank; everything else
is DTensor's own propagation.  The logical sharding axes of each layer's
leaves (``RMSNORM_AXES``, :func:`attention_axes`, ``MLP_AXES``,
:func:`moe_axes`, ``MAMBA_AXES``, ``RWKV_AXES``) are the reference's.

On the CPU ``tests/test_torch_family_attention.py`` holds ``attention``
feature by feature (ring caches included) and the MLP against the JAX
package, ``tests/test_torch_family_moe_mamba.py`` ``moe`` and
``mamba_mixer``, and ``tests/test_torch_families.py`` each config's model;
on a card ``python3 -c "import chip_smoke as c; c.run_families()"`` and
``c.run_moe()`` (``PYTHONPATH=src``) serve Gemma2-9B at its 42 layers, the
other attention configs, Jamba-v0.1, OLMoE-1B-7B and Qwen3-MoE-235B, every
B3 call and a sample of the B5 calls held against their plain versions.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..core.device import on_card_route
from ..core.obs import trace
from ..kernels.decode_attention import kernel as da_kernel
from ..kernels.decode_attention.ref import (NEG_INF,
                                            reference_decode_attention,
                                            softmax)
from ..kernels.flash_attention import ops as fa_ops
from ..kernels.mamba_scan import ops as ms_ops
from ..kernels.rwkv6_scan import ops as rwkv_ops
from .config import ModelConfig

Params = Dict[str, torch.Tensor]


def _init(gen: Optional[torch.Generator], shape, dtype: torch.dtype, device,
          scale: Optional[float] = None) -> torch.Tensor:
    """A normal draw at the reference's scale; with no generator (the
    ``meta`` device: shapes only) an empty tensor."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * s).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype: torch.dtype, device) -> Params:
    return {"g": torch.zeros((d,), dtype=dtype, device=device)}


#: the logical sharding axes of each layer's leaves, as the reference's
#: ``init_*`` return them beside the parameters (the names
#: ``distributed.sharding``'s rules map to mesh axes)
RMSNORM_AXES = {"g": ("embed",)}


def rmsnorm(p: Params, x: torch.Tensor, *, eps=1e-6,
            plus_one=True) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    g = p["g"].to(torch.float32) + (1.0 if plus_one else 0.0)
    return (xf * inv * g).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, half: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 cos/sin tables ``(..., 1, half)`` for ``positions`` (``(B, S)``
    or ``(S,)``), on the positions' device — shared by the direct model and
    the lazy transformer's adopted constants."""
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    cos, sin = rope_tables(positions, half, theta)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Kernels on a mesh
# ---------------------------------------------------------------------------

def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def sharded_call(fn, args, roles, out_roles):
    """``fn(*args)`` on each rank's local shards, through ``local_map``:
    how kernels B3, B5, B6 and B7 run on a mesh.  ``args`` are DTensors,
    plain tensors (taken as replicated) or None; ``roles`` gives each
    argument's ``(batch dim, channel dim)`` (heads or channels; either may
    be None), ``out_roles`` each output's.  Each mesh dimension keeps the
    first DTensor argument's sharding where it shards that argument's
    batch or channel dim and every argument with that role divides evenly
    over it (query and KV heads alike, so each rank's query heads read its
    own KV heads); every other mesh dimension is replicated.  The
    arguments are redistributed to that plan before the call, so ``fn``
    sees whole rows of each of its heads or channels and the kernel the
    local shapes it takes; the outputs come back as DTensors of the same
    plan.  Returns one output or a tuple, as ``fn`` does."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    lead = next(i for i, a in enumerate(args) if isinstance(a, DTensor))
    mesh = args[lead].device_mesh
    plan = []
    for pl in args[lead].placements:
        role = None
        if isinstance(pl, Shard):
            role = next((r for r in (0, 1) if roles[lead][r] == pl.dim), None)
        plan.append(role)
    for r in (0, 1):
        ways = math.prod(mesh.size(i) for i, p in enumerate(plan) if p == r)
        if any(a is not None and ro[r] is not None and a.shape[ro[r]] % ways
               for a, ro in zip(args, roles)):
            plan = [None if p == r else p for p in plan]

    def placements(role):
        return [Replicate() if p is None or role[p] is None
                else Shard(role[p]) for p in plan]

    def grad_placements(role):
        # an argument without the sharded role gets each rank's partial
        # sum of its gradient (B5's b and c over the channels, its a and d
        # over the batch rows)
        return [Replicate() if p is None else Partial() if role[p] is None
                else Shard(role[p]) for p in plan]

    ins, in_pl, grad_pl = [], [], []
    for a, role in zip(args, roles):
        if a is None:
            ins.append(None)
            in_pl.append(None)
            grad_pl.append(None)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        want = placements(role)
        if list(a.placements) != want:
            a = a.redistribute(mesh, want)
        ins.append(a)
        in_pl.append(want)
        grad_pl.append(grad_placements(role))
    outs = [placements(role) for role in out_roles]
    return local_map(fn, out_placements=outs[0] if len(outs) == 1
                     else tuple(outs), in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*ins)


def einsum(eq: str, *ops) -> torch.Tensor:
    """``torch.einsum``; on a mesh (a DTensor operand) each rank's own
    einsum over its local shards (:func:`_sharded_einsum`).  Plain tensors
    take ``torch.einsum`` itself, so the one-card paths are unchanged."""
    if any(_is_dtensor(o) for o in ops):
        return _sharded_einsum(eq, ops)
    return torch.einsum(eq, *ops)


def _sharded_einsum(eq: str, ops) -> torch.Tensor:
    """An einsum of DTensors (plain operands taken as replicated) as each
    rank's local einsum, through ``local_map``.  Each mesh dimension
    shards one index letter in every operand that has it (an operand
    without it is replicated there) or none; the output is sharded on that
    letter, or partial where the letter is contracted.  The letter is the
    one some operand is already sharded on that costs the fewest elements
    to redistribute (keeping an operand's partial sum where the others are
    replicated), so the einsum never flattens a sharded dimension (which
    DTensor's own decomposition refuses).  The gradients come back sharded
    as their operands, or partial where an operand lacks the letter."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    mesh = next(o for o in ops if isinstance(o, DTensor)).device_mesh
    ops = [o if isinstance(o, DTensor) else DTensor.from_local(
        o, mesh, [Replicate()] * mesh.ndim, run_check=False) for o in ops]
    size = {l: n for sub, o in zip(subs, ops) for l, n in zip(sub, o.shape)}
    ways: Dict[str, int] = {}
    targets = [[] for _ in ops]
    grads = [[] for _ in ops]
    out_pl = []
    for md in range(mesh.ndim):
        cur = [o.placements[md] for o in ops]
        partial = [i for i, p in enumerate(cur) if p.is_partial()]
        if len(partial) == 1 and all(p.is_replicate() for i, p in
                                     enumerate(cur) if i != partial[0]):
            for i in range(len(ops)):       # keep the one partial sum
                targets[i].append(cur[i])
                grads[i].append(Replicate() if i == partial[0]
                                else Partial())
            out_pl.append(Partial())
            continue
        n = mesh.size(md)
        options = [sub[p.dim] for sub, p in zip(subs, cur) if p.is_shard()]
        options = [l for l in dict.fromkeys(options)
                   if size[l] % (ways.get(l, 1) * n) == 0] + [None]

        def cost(letter):
            want = [Shard(sub.index(letter)) if letter is not None
                    and letter in sub else Replicate() for sub in subs]
            return (sum(o.numel() for o, p, w in zip(ops, cur, want)
                        if p != w), letter is None or letter not in out)

        letter = min(options, key=cost)
        if letter is not None:
            ways[letter] = ways.get(letter, 1) * n
        for i, sub in enumerate(subs):
            has = letter is not None and letter in sub
            targets[i].append(Shard(sub.index(letter)) if has
                              else Replicate())
            grads[i].append(Shard(sub.index(letter)) if has
                            else Partial() if letter is not None
                            else Replicate())
        out_pl.append(Replicate() if letter is None
                      else Shard(out.index(letter)) if letter in out
                      else Partial())
    ops = [o if list(o.placements) == t else o.redistribute(mesh, t)
           for o, t in zip(ops, targets)]
    return local_map(lambda *a: torch.einsum(eq, *a), out_placements=out_pl,
                     in_placements=tuple(targets),
                     in_grad_placements=tuple(grads),
                     device_mesh=mesh)(*ops)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen: Optional[torch.Generator], cfg: ModelConfig,
                   device) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pd = getattr(torch, cfg.param_dtype)
    p = {
        "wq": _init(gen, (d, h * hd), pd, device),
        "wk": _init(gen, (d, kv * hd), pd, device),
        "wv": _init(gen, (d, kv * hd), pd, device),
        "wo": _init(gen, (h * hd, d), pd, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=pd, device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=pd, device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=pd, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=pd, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=pd, device=device)
    return p


def attention_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    ax = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
          "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        ax.update({"bq": ("heads",), "bk": ("kv_heads",),
                   "bv": ("kv_heads",)})
    if cfg.qk_norm:
        ax.update({"q_norm": (None,), "k_norm": (None,)})
    return ax


#: above this many queries the reference chunks the query axis
#: (:func:`_chunked_attn`); on the card kernel B3 takes every length
DENSE_ATTN_MAX_SEQ = 8192


def _mask(qpos, kpos, causal: bool, window: Optional[int]) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def _dense_attn(q, k, v, *, causal: bool, window: Optional[int],
                softcap: Optional[float], scale: float) -> torch.Tensor:
    """Plain masked attention over (B, S, H, hd) q and (B, T, Hkv, hd) k/v,
    k/v repeated per group (query head ``h`` reads kv head ``h //
    group``)."""
    s, h = q.shape[1], q.shape[2]
    t, kvh = k.shape[1], k.shape[2]
    if kvh != h:
        k = torch.repeat_interleave(k, h // kvh, dim=2)
        v = torch.repeat_interleave(v, h // kvh, dim=2)
    sc = einsum("bshd,bthd->bhst", q.to(torch.float32),
                      k.to(torch.float32)) * scale
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    mask = _mask(torch.arange(s, device=q.device)[:, None],
                 torch.arange(t, device=q.device)[None, :], causal, window)
    sc = torch.where(mask[None, None], sc, NEG_INF)
    o = einsum("bhst,bthd->bshd", softmax(sc), v.to(torch.float32))
    return o.to(q.dtype)


def _chunked_attn(q, k, v, *, causal: bool, window: Optional[int],
                  softcap: Optional[float], scale: float,
                  chunk: int = 2048) -> torch.Tensor:
    """The reference's online-softmax attention over query chunks of
    ``chunk`` rows (no ``(S, S)`` score matrix live): q ``(B, S, H, D)``
    grouped-query, k/v ``(B, T, Hkv, D)``."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    kg = k.transpose(1, 2).to(torch.float32)           # (B, Hkv, T, D)
    vg = v.transpose(1, 2).to(torch.float32)
    kpos = torch.arange(t, device=q.device)[None, :]
    outs = []
    for start in range(0, s, chunk):
        qi = q[:, start:start + chunk]
        n = qi.shape[1]
        qg = qi.transpose(1, 2).reshape(b, kvh, group, n, d)
        sc = einsum("bkgqd,bktd->bkgqt", qg.to(torch.float32),
                          kg) * scale
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        qpos = start + torch.arange(n, device=q.device)[:, None]
        sc = torch.where(_mask(qpos, kpos, causal, window)[None, None, None],
                         sc, NEG_INF)
        p = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
        o = einsum("bkgqt,bktd->bkgqd", p, vg)
        o = o / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
        outs.append(o.reshape(b, h, n, d).transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype)


def _attend(q, k, v, *, causal: bool, window: Optional[int],
            softcap: Optional[float], scale: float) -> torch.Tensor:
    """Attention of ``(B, S, H, hd)`` queries over ``(B, T, Hkv, hd)``
    keys and values: on the card (and inside ``core.device.card_route``)
    kernel B3 (``flash_attention.ops``) over ``(B, H, S, hd)`` contiguous
    copies, at any length; on the CPU the reference's own arithmetic,
    :func:`_dense_attn` up to :data:`DENSE_ATTN_MAX_SEQ` queries and
    :func:`_chunked_attn` above.
    On a mesh (DTensor inputs) each rank runs it on its own batch rows and
    heads (:func:`sharded_call`)."""
    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if _is_dtensor(q):
        return sharded_call(lambda *a: _attend(*a, **opts), (q, k, v),
                            ((0, 2),) * 3, ((0, 2),))
    if not on_card_route(q.device):
        fn = _dense_attn if q.shape[1] <= DENSE_ATTN_MAX_SEQ \
            else _chunked_attn
        return fn(q, k, v, **opts)
    o = fa_ops.attention(*(z.transpose(1, 2).contiguous() for z in (q, k, v)),
                         causal, window, softcap, scale)
    return o.transpose(1, 2)


def _split(x: torch.Tensor, dim: int, *shape) -> torch.Tensor:
    """``x`` reshaped to ``shape``, which splits its dim ``dim`` in two
    (heads into (heads, head dim), or into (kv heads, group)).  On a mesh
    a ``dim`` sharded over more ways than the first part divides
    (Whisper's 6 heads or Gemma2-9B's 8 kv heads on a 16-way model axis)
    is gathered whole first: DTensor cannot split a shard's part across
    ranks."""
    if _is_dtensor(x) and shape[dim] % math.prod(
            x.device_mesh.size(i) for i, p in enumerate(x.placements)
            if p.is_shard(dim)):
        x = _whole(x, dim)
    return x.reshape(*shape)


def _whole(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with its dim ``dim`` whole on every rank: on a mesh a DTensor
    sharded there is gathered; any other tensor as it is."""
    if not _is_dtensor(x) or not any(p.is_shard(dim) for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard(dim)
                                          else p for p in x.placements])


def _summed(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its partial sums reduced (on a mesh a DTensor that is
    ``Partial`` on some mesh dim is all-reduced there), so that a bias can
    be added once: torch 2.11's DTensor cannot turn the bias into partial
    sums."""
    if not _is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


class _GatherGrad(torch.autograd.Function):
    """The identity, whose backward gathers the gradient's dim ``dim``
    whole (:func:`_whole`)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole(g, ctx.dim), None


def _gather_grad(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x``; on a mesh its gradient comes back with dim ``dim`` whole: a
    tensor regrouped from rows and sequence (the MoE layer's output) whose
    gradient a sequence-parallel activation would shard on the sequence,
    which torch 2.11's DTensor cannot regroup."""
    return _GatherGrad.apply(x, dim) if _is_dtensor(x) else x


def _per_row(fn, x: torch.Tensor, channel: Optional[int] = None):
    """``fn(x)``; on a mesh ``fn`` of each rank's batch rows (dim 0) with
    every other dim whole but ``channel`` (kept as it is sharded), through
    :func:`sharded_call`: an op along the sequence (RWKV6's token shift, a
    ring cache's roll: torch 2.11's DTensor has no rule for either) or one
    that regroups rows and a sharded sequence (the MoE layer's routing
    groups), which it cannot place."""
    if _is_dtensor(x):
        return sharded_call(fn, (x,), ((0, channel),), ((0, channel),))
    return fn(x)


def _cache_write(cache, at, new, in_place: bool = False):
    """``cache`` ``(B, T, Hkv, hd)`` with ``new`` written at positions
    ``at``: a new tensor, or with ``in_place`` ``cache`` itself, written
    where it lies; on a mesh each rank writes its own rows and KV heads
    into a new tensor (DTensor has no rule for ``index_copy``)."""
    if _is_dtensor(cache):
        return sharded_call(lambda c, a, n: c.index_copy(1, a, n),
                            (cache, at, new), ((0, 2), (None, None), (0, 2)),
                            ((0, 2),))
    if in_place:
        return cache.index_copy_(1, at, new)
    return cache.index_copy(1, at, new)


def _decode_attend(q, k, v, idx, *, ring: bool, window: Optional[int],
                   softcap: Optional[float]) -> torch.Tensor:
    """One token a row, ``(B, 1, H, hd)`` queries, over its ``(B, T, Hkv,
    hd)`` caches where they lie: on the card (and inside
    ``core.device.card_route``) the decode-attention kernel
    (``kernels/decode_attention``), which finds the valid keys from
    ``idx`` on the device; on the CPU its plain version, the reference's
    arithmetic.  On a mesh each rank runs it on its own batch rows and
    heads (:func:`sharded_call`)."""
    opts = dict(ring=ring, window=window, softcap=softcap)
    if _is_dtensor(q) or _is_dtensor(k):
        return sharded_call(lambda *a: _decode_attend(*a, **opts),
                            (q, k, v, idx),
                            ((0, 2), (0, 2), (0, 2), (None, None)),
                            ((0, 2),))
    if not on_card_route(q.device):
        return reference_decode_attention(q, k, v, idx, **opts)
    return da_kernel.decode_attention(q.contiguous(), k, v, idx, **opts)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              local: bool = False, positions: Optional[torch.Tensor] = None,
              cache: Optional[Dict] = None,
              kv_src: Optional[torch.Tensor] = None, causal: bool = True,
              in_place: bool = False):
    """Returns ``(out, new_cache)``.  ``cache = {"k", "v", "idx"}``: a
    prompt (``s > 1``, ``idx == 0``) writes its k/v and attends over its
    own; one token writes at ``idx`` and attends over the cache up to
    ``idx`` (:func:`_decode_attend`).  With ``in_place`` (the decode
    graph's static caches) the k/v are written into ``cache`` itself, and
    ``new_cache`` holds those tensors.  A ``local`` layer whose cache is
    ``window`` deep keeps a ring: a prompt of ``s >= window`` tokens
    stores its last ``window`` at slot ``position % window``, a token
    writes at ``idx % window`` and only empty slots are masked.  The write
    slot stays on the device (no host read), so a decode step can be
    captured in a CUDA graph.  ``kv_src`` (an encoder output) makes it cross-attention: k/v
    from it, no RoPE, no cache."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    window = cfg.sliding_window if local else None
    softcap = cfg.attn_softcap or None
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = einsum("bsd,dh->bsh", x, p["wq"].to(x.dtype))
    if cfg.qkv_bias:
        q = _summed(q) + p["bq"].to(x.dtype)
    q = _split(q, 2, b, s, h, hd)
    src = x if kv_src is None else kv_src.to(x.dtype)
    k = einsum("bsd,dh->bsh", src, p["wk"].to(x.dtype))
    v = einsum("bsd,dh->bsh", src, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        k = _summed(k) + p["bk"].to(x.dtype)
        v = _summed(v) + p["bv"].to(x.dtype)
    k = _split(k, 2, b, src.shape[1], kvh, hd)
    v = _split(v, 2, b, src.shape[1], kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm({"g": p["q_norm"]}, q, plus_one=True)
        k = rmsnorm({"g": p["k_norm"]}, k, plus_one=True)
    if kv_src is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is None or kv_src is not None:
        o = _attend(q, k, v, causal=causal and kv_src is None, window=window,
                    softcap=softcap, scale=1.0 / math.sqrt(hd))
    else:
        idx = cache["idx"]
        t = cache["k"].shape[1]
        ring = window is not None and t == window
        if ring and s >= t:
            # the prompt's last `window` tokens at slot position % window
            # (a roll of the tail slice)
            def roll(z):
                return torch.roll(z, s % t, dims=1)

            ck = _per_row(roll, k[:, s - t:].to(cache["k"].dtype), 2)
            cv = _per_row(roll, v[:, s - t:].to(cache["v"].dtype), 2)
        else:
            slot = torch.remainder(idx, t) if ring else idx
            at = (slot + torch.arange(s, device=x.device)).long()
            ck = _cache_write(cache["k"], at, k.to(cache["k"].dtype),
                              in_place)
            cv = _cache_write(cache["v"], at, v.to(cache["v"].dtype),
                              in_place)
        new_cache = {"k": ck, "v": cv, "idx": idx + s}
        if s > 1:
            # a prompt (idx == 0) attends over its own k/v
            o = _attend(q, k, v, causal=causal, window=window,
                        softcap=softcap, scale=1.0 / math.sqrt(hd))
        else:
            o = _decode_attend(q, ck, cv, idx, ring=ring, window=window,
                               softcap=softcap)
    out = einsum("bsh,hd->bsd", o.reshape(b, s, h * hd),
                       p["wo"].to(x.dtype))
    return out, new_cache


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: Optional[torch.Generator], cfg: ModelConfig,
             device, d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pd = getattr(torch, cfg.param_dtype)
    return {"w_gate": _init(gen, (d, f), pd, device),
            "w_up": _init(gen, (d, f), pd, device),
            "w_down": _init(gen, (f, d), pd, device)}


MLP_AXES = {"w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"),
            "w_down": ("ffn", "embed")}


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``act(x w_gate) · (x w_up)`` then ``w_down``: silu, or ``gelu`` as
    ``jax.nn.gelu`` computes it by default, the tanh approximation."""
    t = einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype))
    u = einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
    g = t * torch.sigmoid(t) if cfg.act == "silu" else \
        torch.nn.functional.gelu(t, approximate="tanh")
    return einsum("bsf,fd->bsd", g * u, p["w_down"].to(x.dtype))


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style capacity dispatch)
# ---------------------------------------------------------------------------

def init_moe(gen: Optional[torch.Generator], cfg: ModelConfig,
             device) -> Params:
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_expert
    pd = getattr(torch, cfg.param_dtype)
    p = {"router": _init(gen, (d, e), pd, device, scale=0.02),
         "w_gate": _init(gen, (e, d, f), pd, device),
         "w_up": _init(gen, (e, d, f), pd, device),
         "w_down": _init(gen, (e, f, d), pd, device)}
    if m.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, device,
                               d_ff=m.d_expert * m.n_shared_experts)
    return p


def moe_axes(cfg: ModelConfig) -> Dict:
    ax = {"router": ("embed", None),
          "w_gate": ("expert", "embed", "expert_ffn"),
          "w_up": ("expert", "embed", "expert_ffn"),
          "w_down": ("expert", "expert_ffn", "embed")}
    if cfg.moe.n_shared_experts:
        ax["shared"] = dict(MLP_AXES)
    return ax


#: GShard-style routing group: expert capacity is set per group of this
#: many tokens, so the dispatch tensor grows linearly with the sequence
MOE_GROUP_TOKENS = 512


def moe_route(p: Params, xg: torch.Tensor, cfg: ModelConfig) -> Dict:
    """The router of :func:`moe` over ``(groups, s_g, d)`` tokens, in
    float32: ``logits`` and ``probs`` ``(g, s_g, e)``, ``chosen`` (0/1 a
    token's top-k experts), ``gate`` (its renormalised gates there),
    ``keep`` (``chosen`` less the pairs past their expert's capacity: a
    token's position in its expert's buffer is the exclusive cumsum of
    ``chosen`` over the group), ``pos`` and the capacity ``cap``."""
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    cap = int(m.capacity_factor * xg.shape[1] * k / e) + 1
    logits = einsum("gsd,de->gse", xg.to(torch.float32),
                          p["router"].to(torch.float32))
    probs = softmax(logits)
    gate_vals, idx = torch.topk(probs, k)                  # (g, s, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    # jax.nn.one_hot: a compare against the expert index
    onehot = (idx[..., None] == torch.arange(e, device=xg.device)).to(
        torch.float32)                                     # (g, s, k, e)
    chosen = onehot.sum(2)                                 # (g, s, e) 0/1
    pos = torch.cumsum(chosen, dim=1) - chosen
    return {"logits": logits, "probs": probs, "chosen": chosen,
            "gate": einsum("gsk,gske->gse", gate_vals, onehot),
            "keep": chosen * (pos < cap), "pos": pos, "cap": cap}


def moe(p: Params, x: torch.Tensor, cfg: ModelConfig, constrain=None):
    """Returns ``(y, aux_loss)``: the reference's grouped dispatch and
    combine.  Tokens route within groups of ``min(s, 512)`` (``s`` must be
    a multiple of it); each expert takes at most ``int(capacity_factor ·
    s_g · k / e) + 1`` tokens a group, in token order, and drops the rest
    (:func:`moe_route`).  The experts' products run in ``x.dtype``.
    ``aux`` is the load-balance loss plus the router z-loss, float32.

    Inside an open ``trace.DeviceRecord`` a call counts what the dispatch
    computes: ``moe.pairs_chosen`` (tokens × k), ``moe.pairs_kept`` (those
    within capacity), ``moe.slots`` (groups × experts × capacity, the rows
    the expert products run over), ``moe.experts_used`` (experts with a
    kept pair) and ``moe.calls``; the kept pairs and experts are counted
    on the device (two small kernels), the rest are host numbers."""
    m = cfg.moe
    b, s, d = x.shape
    s_g = min(s, MOE_GROUP_TOKENS)
    assert s % s_g == 0, (s, s_g)
    if _is_dtensor(x) and any(p.is_shard(1) for p in x.placements):
        # a sequence-parallel activation: grouped on each rank's rows
        xg = _per_row(lambda z: z.reshape(-1, s_g, d), x)
    else:
        xg = x.reshape(b * (s // s_g), s_g, d)
    r = moe_route(p, xg, cfg)
    rows = trace.counter_rows(("moe.pairs_kept", "moe.experts_used"),
                              m.n_experts)
    if rows is not None:
        # two kernels: the kept pairs an expert, and whether it has one
        torch.sum(r["keep"], (0, 1), out=rows[0])
        torch.clamp(rows[0], max=1, out=rows[1])
        trace.count("moe.pairs_chosen", xg.shape[0] * s_g * m.top_k)
        trace.count("moe.slots", xg.shape[0] * m.n_experts * r["cap"])
        trace.count("moe.calls", 1)
    slot = torch.arange(r["cap"], device=x.device)
    dispatch = (r["keep"][..., None] * (r["pos"][..., None] == slot)).to(
        x.dtype)                                           # (g, s, e, cap)
    combine = dispatch * r["gate"][..., None].to(x.dtype)
    if constrain is not None:
        dispatch = constrain("moe_dispatch", dispatch)
        combine = constrain("moe_dispatch", combine)
    xin = einsum("gsec,gsd->egcd", dispatch, xg)
    if constrain is not None:
        # the dispatched tokens sharded over the experts, as the expert
        # weights are: the weights are never gathered
        xin = constrain("moe_expert", xin)
    t = einsum("egcd,edf->egcf", xin, p["w_gate"].to(x.dtype))
    h = t * torch.sigmoid(t)
    h = h * einsum("egcd,edf->egcf", xin, p["w_up"].to(x.dtype))
    out = einsum("egcf,efd->egcd", h, p["w_down"].to(x.dtype))
    if constrain is not None:
        out = constrain("moe_expert", out)
    yg = einsum("gsec,egcd->gsd", combine, out)
    if _is_dtensor(yg):
        # back to (b, s, d) on each rank's whole rows, sharded over the
        # rows and d as x is (the groups are row-major): DTensor cannot
        # view groups sharded finer than the rows (torch 2.13 refuses)
        from torch.distributed.tensor import Replicate, Shard
        rows = [pl if isinstance(pl, Shard) and pl.dim in (0, 2)
                else Replicate() for pl in x.placements]
        y = _per_row(lambda z: z.reshape(-1, s, z.shape[-1]),
                     yg.redistribute(yg.device_mesh, rows), channel=2)
    else:
        y = yg.reshape(b, s, d)
    y = _gather_grad(y, 1)
    if "shared" in p:
        y = y + mlp(p["shared"], x, cfg)
    # aux losses: load balance (Switch) and the router's z-loss
    me = r["probs"].mean(dim=(0, 1))
    ce = r["chosen"].mean(dim=(0, 1)) / m.top_k
    lb = m.n_experts * torch.sum(me * ce) * m.load_balance_coef
    z = torch.mean(torch.logsumexp(r["logits"], dim=-1) ** 2) \
        * m.router_z_coef
    return y, lb + z


# ---------------------------------------------------------------------------
# Mamba mixer (Jamba's SSM layers)
# ---------------------------------------------------------------------------

def init_mamba(gen: Optional[torch.Generator], cfg: ModelConfig,
               device) -> Params:
    m = cfg.mamba
    d = cfg.d_model
    d_in = m.expand * d
    dtr = m.dt_rank or -(-d // 16)
    pd = getattr(torch, cfg.param_dtype)
    states = torch.arange(1, m.d_state + 1, dtype=torch.float32,
                          device=device)
    return {
        "in_proj": _init(gen, (d, 2 * d_in), pd, device),
        "conv_w": _init(gen, (m.d_conv, d_in), pd, device, scale=0.5),
        "conv_b": torch.zeros((d_in,), dtype=pd, device=device),
        "x_proj": _init(gen, (d_in, dtr + 2 * m.d_state), pd, device),
        "dt_proj": _init(gen, (dtr, d_in), pd, device),
        "dt_bias": torch.full((d_in,), 0.1, dtype=pd, device=device),
        "a_log": torch.log(states.repeat(d_in, 1)),
        "d": torch.ones((d_in,), dtype=torch.float32, device=device),
        "out_proj": _init(gen, (d_in, d), pd, device),
    }


MAMBA_AXES = {"in_proj": ("embed", "mamba_inner"),
              "conv_w": (None, "mamba_inner"), "conv_b": ("mamba_inner",),
              "x_proj": ("mamba_inner", None),
              "dt_proj": (None, "mamba_inner"),
              "dt_bias": ("mamba_inner",), "a_log": ("mamba_inner", None),
              "d": ("mamba_inner",), "out_proj": ("mamba_inner", "embed")}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no linear cut-off, as
    ``F.softplus`` has)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_mixer(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict] = None, in_place: bool = False):
    """Returns ``(out, new_state)``; ``state`` (prefill and decode) is
    ``{"conv": (B, d_conv - 1, d_inner), "ssm": (B, d_inner, d_state)
    float32}``: the inputs the causal conv reads before ``x`` and the scan's
    state.  The scan is ``mamba_scan.ops.mamba``: kernel B5 on the card,
    the reference's own ``reference_mamba`` on the CPU.  With
    ``in_place`` (a decode token) the new ssm state is written into
    ``state["ssm"]`` itself (on the card by B5), and that is returned."""
    m = cfg.mamba
    b, s, d = x.shape
    d_in = m.expand * d
    dtr = m.dt_rank or -(-d // 16)
    xz = einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    xi, z = xz[..., :d_in], xz[..., d_in:]
    # the causal depthwise conv: the taps summed in order in the compute
    # dtype, then the bias, as the reference sums them
    if state is None:
        pad = torch.zeros((b, m.d_conv - 1, d_in), dtype=xi.dtype,
                          device=x.device)
        xpad = torch.cat([pad, xi], dim=1)
    else:
        xpad = torch.cat([state["conv"].to(xi.dtype), xi], dim=1)
    conv = 0
    for i in range(m.d_conv):
        conv = conv + xpad[:, i:i + s] * p["conv_w"][i].to(xi.dtype)
    conv = conv + p["conv_b"].to(xi.dtype)
    xc = conv * torch.sigmoid(conv)
    proj = einsum("bsi,ie->bse", xc, p["x_proj"].to(xc.dtype))
    dt = _softplus(
        einsum("bsr,ri->bsi", proj[..., :dtr],
                     p["dt_proj"].to(xc.dtype)).to(torch.float32)
        + p["dt_bias"].to(torch.float32))
    bb = proj[..., dtr:dtr + m.d_state].to(torch.float32)
    cc = proj[..., dtr + m.d_state:].to(torch.float32)
    a = -torch.exp(p["a_log"].to(torch.float32))
    d_skip = p["d"].to(torch.float32)
    ssm = None if state is None else state["ssm"]

    def scan(xc, dt, bb, cc, a, d_skip, ssm):
        # B5 takes inputs of one dtype, contiguous: xc widened exactly (y
        # in float32, rounded once below, as reference_mamba rounds it)
        return ms_ops.mamba(xc.to(torch.float32), dt.contiguous(),
                            bb.contiguous(), cc.contiguous(), a.contiguous(),
                            d_skip.contiguous(), state=ssm,
                            return_state=ssm is not None,
                            out_state=ssm if in_place else None)

    args = (xc, dt, bb, cc, a, d_skip, ssm)
    if _is_dtensor(xc):     # on a mesh: each rank's rows and d_inner
        out = sharded_call(scan, args, ((0, 2), (0, 2), (0, None),
                                        (0, None), (None, 0), (None, 0),
                                        (0, 1)),
                           ((0, 2),) if ssm is None else ((0, 2), (0, 1)))
    else:
        out = scan(*args)
    y, new_ssm = out if state is not None else (out, None)
    new_state = None
    if state is not None:
        new_state = {"conv": xpad[:, -(m.d_conv - 1):].to(
            state["conv"].dtype), "ssm": new_ssm}
    y = y.to(x.dtype) * (z * torch.sigmoid(z))
    out = einsum("bsi,id->bsd", y, p["out_proj"].to(x.dtype))
    return out, new_state


# ---------------------------------------------------------------------------
# RWKV6 mixer (Finch: data-dependent per-channel decay)
# ---------------------------------------------------------------------------

def init_rwkv(gen: Optional[torch.Generator], cfg: ModelConfig,
              device) -> Params:
    d = cfg.d_model
    n = cfg.rwkv.head_dim
    heads = d // n
    pd = getattr(torch, cfg.param_dtype)
    lora = max(32, d // 32)
    return {
        "mix": _init(gen, (5, d), pd, device, scale=0.02),   # r,k,v,w,g lerp
        "wr": _init(gen, (d, d), pd, device),
        "wk": _init(gen, (d, d), pd, device),
        "wv": _init(gen, (d, d), pd, device),
        "wg": _init(gen, (d, d), pd, device),
        "wo": _init(gen, (d, d), pd, device),
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "w_a": _init(gen, (d, lora), pd, device, scale=0.02),  # decay LoRA
        "w_b": _init(gen, (lora, d), pd, device, scale=0.02),
        "u": _init(gen, (heads, n), pd, device, scale=0.1),    # bonus
        "ln_g": torch.ones((d,), dtype=pd, device=device),
    }


RWKV_AXES = {"mix": (None, "embed"), "wr": ("embed", "heads"),
             "wk": ("embed", "heads"), "wv": ("embed", "heads"),
             "wg": ("embed", "heads"), "wo": ("heads", "embed"),
             "w0": ("embed",), "w_a": ("embed", None),
             "w_b": (None, "embed"), "u": ("heads", None),
             "ln_g": ("embed",)}


def rwkv_mixer(p: Params, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[Dict] = None, in_place: bool = False):
    """Returns ``(out, new_state)``; ``state`` (prefill and decode) is
    ``{"last": (B, d), "wkv": (B, H, N, N)}``: the token before ``x`` (for
    the shift) and the float32 recurrence state.  With ``in_place`` (a
    decode token) kernel B6 writes the new wkv state into ``state["wkv"]``
    itself, and that is returned."""
    b, s, d = x.shape
    n = cfg.rwkv.head_dim
    heads = d // n
    if state is None:
        prev = _per_row(lambda z: torch.nn.functional.pad(
            z, (0, 0, 1, 0))[:, :-1], x, 2)
    else:
        prev = torch.cat([state["last"][:, None].to(x.dtype), x[:, :-1]],
                         dim=1)
    mix = torch.sigmoid(p["mix"].to(torch.float32))
    xm = [x * m + prev * (1 - m) for m in (mix[i].to(x.dtype)
                                           for i in range(5))]
    r = einsum("bsd,de->bse", xm[0], p["wr"].to(x.dtype))
    k = einsum("bsd,de->bse", xm[1], p["wk"].to(x.dtype))
    v = einsum("bsd,de->bse", xm[2], p["wv"].to(x.dtype))
    # data-dependent decay (low-rank), in float32: (x w_a) w_b, the order
    # the reference's einsum contracts in
    lo = einsum("bsd,dl->bsl", xm[3].to(torch.float32),
                      p["w_a"].to(torch.float32))
    wlog = p["w0"].to(torch.float32) + einsum(
        "bsl,le->bse", lo, p["w_b"].to(torch.float32))
    w = torch.exp(-torch.exp(wlog))                     # (B,S,d) in (0,1)
    gl = einsum("bsd,de->bse", xm[4], p["wg"].to(x.dtype))
    g = gl * torch.sigmoid(gl)

    u = p["u"].to(torch.float32)
    wkv = None if state is None else state["wkv"]

    def recurrence(r, k, v, w, u, wkv):
        b, heads = r.shape[0], u.shape[0]       # this rank's, on a mesh

        def split(z):
            return z.reshape(b, s, heads, n).transpose(1, 2).reshape(
                b * heads, s, n)

        o, st = _rwkv_heads(split(r), split(k), split(v), split(w), u, b,
                            heads, state=wkv, return_state=wkv is not None,
                            out_state=wkv if in_place else None)
        o = o.reshape(b, heads, s, n).transpose(1, 2).reshape(b, s, -1)
        return o if st is None else (o, st)

    args = (r, k, v, w, u, wkv)
    if _is_dtensor(r):      # on a mesh: each rank's rows and heads
        out = sharded_call(recurrence, args, ((0, 2),) * 4 + ((None, 0),
                                                              (0, 1)),
                           ((0, 2),) if wkv is None else ((0, 2), (0, 1)))
    else:
        out = recurrence(*args)
    o, st = out if wkv is not None else (out, None)
    new_state = None
    if state is not None:
        new_state = {"last": x[:, -1].to(state["last"].dtype), "wkv": st}
    # per-head group norm
    oh = o.reshape(b, s, heads, n).to(torch.float32)
    oh = oh * torch.rsqrt(torch.mean(oh * oh, dim=-1, keepdim=True) + 1e-6)
    o = (oh.reshape(b, s, d) * p["ln_g"].to(torch.float32)).to(x.dtype)
    out = einsum("bsd,de->bse", o * g, p["wo"].to(x.dtype))
    return out, new_state


def _rwkv_heads(rh, kh, vh, wh, u, b, heads, state=None,
                return_state=False, out_state=None):
    """The RWKV6 recurrence over all ``B·H`` rows in ONE op call, row
    ``b·H + h`` taking the bonus ``u[h]``: a prompt or a whole sequence in
    chunks (kernel B7), one decode token (``S == 1``) as a step of the
    token recurrence (kernel B6).  ``state``: the initial ``(B, H, N, N)``
    wkv or None.  ``out_state`` (serving a decode token in place): a
    ``(B, H, N, N)`` float32 tensor, which may be ``state``, that B6
    writes the final state into.  Returns ``(o, final state as (B, H, N,
    N) or None)``."""
    s, n = rh.shape[1], rh.shape[2]
    s0 = None if state is None else state.reshape(b * heads, n, n)
    ins = (rh.contiguous(), kh.contiguous(), vh.contiguous(),
           wh.contiguous(), u)
    if out_state is not None:
        o, _ = rwkv_ops.rwkv6(*ins, state=s0,
                              out_state=out_state.reshape(b * heads, n, n))
        return o, out_state
    op = rwkv_ops.rwkv6 if s == 1 else rwkv_ops.rwkv6_chunked
    out = op(*ins, state=s0, return_state=return_state)
    if not return_state:
        return out, None
    o, st = out
    return o, st.reshape(b, heads, n, n)
