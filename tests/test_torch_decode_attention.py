"""The decode step's attention (``kernels/decode_attention``) on the CPU:
its plain version (the operator's CPU implementation) bitwise the decode
branch ``models.layers.attention`` ran before the kernel, and the layer's
decode step against the JAX package's (MHA and GQA, head dims 64, 128 and
256, a softcap, a ring past and inside its window, a linear cache with a
window, the token at the first, a middle and the last slot); the fake
operator's shape, dtype and FLOPs; the split count; and
``serve_decode(in_place=True)`` writing each attention cache where it
lies, with no copy of a cache.  The kernel itself runs on the card only
(``tests/test_torch_gpu.py``).  Tolerances as in
``tests/test_torch_family_attention.py``: 1e-4 of the largest magnitude
in float32."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro.models import layers as JL
from repro.models.config import ModelConfig as RefConfig

from repro_torch.kernels.decode_attention import kernel as da
from repro_torch.kernels.decode_attention.ref import (
    reference_decode_attention, valid_keys)
from repro_torch.models import layers as PL
from test_torch_families import F32, _draw, _np, _rel
from test_torch_lm import to_port_config

_BASE = RefConfig(name="decode_tiny", family="dense", n_layers=1,
                  d_model=64, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=64,
                  vocab_size=32, remat=False)
#: case -> (config changes, local, cache depth, the token's position)
CASES = {
    "mha_hd64_first": (dict(n_kv_heads=4), False, 24, 0),
    "gqa_hd128_middle": (dict(head_dim=128), False, 24, 11),
    "mqa_hd256_last": (dict(n_kv_heads=1, head_dim=256), False, 24, 23),
    "softcap": (dict(attn_softcap=5.0), False, 24, 17),
    "ring_past_the_window": (dict(sliding_window=8, attn_softcap=5.0), True,
                             8, 20),
    "ring_filling": (dict(sliding_window=8), True, 8, 5),
    "linear_with_a_window": (dict(sliding_window=8), True, 24, 19),
}


def _case(name, rng):
    """The case's reference config, its port config, whether the layer is
    local, and numpy k/v caches, the token and its position."""
    kw, local, depth, at = CASES[name]
    cfg = dataclasses.replace(_BASE, **kw)
    shape = (2, depth, cfg.n_kv_heads, cfg.hd)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    return cfg, to_port_config(cfg), local, k, v, x, at


def _branch_before_the_kernel(q, ck, cv, idx, *, ring, window, softcap):
    """``models.layers.attention``'s one-token branch as it stood before
    the decode-attention kernel, frozen here: the plain version must
    compute the same bits."""
    b, s, h, hd = q.shape
    t, kvh = ck.shape[1], ck.shape[2]
    kpos = torch.arange(t)[None, :]
    if ring:
        valid = kpos < torch.clamp(idx + s, max=t)
    else:
        qpos = idx + torch.arange(s)[:, None]
        valid = PL._mask(qpos, kpos, True, window)
    qg = q.transpose(1, 2).reshape(b, kvh, h // kvh, s, hd)
    sqrt_hd = torch.full((), math.sqrt(hd), dtype=torch.float32)
    sc = torch.einsum("bkgqd,btkd->bkgqt", qg.to(torch.float32),
                      ck.to(torch.float32)) / sqrt_hd
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    sc = torch.where(valid[None, None, None], sc, PL.NEG_INF)
    o = torch.einsum("bkgqt,btkd->bkgqd", PL.softmax(sc),
                     cv.to(torch.float32))
    return o.reshape(b, h, s, hd).transpose(1, 2).to(q.dtype)


def _opts(pcfg, local, depth):
    window = pcfg.sliding_window if local else None
    return dict(ring=window is not None and depth == window, window=window,
                softcap=pcfg.attn_softcap or None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_is_the_branch_it_replaced(case, dtype):
    """The operator's CPU implementation, the plain version and the
    layer's CPU route (``_decode_attend``) compute bitwise what the decode
    branch computed before the kernel."""
    rng = np.random.default_rng(len(case))
    _, pcfg, local, k, v, _, at = _case(case, rng)
    q = torch.from_numpy(rng.standard_normal(
        (2, 1, pcfg.n_heads, pcfg.hd)).astype(np.float32)).to(dtype)
    k, v = torch.from_numpy(k).to(dtype), torch.from_numpy(v).to(dtype)
    idx = torch.tensor(at, dtype=torch.int32)
    opts = _opts(pcfg, local, k.shape[1])
    want = _branch_before_the_kernel(q, k, v, idx, **opts)
    assert want.dtype == dtype
    got = [reference_decode_attention(q, k, v, idx, **opts),
           torch.ops.repro_torch.decode_attention(q, k, v, idx,
                                                  *opts.values()),
           da.decode_attention(q, k, v, idx, **opts),
           PL._decode_attend(q, k, v, idx, **opts)]
    for g in got:
        assert g.shape == want.shape and torch.equal(g, want)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_step_matches_the_reference(case):
    """A decode step of ``attention`` over filled caches against the JAX
    package's, outputs and caches; the same step ``in_place`` writes the
    caches it was given and computes the same bits."""
    rng = np.random.default_rng(len(case) + 7)
    cfg, pcfg, local, k, v, x, at = _case(case, rng)
    p, _ = JL.init_attention(jax.random.PRNGKey(1), cfg)
    p = _draw(jax.tree.map(np.asarray, p), np.random.default_rng(2), True)
    pp = {n: torch.from_numpy(z) for n, z in p.items()}
    pos = np.full((1, 1), at, np.int32)
    want, jc = jax.jit(lambda p, x, c, pos: JL.attention(
        p, x, cfg, local=local, cache=c, positions=pos))(
        p, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                            "idx": jnp.asarray(at, jnp.int32)}, pos)

    def cache():
        return {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(
            v.copy()), "idx": torch.tensor(at, dtype=torch.int32)}

    def port(c, in_place):
        return PL.attention(pp, torch.from_numpy(x), pcfg, local=local,
                            cache=c, positions=torch.from_numpy(pos),
                            in_place=in_place)

    got, pc = port(cache(), False)
    _rel(got, _np(want), F32)
    for key in ("k", "v"):
        _rel(pc[key], _np(jc[key]), F32)
    assert int(pc["idx"]) == int(jc["idx"]) == at + 1
    given = cache()
    same, ic = port(given, True)
    assert torch.equal(same, got)
    for key in ("k", "v"):
        assert ic[key] is given[key] and torch.equal(ic[key], pc[key])


def test_fake_operator_shape_dtype_and_flops():
    """On fake tensors the operator makes the output's shape and dtype; its
    FLOP formula is what ``FlopCounterMode`` counts for the plain
    version's two products, over the cache's whole length."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, t, h, hkv, hd = 3, 40, 8, 2, 64
    with FakeTensorMode():
        q = torch.empty((b, 1, h, hd), dtype=torch.bfloat16)
        k = torch.empty((b, t, hkv, hd), dtype=torch.bfloat16)
        idx = torch.empty((), dtype=torch.int32)
        out = torch.ops.repro_torch.decode_attention(q, k, k, idx, False,
                                                     None, 50.0)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((b, t, hkv, hd)).astype(
        np.float32))
    idx = torch.tensor(t - 5, dtype=torch.int32)
    with FlopCounterMode(display=False) as op:
        torch.ops.repro_torch.decode_attention(q, k, k, idx, False, None,
                                               None)
    with FlopCounterMode(display=False) as plain:
        reference_decode_attention(q, k, k, idx)
    assert op.get_total_flops() == plain.get_total_flops() \
        == da.decode_ops(q.shape, k.shape) == 4 * b * h * t * hd


def test_split_count_follows_the_shapes():
    """The split count on an H100's 132 SMs at the benchmark's served
    shapes (OLMoE-1B-7B chat and rag, Jamba-v0.1 chat, whose group of 4
    takes two blocks of 2 heads): fewer (row, head) pairs take more
    splits, no launch gives an SM more than ``BLOCKS_PER_SM`` blocks but
    with one split, and no split is shorter than ``MIN_SPLIT_BYTES``."""
    chat = da.split_count(32, 16, 1, 1280, 128, 2, 132)
    rag = da.split_count(8, 16, 1, 3600, 128, 2, 132)
    jamba = da.split_count(32, 8, 4, 1280, 128, 2, 132)
    assert (chat, rag, jamba) == (1, 4, 1)
    for blocks, n in ((32 * 16, chat), (8 * 16, rag), (32 * 8 * 2, jamba)):
        assert n == 1 or blocks * n <= da.BLOCKS_PER_SM * 132
    assert da.split_count(1, 1, 1, 100, 128, 2, 132) == 1
    assert da.split_count(1, 1, 1, 200, 128, 2, 132) == 3
    assert da.split_count(1, 1, 16, 4096, 128, 4, 132) == 66
    assert [da.heads_per_block(g) for g in (1, 2, 3, 4, 6, 12, 16)] == \
        [1, 2, 1, 2, 2, 2, 2]


@pytest.mark.parametrize("ring,window,at,valid", [
    (False, None, 9, 10), (False, 4, 9, 4), (True, 16, 9, 10),
    (True, 16, 40, 16), (False, None, 0, 1)])
def test_decode_bytes_count_the_valid_keys(ring, window, at, valid):
    """The bytes a call must move: the valid keys and values (as
    ``valid_keys`` marks them), q and the output."""
    t = 16
    mask = valid_keys(torch.tensor(at), t, ring=ring, window=window)
    assert int(mask.sum()) == valid
    got = da.decode_bytes((2, 1, 8, 64), (2, t, 4, 64), 2, at, ring=ring,
                          window=window)
    assert got == (2 * 2 * valid * 4 * 64 + 2 * 2 * 8 * 64) * 2


class _Writes(TorchDispatchMode):
    """Records the shape of every tensor an operation (not a view) makes
    or writes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self.ops += [(str(func), tuple(o.shape)) for o in outs
                         if isinstance(o, torch.Tensor)]
        return out


def test_serve_decode_in_place_copies_no_cache():
    """``serve_decode(in_place=True)`` over the dense model's caches: step
    after step every leaf keeps its storage, the keys and values go in by
    ``index_copy_`` where they lie, and no operation makes or writes a
    tensor of a whole cache's shape but that write (the functional step
    copies each cache at its write)."""
    import test_torch_lm as lm
    from repro_torch.launch import serve
    from repro_torch.models import transformer as PT
    pparams = PT.init_params(lm.PCFG, torch.Generator().manual_seed(0),
                             "cpu")
    _, caches = PT.serve_prefill(pparams, lm.TOKENS, lm.PCFG, lm.MAX_SEQ)
    ptrs = [z.data_ptr() for z in serve._leaves(caches)]
    shape = tuple(caches["l0"]["k"].shape[1:])
    for step in range(3):
        tok = np.asarray([[5 + step], [11 + step]], np.int32)
        with _Writes() as w:
            _, same = PT.serve_decode(pparams, caches, tok, lm.PCFG,
                                      in_place=True)
        assert same is caches
        assert [z.data_ptr() for z in serve._leaves(caches)] == ptrs
        whole = [op for op, s in w.ops if s == shape]
        n_attn = 2 * lm.PCFG.n_layers        # k and v of each layer
        assert whole == ["aten.index_copy_.default"] * n_attn, whole
    with _Writes() as w:
        PT.serve_decode(pparams, caches, tok, lm.PCFG)
    assert [op for op, s in w.ops if s == shape] == \
        ["aten.index_copy.default"] * n_attn
