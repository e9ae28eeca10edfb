"""The port's RWKV6 serving path against the JAX package, on the CPU.

Kernel B7 (the chunk algebra, ``ops.rwkv6_chunked``) and kernel B6's state
form (``ops.rwkv6``) run their plain versions on CPU tensors; the CUDA
kernels are held to those on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  The same numpy inputs go through the JAX Pallas
kernels in interpret mode, the JAX ``ref.py``, and the port.  Then the
RWKV6 mixer, the direct model (forward, prefill, decode) and the serving
launcher at the SMOKE config of ``rwkv6-3b``, on the JAX package's own
weights (``params_from_numpy``) with the norm gains drawn around 1 (the
reference's zero gains would zero every activation).

Tolerances.  B7's plain version against the Pallas ``rwkv6_chunked``, the
same algebra in float32 with sums in other orders: ``TIGHT`` (2e-5;
measured at most 5.7e-6 on outputs of order 20).  Against the token loop
``reference_rwkv6``: the reference's own 2e-3 (``tests/test_kernels.py``).
B6's state form: the scans' 3e-4.  Gradients: 1e-4 as for B3-B6.  The
model in float32: ``F32_MODEL`` (1e-4 of the largest logit; measured 1.7e-6
of 4.5: the prompt's recurrence runs chunked in the port and as a loop in
the reference).  The model in bfloat16, as published: both packages round
at other places (XLA under jit keeps some intermediates in float32), and
each sits about 6% of the largest logit from the same model in float32, so
they are held to ``BF16_MODEL``, 0.1 of the largest magnitude (measured
3.6%).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.rwkv6_scan.kernel_chunked import rwkv6_chunked as j_chunked
from repro.kernels.rwkv6_scan.ref import reference_rwkv6 as j_ref
from repro.models import layers as JL
from repro.models import transformer as T

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.rwkv6_scan.ops import rwkv6, rwkv6_chunked
from repro_torch.kernels.rwkv6_scan.ref import (reference_rwkv6,
                                                reference_rwkv6_chunked)
from repro_torch.launch import serve
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from test_torch_lm import to_port_config

TIGHT = dict(rtol=2e-5, atol=2e-5)
LOOP = dict(rtol=2e-3, atol=2e-3)
SCAN = dict(rtol=3e-4, atol=3e-4)
GRAD = dict(rtol=1e-4, atol=1e-4)
F32_MODEL = 1e-4
BF16_MODEL = 0.1
MAX_SEQ = 64


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(seed, bh, t, n, heads=None):
    """``tests/test_kernels.py``'s distributions: decays in (0.45, 0.95), a
    bonus of scale 0.1 (per head when ``heads`` is given)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / (1.0 + np.exp(-_normal(rng, (bh, t, n)))) * 0.5 + 0.45
    return (_normal(rng, (bh, t, n)), _normal(rng, (bh, t, n), 0.3),
            _normal(rng, (bh, t, n)), w.astype(np.float32),
            _normal(rng, (n,) if heads is None else (heads, n), 0.1))


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, *wants, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    for want in wants:
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), **tol)


def _per_head_ref(r, k, v, w, u, heads, state=None):
    """The JAX reference run head by head, as the reference model's
    ``_rwkv_heads`` does: rows ``b·H + h`` take ``u[h]``."""
    bh, t, n = r.shape
    o = np.zeros((bh, t, n), np.float32)
    s = np.zeros((bh, n, n), np.float32)
    for h in range(heads):
        rows = np.arange(h, bh, heads)
        s0 = None if state is None else jnp.asarray(state[rows])
        oh, sh = j_ref(*_jax(r[rows], k[rows], v[rows], w[rows], u[h]),
                       state=s0, return_state=True)
        o[rows], s[rows] = np.asarray(oh), np.asarray(sh)
    return o, s


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def test_rwkv6_3b_config_is_the_reference():
    from repro.configs import rwkv6_3b as ref
    from repro_torch.configs import rwkv6_3b as port
    for name in ("CONFIG", "SMOKE"):
        assert to_port_config(getattr(ref, name)) == getattr(port, name)
    cfg = port.CONFIG
    assert (cfg.n_layers, cfg.d_model, cfg.d_model // cfg.rwkv.head_dim,
            cfg.rwkv.head_dim, cfg.d_ff, cfg.vocab_size) \
        == (32, 2560, 40, 64, 8960, 65536)
    assert cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen1.5-4b"])
def test_get_config_matches_reference(arch, smoke):
    assert arch in ARCHS
    assert get_config(arch, smoke) == to_port_config(ref_get_config(arch,
                                                                     smoke))
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")


def test_direct_model_admits_rwkv_and_names_what_it_lacks():
    PT.validate_config(get_config("rwkv6-3b"))                 # bfloat16
    PT.validate_config(get_config("rwkv6-3b", smoke=True))
    # the attention families, MoE and Mamba run as published
    PT.validate_config(get_config("qwen1.5-4b", smoke=True))
    for arch, kind in (("olmoe-1b-7b", "moe"),
                       ("qwen3-moe-235b-a22b", "moe"),
                       ("jamba-v0.1-52b", "mamba")):
        for smoke in (False, True):
            cfg = get_config(arch, smoke)
            PT.validate_config(cfg)
            assert kind in {k for pair in cfg.layer_pattern() for k in pair}
    rwkv = get_config("rwkv6-3b", smoke=True)
    with pytest.raises(ValueError, match="RWKV head size"):
        PT.validate_config(dataclasses.replace(rwkv, d_model=48))
    # the lazy lane keeps refusing rwkv and what it refused before
    from repro_torch.models.lazy_transformer import validate_config
    with pytest.raises(ValueError, match="attn\\+mlp"):
        validate_config(rwkv)
    qwen = get_config("qwen1.5-4b", smoke=True)
    with pytest.raises(ValueError, match="dtype"):
        validate_config(qwen)
    with pytest.raises(ValueError, match="qkv_bias"):
        validate_config(dataclasses.replace(qwen, dtype="float32"))


def test_launcher_refuses_an_arch_the_direct_model_lacks(capsys):
    """Every registered arch is served (MoE ones included); a name outside
    the registry is refused by the argument parser."""
    serve.main(["--arch", "olmoe-1b-7b", "--device", "cpu", "--requests",
                "2", "--batch", "2", "--new-tokens", "2"])
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "[serve] 2 requests, 4 tokens")
    with pytest.raises(SystemExit):
        serve.main(["--arch", "no-such-arch", "--device", "cpu"])
    assert "invalid choice" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# B7: the chunk algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,t,n,chunk", [(2, 64, 32, 16), (4, 128, 64, 32),
                                          (1, 100, 64, 32)])
def test_rwkv6_chunked_matches_pallas_and_loop(bh, t, n, chunk):
    ins = _inputs(7 + bh + t + n, bh, t, n)
    got = rwkv6_chunked(*_torch(*ins), chunk)
    assert got.shape == (bh, t, n) and got.dtype == torch.float32
    _close(got, j_chunked(*_jax(*ins), chunk=chunk, interpret=True),
           tol=TIGHT)
    _close(got, j_ref(*_jax(*ins)), tol=LOOP)


@pytest.mark.parametrize("bh,t,n,chunk", [(2, 64, 32, 16), (4, 128, 64, 32),
                                          (1, 100, 64, 32)])
def test_rwkv6_chunked_state_in_and_out(bh, t, n, chunk):
    ins = _inputs(20 + t, bh, t, n)
    s0 = _normal(np.random.default_rng(21), (bh, n, n), 0.5)
    o, s = rwkv6_chunked(*_torch(*ins), chunk, state=torch.from_numpy(s0),
                         return_state=True)
    jo, js = j_ref(*_jax(*ins), state=jnp.asarray(s0), return_state=True)
    _close(o, jo, tol=LOOP)
    _close(s, js, tol=LOOP)
    # no state in: zeros; a prompt split in two carries its state across
    half = t // 2
    o1, s1 = rwkv6_chunked(*(z[:, :half] for z in _torch(*ins[:4])),
                           _torch(ins[4])[0], chunk, return_state=True)
    o2 = rwkv6_chunked(*(z[:, half:] for z in _torch(*ins[:4])),
                       _torch(ins[4])[0], chunk, state=s1)
    _close(torch.cat([o1, o2], dim=1), j_ref(*_jax(*ins)), tol=LOOP)


@pytest.mark.parametrize("bh,t,n,chunk", [(2, 64, 32, 16), (4, 128, 64, 32),
                                          (1, 100, 64, 32)])
def test_rwkv6_chunked_per_head_bonus(bh, t, n, chunk):
    heads = 2 if bh % 2 == 0 else 1
    ins = _inputs(30 + t, bh, t, n, heads=heads)
    s0 = _normal(np.random.default_rng(31), (bh, n, n), 0.5)
    o, s = rwkv6_chunked(*_torch(*ins), chunk, state=torch.from_numpy(s0),
                         return_state=True)
    want_o, want_s = _per_head_ref(*ins, heads, state=s0)
    _close(o, want_o, tol=LOOP)
    _close(s, want_s, tol=LOOP)


def _vjp_per_head(ins, s0, go, gs):
    """``jax.vjp`` of the JAX reference run head by head with a state in
    and out (rows ``h`` take ``u[h]``), at the cotangents ``go``, ``gs``."""
    heads = ins[4].shape[0]

    def fn(r, k, v, w, u, s):
        rows = [j_ref(r[h:h + 1], k[h:h + 1], v[h:h + 1], w[h:h + 1], u[h],
                      state=s[h:h + 1], return_state=True)
                for h in range(heads)]
        return (jnp.concatenate([a for a, _ in rows]),
                jnp.concatenate([b for _, b in rows]))

    _, vjp = jax.vjp(fn, *_jax(*ins, s0))
    return vjp((jnp.asarray(go), jnp.asarray(gs)))


@pytest.mark.parametrize("op,t", [(rwkv6_chunked, 40), (rwkv6, 5)],
                         ids=["chunked", "scan"])
def test_gradients_with_state_and_per_head_bonus(op, t):
    ins = _inputs(40 + t, 2, t, 32, heads=2)
    s0 = _normal(np.random.default_rng(41), (2, 32, 32), 0.5)
    rng = np.random.default_rng(42)
    go, gs = _normal(rng, (2, t, 32)), _normal(rng, (2, 32, 32))
    want = _vjp_per_head(ins, s0, go, gs)
    tins = [z.requires_grad_() for z in _torch(*ins, s0)]
    o, s = op(*tins[:5], 8, state=tins[5], return_state=True)
    torch.autograd.backward([o, s], [torch.from_numpy(go),
                                     torch.from_numpy(gs)])
    for z, w in zip(tins, want):
        _close(z.grad, w, tol=GRAD)


def test_rwkv6_chunked_gradients_without_state():
    ins = _inputs(13, 2, 16, 32)
    g = _normal(np.random.default_rng(14), ins[0].shape)
    _, vjp = jax.vjp(j_ref, *_jax(*ins))
    want = vjp(jnp.asarray(g))
    tins = [z.requires_grad_() for z in _torch(*ins)]
    rwkv6_chunked(*tins, 8).backward(torch.from_numpy(g))
    for z, w in zip(tins, want):
        _close(z.grad, w, tol=GRAD)


def test_rwkv6_chunked_takes_bf16_rkv_with_float32_decay():
    r, k, v, w, u = _torch(*_inputs(50, 2, 70, 32, heads=2))
    rb, kb, vb = (z.to(torch.bfloat16) for z in (r, k, v))
    o = rwkv6_chunked(rb, kb, vb, w, u)
    assert o.dtype == torch.bfloat16
    want = reference_rwkv6(rb, kb, vb, w, u)
    torch.testing.assert_close(o.float(), want.float(), rtol=2.0 ** -7,
                               atol=3e-4)


def test_chunked_leaves_the_loop_below_the_float32_range_of_one_over_cum():
    """ROADMAP C11 (reference-side): at decays below about 0.066 a
    channel's product over a 32-token chunk leaves float32's normal range,
    ``k/Cum`` overflows, and the chunk algebra of the TPU kernel (and of
    B7, which keeps its algebra) leaves the token loop's result."""
    r, k, v, w, u = _inputs(60, 1, 64, 32)
    w = np.full_like(w, 0.05)                  # 0.05**32 ~ 2e-42
    want = np.asarray(j_ref(*_jax(r, k, v, w, u)))
    assert np.all(np.isfinite(want))
    got = rwkv6_chunked(*_torch(r, k, v, w, u)).numpy()
    pallas = np.asarray(j_chunked(*_jax(r, k, v, w, u), interpret=True))
    for z in (got, pallas):
        bad = ~np.isfinite(z) | (np.abs(z - want) > 1.0)
        assert bad.any()
    # at the decays of RWKV6's published initialisation it holds
    w_init = np.full_like(w, np.exp(-np.exp(-1.0)))        # 0.69
    _close(rwkv6_chunked(*_torch(r, k, v, w_init, u)),
           j_ref(*_jax(r, k, v, w_init, u)), tol=LOOP)


# ---------------------------------------------------------------------------
# B6: the state form and the per-head bonus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 20])
def test_rwkv6_state_form_and_per_head_bonus(t):
    bh, n, heads = 6, 32, 3
    ins = _inputs(70 + t, bh, t, n, heads=heads)
    s0 = _normal(np.random.default_rng(71), (bh, n, n), 0.5)
    o, s = rwkv6(*_torch(*ins), 64, state=torch.from_numpy(s0),
                 return_state=True)
    want_o, want_s = _per_head_ref(*ins, heads, state=s0)
    _close(o, want_o, tol=SCAN)
    _close(s, want_s, tol=SCAN)
    one = rwkv6(*_torch(*ins[:4]), _torch(ins[4][0])[0], 64)
    _close(one, j_ref(*_jax(*ins[:4], ins[4][0])), tol=SCAN)


def test_rwkv6_scan_writes_the_final_state_in_place():
    """B6's ``out_state``: the final state written into a given tensor, the
    initial state's own storage included, equal to the returned one."""
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan
    bh, n = 4, 32
    ins = _torch(*_inputs(80, bh, 1, n, heads=2))
    s0 = torch.from_numpy(_normal(np.random.default_rng(81), (bh, n, n)))
    want_o, want_s = rwkv6_scan(*ins, state=s0, return_state=True)
    inplace = s0.clone()
    o, s = rwkv6_scan(*ins, state=inplace, out_state=inplace)
    assert s is inplace and torch.equal(s, want_s) and torch.equal(o, want_o)
    _close(s, _per_head_ref(*(z.numpy() for z in ins), 2,
                            state=s0.numpy())[1], tol=SCAN)


def test_rwkv6_op_writes_the_state_in_place_without_gradient():
    """``ops.rwkv6(..., out_state=)``, serving's in-place form: the
    kernel's result, and refused where a gradient is wanted."""
    bh, n = 4, 32
    ins = _torch(*_inputs(82, bh, 1, n, heads=2))
    s0 = torch.from_numpy(_normal(np.random.default_rng(83), (bh, n, n)))
    want_o, want_s = rwkv6(*ins, state=s0, return_state=True)
    inplace = s0.clone()
    o, s = rwkv6(*ins, state=inplace, out_state=inplace)
    assert s is inplace and torch.equal(s, want_s) and torch.equal(o, want_o)
    r = ins[0].clone().requires_grad_()
    with pytest.raises(ValueError, match="takes no gradient"):
        rwkv6(r, *ins[1:], state=s0.clone(), out_state=s0.clone())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _with_gains(tree, rng):
    """The reference's tree with every norm gain drawn around 1 (its zero
    init would zero every activation of a plain-``g`` config)."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out[key] = _with_gains(v, rng)
        elif key == "g":
            out[key] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        else:
            out[key] = np.asarray(v)
    return out


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    """(JAX config, port config, JAX params, port params, tolerance): the
    ``rwkv6-3b`` SMOKE config in float32 or in the published bfloat16."""
    from repro.configs import rwkv6_3b
    cfg = rwkv6_3b.SMOKE.scaled(dtype=request.param)
    params, _ = T.init_params(cfg, jax.random.PRNGKey(0))
    params = _with_gains(jax.tree.map(np.asarray, params),
                         np.random.default_rng(1))
    tol = F32_MODEL if request.param == "float32" else BF16_MODEL
    return (cfg, to_port_config(cfg), params,
            PT.params_from_numpy(params, "cpu"), tol)


def _rel(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float32) - want).max()) / scale
    assert err <= tol, (err, tol)


TOKENS = np.random.default_rng(2).integers(0, 128, (2, 40)).astype(np.int32)


def test_init_params_tree_matches_reference(model):
    cfg, pcfg, params, _, _ = model
    mine = PT.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    got = jax.tree_util.tree_structure(jax.tree.map(lambda t: 0, mine))
    assert got == jax.tree_util.tree_structure(
        jax.tree.map(lambda a: 0, params))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(mine)):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype), path
    lp = mine["groups"]["l0"]["mixer"]
    assert torch.all(lp["w0"] == -6.0) and torch.all(lp["ln_g"] == 1.0)
    assert lp["w_a"].shape[-1] == max(32, pcfg.d_model // 32)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_mixer_matches_reference(model, with_state):
    cfg, pcfg, params, pparams, tol = model
    lp = jax.tree.map(lambda a: a[0], params["groups"]["l0"]["mixer"])
    plp = {k: v[0] for k, v in pparams["groups"]["l0"]["mixer"].items()}
    rng = np.random.default_rng(3)
    x = _normal(rng, (2, 37, cfg.d_model))
    heads, n = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    state = None
    if with_state:
        state = {"last": _normal(rng, (2, cfg.d_model)),
                 "wkv": _normal(rng, (2, heads, n, n), 0.5)}
    jx = jnp.asarray(x).astype(cfg.compute_dtype)
    jstate = None if state is None else {
        "last": jnp.asarray(state["last"]).astype(cfg.compute_dtype),
        "wkv": jnp.asarray(state["wkv"])}
    want, wst = jax.jit(lambda p, x, s: JL.rwkv_mixer(p, x, cfg, state=s))(
        lp, jx, jstate)
    px = torch.from_numpy(x).to(pcfg.compute_dtype)
    pstate = None if state is None else {
        "last": torch.from_numpy(state["last"]).to(pcfg.compute_dtype),
        "wkv": torch.from_numpy(state["wkv"])}
    got, gst = PL.rwkv_mixer(plp, px, pcfg, state=pstate)
    assert got.dtype == pcfg.compute_dtype
    _rel(got, np.asarray(want, np.float32), tol)
    if with_state:
        _rel(gst["wkv"], wst["wkv"], tol)
        _rel(gst["last"], np.asarray(wst["last"], np.float32), tol)
        assert gst["last"].dtype == pcfg.compute_dtype
    else:
        assert gst is None and wst is None


def test_direct_forward_matches_jitted_reference(model):
    cfg, pcfg, params, pparams, tol = model
    want = jax.jit(lambda p, t: T.forward(p, t, cfg)[0])(params, TOKENS)
    got, aux = PT.forward(pparams, TOKENS, pcfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _rel(got, want, tol)


def test_direct_prefill_and_decode_match_jitted_reference(model):
    cfg, pcfg, params, pparams, tol = model
    want_l, want_c = jax.jit(lambda p, t: T.serve_prefill(
        p, t, cfg, MAX_SEQ))(params, TOKENS)
    got_l, got_c = PT.serve_prefill(pparams, TOKENS, pcfg, MAX_SEQ)
    _rel(got_l, want_l, tol)
    dec = jax.jit(lambda p, c, t: T.serve_decode(p, c, t, cfg))
    for step in range(3):
        tok = np.asarray([[5 + step], [11 + step]], np.int32)
        want_l, want_c = dec(params, want_c, tok)
        got_l, got_c = PT.serve_decode(pparams, got_c, tok, pcfg)
        _rel(got_l, want_l, tol)
    for key in ("last", "wkv"):
        assert got_c["l0"][key].shape == want_c["l0"][key].shape
        _rel(got_c["l0"][key], np.asarray(want_c["l0"][key], np.float32),
             tol)
    assert got_c["l0"]["wkv"].dtype == torch.float32
    assert got_c["l0"]["last"].dtype == pcfg.compute_dtype


def test_init_cache_rwkv_entry_matches_reference(model):
    cfg, pcfg, _, _, _ = model
    want = T.init_cache(cfg, 3, MAX_SEQ, dtype=cfg.compute_dtype)
    got = PT.init_cache(pcfg, 3, MAX_SEQ, dtype=pcfg.compute_dtype,
                        device="cpu")
    assert set(got) == set(want) and set(got["l0"]) == {"last", "wkv"}
    for key in ("last", "wkv"):
        assert tuple(got["l0"][key].shape) == want["l0"][key].shape
        assert str(got["l0"][key].dtype).removeprefix("torch.") \
            == str(want["l0"][key].dtype)


def test_decode_after_prefill_equals_longer_prefill(model):
    """Prefill(P) then k decode tokens (B6 carrying the state) gives the
    last logits of prefill(P + k tokens) (B7 over the whole prompt)."""
    _, pcfg, _, pparams, tol = model
    extra = np.asarray([[7, 9, 3], [1, 2, 100]], np.int32)
    logits, cache = PT.serve_prefill(pparams, TOKENS, pcfg, MAX_SEQ)
    for i in range(extra.shape[1]):
        logits, cache = PT.serve_decode(pparams, cache, extra[:, i:i + 1],
                                        pcfg)
    want, _ = PT.serve_prefill(pparams, np.concatenate([TOKENS, extra], 1),
                               pcfg, MAX_SEQ)
    _rel(logits, want.float().numpy(), tol / 10 if tol == F32_MODEL
         else tol)


def test_serve_requests_is_the_plain_loop(model):
    _, pcfg, _, pparams, _ = model
    prompts = serve.draw_prompts(0, 5, 24, pcfg.vocab_size)
    assert len({len(p) for p in prompts}) > 1        # ragged
    tokens, times = serve.serve_requests(pcfg, pparams, prompts, batch=2,
                                         max_prompt=24, new_tokens=4)
    assert [t["batch"] for t in times] == [2, 2, 1]
    assert all(len(t["decode_s"]) == 3 for t in times)
    assert len(tokens) == 5
    for start in range(0, 5, 2):
        toks = np.zeros((2, 24), np.int32)
        for i, p in enumerate(prompts[start:start + 2]):
            toks[i, 24 - len(p):] = p
        logits, cache = PT.serve_prefill(pparams, toks, pcfg, 28)
        want = [logits[:, -1].argmax(-1)]
        for _ in range(3):
            logits, cache = PT.serve_decode(
                pparams, cache, want[-1][:, None].to(torch.int32), pcfg)
            want.append(logits[:, -1].argmax(-1))
        want = torch.stack(want, 1).numpy()
        for i, got in enumerate(tokens[start:start + 2]):
            np.testing.assert_array_equal(got, want[i])


def test_launcher_serves_the_smoke_config_on_the_cpu(capsys):
    serve.main(["--arch", "rwkv6-3b", "--requests", "3", "--batch", "2",
                "--new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("[serve] batch of") for line in out) == 2
    assert out[-1].startswith("[serve] 3 requests, 9 tokens")
