"""The MoE layer and the Mamba mixer against the JAX package on the CPU:
``models.layers.moe`` against ``repro.models.layers.moe`` (the grouped
dispatch within one group and over two, a capacity small enough that
tokens drop, one decode token, a shared expert; the output, the aux loss
and the experts each token is sent to), ``mamba_mixer`` against the
reference's (without a state, from a zero state, one decode token after a
prefill; the output and the carried ``conv`` / ``ssm`` state),
``init_mamba``'s deterministic leaves, kernel B5's state in and out through
its wrapper and op (their plain version on CPU tensors) against the
reference's ``reference_mamba(state=, return_state=True)``, and
``serving_params`` on the three MoE / Mamba configs.  Inputs come from
``np.random.default_rng``, weights are the JAX package's own.  Tolerances
are ``tests/test_torch_families.py``'s: 1e-4 of the largest magnitude in
float32, 0.1 in bfloat16; B5's state form 3e-4, the reference's scan
tolerance (``tests/test_kernels.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels.mamba_scan.ref import reference_mamba as j_mamba_ref
from repro.models import layers as JL

from repro_torch.kernels.mamba_scan import kernel as mk
from repro_torch.kernels.mamba_scan.ops import mamba
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from test_torch_families import DTYPES, TOL, _np, _rel
from test_torch_lm import to_port_config

#: the reference's scan tolerance (``tests/test_kernels.py``)
SCAN = 3e-4
_TOP_K = jax.lax.top_k


def _tree(p):
    return jax.tree.map(np.array, p)


def _torch_tree(p):
    return PT.params_from_numpy(p, "cpu")


def _jamba(dtype, **kw):
    """Jamba-v0.1's SMOKE config (d_model 64, 4 experts top-2, d_state 8)
    in ``dtype``."""
    return RC.get_config("jamba-v0.1-52b", smoke=True).scaled(dtype=dtype,
                                                              **kw)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

#: case -> (tokens a row, MoE config changes): one group below 512 tokens
#: with a capacity of 6 a group (int(0.5 · 20 · 2 / 4) + 1) against the 10
#: tokens an expert takes on average, so tokens drop; two groups of 512 at
#: the published 1.25; one decode token (capacity 1 an expert); a shared
#: expert beside the routed ones
_MOE_CASES = {
    "drops": (20, dict(capacity_factor=0.5)),
    "two_groups": (1024, {}),
    "decode": (1, {}),
    "shared": (20, dict(n_shared_experts=2)),
}


def _moe_cfg(case, dtype):
    s, kw = _MOE_CASES[case]
    base = _jamba(dtype)
    return s, base.scaled(moe=dataclasses.replace(base.moe, **kw))


def _dropped(x, router, cfg):
    """Token-expert pairs past their expert's capacity, in numpy from the
    float32 router: the count the reference drops."""
    m = cfg.moe
    b, s, d = x.shape
    s_g = min(s, JL.MOE_GROUP_TOKENS)
    xg = x.reshape(-1, s_g, d).astype(np.float64)
    logits = xg @ router.astype(np.float64)
    idx = np.argsort(-logits, axis=-1)[..., :m.top_k]
    onehot = (idx[..., None] == np.arange(m.n_experts)).sum(2)
    pos = np.cumsum(onehot, axis=1) - onehot
    cap = int(m.capacity_factor * s_g * m.top_k / m.n_experts) + 1
    return int((onehot * (pos >= cap)).sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(_MOE_CASES))
def test_moe_matches_reference(case, dtype, monkeypatch):
    """``moe``'s output and aux loss against ``JL.moe`` on the same
    weights and inputs, and the experts each token is sent to (the top-k
    indices of both packages) equal."""
    s, cfg = _moe_cfg(case, dtype)
    pcfg = to_port_config(cfg)
    p = _tree(JL.init_moe(jax.random.PRNGKey(3), cfg)[0])
    x = np.random.default_rng(4).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    want_idx, got_idx = [], []

    def j_top_k(v, k):
        vals, idx = _TOP_K(v, k)
        want_idx.append(idx)
        return vals, idx

    real = torch.topk

    def p_top_k(v, k):
        out = real(v, k)
        got_idx.append(out[1])
        return out

    monkeypatch.setattr(jax.lax, "top_k", j_top_k)
    want, want_aux = JL.moe(p, jnp.asarray(x).astype(cfg.compute_dtype), cfg)
    monkeypatch.setattr(torch, "topk", p_top_k)
    got, aux = PL.moe(_torch_tree(p), torch.from_numpy(x).to(
        pcfg.compute_dtype), pcfg)
    monkeypatch.undo()
    assert got.dtype == pcfg.compute_dtype and aux.dtype == torch.float32
    _rel(got, _np(want), TOL[dtype])
    _rel(aux.reshape(1), np.asarray(want_aux).reshape(1), TOL[dtype])
    assert len(want_idx) == len(got_idx) == 1
    np.testing.assert_array_equal(got_idx[0].numpy(),
                                  np.asarray(want_idx[0]))
    if case == "drops":
        assert _dropped(x, p["router"], cfg) > 0
    if case == "shared":
        assert p["shared"]["w_gate"].shape == (cfg.d_model,
                                               2 * cfg.moe.d_expert)
        assert PL.init_moe(None, pcfg, "meta")["shared"]["w_up"].shape \
            == p["shared"]["w_up"].shape


def test_moe_refuses_a_length_off_its_groups():
    """Above 512 tokens a row must be a multiple of 512, as the reference
    asserts; the launcher refuses such a ``max_prompt`` up front."""
    from repro_torch.launch import serve
    cfg = to_port_config(_jamba("float32"))
    p = PL.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(AssertionError):
        PL.moe(p, torch.zeros((1, 600, cfg.d_model)), cfg)
    with pytest.raises(ValueError, match="groups of 512"):
        serve.serve_requests(cfg, {"embed": torch.zeros(1)}, [], batch=1,
                             max_prompt=600, new_tokens=1)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _mamba_layer(cfg):
    return _tree(JL.init_mamba(jax.random.PRNGKey(5), cfg)[0])


def _conv_and_ssm(cfg, b, rng):
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    return {"conv": rng.standard_normal((b, m.d_conv - 1, d_in)).astype(
                np.float32),
            "ssm": (0.1 * rng.standard_normal((b, d_in, m.d_state))).astype(
                np.float32)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["stateless", "zero_state", "decode"])
def test_mamba_mixer_matches_reference(mode, dtype):
    """``mamba_mixer`` against ``JL.mamba_mixer``: a forward pass without a
    state; a 20-token prompt from a zero state (a prefill), its state out;
    one decode token from a 12-token prefill's state.  Outputs, and the
    ``conv`` (compute dtype) and float32 ``ssm`` states."""
    cfg = _jamba(dtype)
    pcfg = to_port_config(cfg)
    cd = cfg.compute_dtype
    p = _mamba_layer(cfg)
    pp = _torch_tree(p)
    rng = np.random.default_rng(6)
    jfn = jax.jit(lambda p, x, st: JL.mamba_mixer(p, x, cfg, state=st))
    s = 1 if mode == "decode" else 20
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jst = pst = None
    if mode != "stateless":
        zero = {k: np.zeros_like(v)
                for k, v in _conv_and_ssm(cfg, 2, rng).items()}
        jst = {"conv": jnp.asarray(zero["conv"]).astype(cd),
               "ssm": jnp.asarray(zero["ssm"])}
        pst = {"conv": torch.from_numpy(zero["conv"]).to(pcfg.compute_dtype),
               "ssm": torch.from_numpy(zero["ssm"])}
    if mode == "decode":
        prompt = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
        _, jst = jfn(p, jnp.asarray(prompt).astype(cd), jst)
        _, pst = PL.mamba_mixer(pp, torch.from_numpy(prompt).to(
            pcfg.compute_dtype), pcfg, state=pst)
    want, want_st = jfn(p, jnp.asarray(x).astype(cd), jst)
    got, got_st = PL.mamba_mixer(pp, torch.from_numpy(x).to(
        pcfg.compute_dtype), pcfg, state=pst)
    assert got.dtype == pcfg.compute_dtype
    _rel(got, _np(want), TOL[dtype])
    if mode == "stateless":
        assert got_st is None and want_st is None
        return
    assert got_st["conv"].dtype == pcfg.compute_dtype
    assert got_st["ssm"].dtype == torch.float32
    for key in ("conv", "ssm"):
        _rel(got_st[key], _np(want_st[key]), TOL[dtype])


def test_mamba_mixer_in_place_writes_the_given_state():
    """A decode token with ``in_place`` (the decode graph's form): the new
    ssm state is written into ``state["ssm"]`` and returned as that tensor,
    equal to the out-of-place state; the conv state is returned new."""
    cfg = to_port_config(_jamba("float32"))
    p = PL.init_mamba(torch.Generator().manual_seed(1), cfg, "cpu")
    rng = np.random.default_rng(7)
    st = {k: torch.from_numpy(v) for k, v in _conv_and_ssm(cfg, 2, rng).items()}
    x = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model)).astype(
        np.float32))
    want, want_st = PL.mamba_mixer(p, x, cfg, state={k: v.clone()
                                                     for k, v in st.items()})
    ssm = st["ssm"]
    got, got_st = PL.mamba_mixer(p, x, cfg, state=st, in_place=True)
    assert got_st["ssm"] is ssm
    assert torch.equal(got, want)
    for key in ("conv", "ssm"):
        assert torch.equal(got_st[key], want_st[key])


def test_init_mamba_deterministic_leaves_are_the_reference():
    """``d`` (ones, float32), ``dt_bias`` (0.1) and ``conv_b`` (zeros)
    bitwise the reference's, in its dtypes, and ``a_log`` (log of
    1..d_state tiled over the channels) within one float32 ulp: XLA's CPU
    ``log(7)`` is one ulp above the correctly rounded value, which
    PyTorch's ``log`` gives (every other state's log agrees bitwise).
    Every leaf in the reference's shape and dtype (Jamba's bf16
    parameters)."""
    cfg = _jamba("float32")
    want = _tree(JL.init_mamba(jax.random.PRNGKey(0), cfg)[0])
    got = PL.init_mamba(torch.Generator().manual_seed(0),
                        to_port_config(cfg), "cpu")
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert tuple(g.shape) == w.shape, key
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), key
        if key in ("d", "dt_bias", "conv_b"):
            assert torch.equal(g, PT.params_from_numpy(w, "cpu")), key
    a_log = got["a_log"].numpy()
    np.testing.assert_array_equal(
        a_log, np.tile(np.log(np.arange(1, cfg.mamba.d_state + 1,
                                        dtype=np.float64)).astype(np.float32),
                       (a_log.shape[0], 1)))
    np.testing.assert_array_max_ulp(a_log, want["a_log"], maxulp=1)


# ---------------------------------------------------------------------------
# B5's state in and out (its plain version, on CPU tensors)
# ---------------------------------------------------------------------------

def _scan_inputs(seed, b, t, di, ds):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, di)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, t, di)))) * 0.1).astype(
        np.float32)
    bm = rng.standard_normal((b, t, ds)).astype(np.float32)
    cm = rng.standard_normal((b, t, ds)).astype(np.float32)
    a = (-np.log1p(np.exp(rng.standard_normal((di, ds)))) - 0.2).astype(
        np.float32)
    d = rng.standard_normal((di,)).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((b, di, ds))).astype(np.float32)
    return (x, dt, bm, cm, a, d), h0


@pytest.mark.parametrize("t", [1, 20, 0])
def test_mamba_scan_state_in_and_out(t):
    """``mamba_scan`` with a state (a decode token, a prompt, no token at
    all) against ``reference_mamba(state=, return_state=True)``; the final
    state to a new tensor and to ``out_state`` aliasing ``state`` (written
    in place); without ``return_state`` y alone."""
    ins, h0 = _scan_inputs(30 + t, 2, t, 16, 8)
    jy, jh = j_mamba_ref(*(jnp.asarray(z) for z in ins),
                         state=jnp.asarray(h0), return_state=True)
    tins = [torch.from_numpy(z) for z in ins]
    y, h = mk.mamba_scan(*tins, state=torch.from_numpy(h0),
                         return_state=True)
    if t:
        _rel(y, _np(jy), SCAN)
    _rel(h, _np(jh), SCAN)
    assert y.shape == (2, t, 16) and h.dtype == torch.float32
    inout = torch.from_numpy(h0.copy())
    y2, h2 = mk.mamba_scan(*tins, state=inout, out_state=inout)
    assert h2 is inout and torch.equal(h2, h) and torch.equal(y2, y)
    assert torch.equal(mk.mamba_scan(*tins, state=torch.from_numpy(h0)), y)


def test_mamba_op_state_gradients_and_in_place_refusal():
    """``ops.mamba`` with a state: y and the final state against the
    reference, gradients of both (the initial state's included) against
    ``jax.vjp`` of the reference; ``out_state`` takes no gradient."""
    ins, h0 = _scan_inputs(40, 2, 12, 16, 4)
    rng = np.random.default_rng(41)
    gy = rng.standard_normal((2, 12, 16)).astype(np.float32)
    gh = rng.standard_normal(h0.shape).astype(np.float32)
    (jy, jh), vjp = jax.vjp(
        lambda *a: j_mamba_ref(*a[:6], state=a[6], return_state=True),
        *(jnp.asarray(z) for z in (*ins, h0)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    tins = [torch.from_numpy(z).requires_grad_() for z in (*ins, h0)]
    y, h = mamba(*tins[:6], state=tins[6], return_state=True)
    _rel(y, _np(jy), SCAN)
    _rel(h, _np(jh), SCAN)
    torch.autograd.backward([y, h], [torch.from_numpy(gy),
                                     torch.from_numpy(gh)])
    for t, w in zip(tins, want):
        _rel(t.grad, _np(w), SCAN)
    with pytest.raises(ValueError, match="no gradient"):
        mamba(*tins[:6], state=tins[6], out_state=torch.zeros(h0.shape))


# ---------------------------------------------------------------------------
# serving_params on the MoE / Mamba configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b",
                                  "jamba-v0.1-52b"])
def test_serving_params_leave_moe_and_mamba_logits_bitwise(arch):
    """The serving copy casts the experts' and Mamba's projections, conv
    taps and bias to the compute dtype and leaves the router, ``dt_bias``,
    ``a_log`` and ``d`` as they were (the reference reads them in
    float32): forward, prefill and a decode step are bitwise those of the
    float32 weights."""
    cfg = RC.get_config(arch, smoke=True)
    pcfg = to_port_config(cfg)
    params = PT.init_params(pcfg, torch.Generator().manual_seed(3), "cpu")
    sp = PT.serving_params(params, pcfg)
    names = {k for k, _ in _named(sp)}
    for key, leaf in _named(sp):
        if key in ("router", "dt_bias", "a_log", "d"):
            assert key not in PT.COMPUTE_LEAVES
        if key in PT.COMPUTE_LEAVES:
            assert leaf.dtype == pcfg.compute_dtype, key
    assert ("router" in names) and (("a_log" in names) == (
        arch == "jamba-v0.1-52b"))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
    for a, b in zip(PT.forward(params, toks, pcfg),
                    PT.forward(sp, toks, pcfg)):
        assert torch.equal(a, b)
    la, ca = PT.serve_prefill(params, toks, pcfg, 16)
    lb, cb = PT.serve_prefill(sp, toks, pcfg, 16)
    assert torch.equal(la, lb)
    tok = la[:, -1].argmax(-1)[:, None]
    la, _ = PT.serve_decode(params, ca, tok, pcfg)
    lb, _ = PT.serve_decode(sp, cb, tok, pcfg)
    assert torch.equal(la, lb)


def _named(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v)
        else:
            yield k, v
