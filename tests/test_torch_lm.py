"""The port's LM serving lane against the JAX package on the CPU.

Same weights in both packages: the JAX ``T.init_params`` draws them and
``params_from_numpy`` hands them to the port.  The config is
``tests/test_lm.py``'s tiny one.

Tolerances.  Logits are of order 1.  The JAX package's own lazy lane
already differs from its jitted model by up to 2e-6 at this config (XLA
contracts mul+add into FMA under jit; ROADMAP C1), and XLA's and PyTorch's
CPU ``exp``/``rsqrt``/``pow`` and reduction orders differ in the last ulp,
compounded through two layers.  So the port is held to the JAX package at
``atol=1e-5`` (about 80 float32 ulps at 1.0; measured 2.2e-6).  Inside the
port the lazy lane and the direct model run the same torch CPU ops but for
the matmul shapes, so they are held to ``atol=1e-6`` (measured bitwise).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.backends import default_stack as ref_default_stack
from repro.models import transformer as T
from repro.models.config import ModelConfig
from repro.models.lazy_transformer import (LazyTransformer as RefLazy,
                                           validate_config as ref_validate)

from repro_torch.core.backends import LM_STACK, default_stack
from repro_torch.models import config as pconfig
from repro_torch.models import transformer as PT
from repro_torch.models.lazy_transformer import LazyTransformer, validate_config

CFG = ModelConfig(name="lm_tiny", family="dense", n_layers=2, d_model=32,
                  n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=97,
                  dtype="float32", param_dtype="float32", norm_plus_one=True,
                  tie_embeddings=False)
TOKENS = np.asarray([[3, 14, 15, 92, 65, 35], [8, 9, 79, 3, 2, 38]], np.int32)
MAX_SEQ = 16
CROSS = dict(rtol=0, atol=1e-5)      # port vs JAX package
INSIDE = dict(rtol=0, atol=1e-6)     # port lazy vs port direct
#: the reference's backend names -> the port's
NAMES = {"pallas": "triton", "xla": "torch"}


def to_port_config(cfg) -> pconfig.ModelConfig:
    """A reference ``ModelConfig`` rebuilt as the port's (nested family
    configs included)."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            cls = getattr(pconfig, type(v).__name__)
            v = cls(**dataclasses.asdict(v))
        kw[f.name] = v
    return pconfig.ModelConfig(**kw)


PCFG = to_port_config(CFG)


@pytest.fixture(scope="module")
def params():
    p, _ = T.init_params(CFG, jax.random.PRNGKey(0))
    return p


@pytest.fixture(scope="module")
def pparams(params):
    return PT.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **tol)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def _ref_configs():
    from repro.configs import ARCHS, get_config
    return {f"{a}{'-smoke' if s else ''}": get_config(a, smoke=s)
            for a in ARCHS for s in (False, True)}


@pytest.mark.parametrize("name", sorted(_ref_configs()))
def test_config_methods_match_reference(name):
    ref = _ref_configs()[name]
    got = to_port_config(ref)
    assert got.layer_pattern() == ref.layer_pattern()
    assert got.scan_groups() == ref.scan_groups()
    assert got.n_params() == ref.n_params()
    assert got.active_params() == ref.active_params()
    assert got.hd == ref.hd
    assert got.compute_dtype == getattr(torch, ref.dtype)
    assert got.scaled(n_layers=3).n_params() == ref.scaled(n_layers=3).n_params()


def test_qwen15_4b_config_is_the_reference():
    from repro.configs import qwen15_4b as ref
    from repro_torch.configs import qwen15_4b as port
    for name in ("CONFIG", "SMOKE"):
        assert to_port_config(getattr(ref, name)) == getattr(port, name)
    lane = port.CONFIG.scaled(qkv_bias=False, dtype="float32", n_layers=8)
    validate_config(lane)
    assert (lane.d_model, lane.n_heads, lane.hd, lane.d_ff, lane.vocab_size) \
        == (2560, 20, 128, 6912, 151936)


_BAD = [{"dtype": "bfloat16"}, {"param_dtype": "bfloat16"},
        {"n_kv_heads": 1}, {"act": "gelu"}, {"tie_embeddings": True},
        {"qkv_bias": True}, {"qk_norm": True}, {"attn_softcap": 50.0},
        {"final_softcap": 30.0}, {"n_encoder_layers": 2},
        {"local_global_period": 2}, {}]


@pytest.mark.parametrize("kw", _BAD, ids=[",".join(k) or "ok" for k in _BAD])
def test_validate_config_accepts_and_rejects_as_reference(kw):
    ref_cfg = dataclasses.replace(CFG, **kw)
    try:
        ref_validate(ref_cfg)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        validate_config(to_port_config(ref_cfg))
    else:
        with pytest.raises(ValueError) as ei:
            validate_config(to_port_config(ref_cfg))
        assert str(ei.value) == want
    assert (want is None) == (kw == {})


def test_validate_config_on_the_repo_configs():
    for name, ref in _ref_configs().items():
        for cfg in (ref, ref.scaled(dtype="float32", qkv_bias=False)):
            try:
                ref_validate(cfg)
                want = None
            except ValueError as e:
                want = str(e)
            try:
                validate_config(to_port_config(cfg))
                got = None
            except ValueError as e:
                got = str(e)
            assert got == want, name


def test_default_stack_lm():
    assert default_stack("lm") == LM_STACK == (
        "flash_attention", "rmsnorm", "mamba_scan", "triton", "torch")
    assert tuple(NAMES.get(n, n) for n in ref_default_stack("lm")) == LM_STACK


# ---------------------------------------------------------------------------
# the direct model
# ---------------------------------------------------------------------------

def test_init_params_tree_matches_reference(params):
    gen = torch.Generator().manual_seed(0)
    mine = PT.init_params(PCFG, gen, "cpu")
    ref = jax.tree.map(np.asarray, params)
    got = jax.tree_util.tree_structure(jax.tree.map(lambda t: 0, mine))
    assert got == jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, ref))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree_util.tree_leaves(mine)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path
    again = PT.init_params(PCFG, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["lm_head"], mine["lm_head"])


def test_direct_forward_matches_jitted_reference(params, pparams):
    ref = jax.jit(lambda p, t: T.forward(p, t, CFG)[0])(params, TOKENS)
    got, aux = PT.forward(pparams, TOKENS, PCFG)
    _close(got, ref, CROSS)
    assert float(aux) == 0.0


def test_direct_prefill_and_decode_match_jitted_reference(params, pparams):
    ref_l, ref_c = jax.jit(
        lambda p, t: T.serve_prefill(p, t, CFG, MAX_SEQ))(params, TOKENS)
    got_l, got_c = PT.serve_prefill(pparams, TOKENS, PCFG, MAX_SEQ)
    _close(got_l, ref_l, CROSS)
    dec = jax.jit(lambda p, c, t: T.serve_decode(p, c, t, CFG))
    for step in range(3):
        tok = np.asarray([[5 + step], [11 + step]], np.int32)
        ref_l, ref_c = dec(params, ref_c, tok)
        got_l, got_c = PT.serve_decode(pparams, got_c, tok, PCFG)
        _close(got_l, ref_l, CROSS)
    for key in ("k", "v"):
        _close(got_c["l0"][key], ref_c["l0"][key], CROSS)
    assert got_c["l0"]["idx"].tolist() == np.asarray(ref_c["l0"]["idx"]).tolist()


# ---------------------------------------------------------------------------
# the lazy lane
# ---------------------------------------------------------------------------

def _blocks(rt, which):
    out = {}
    for name, n in rt.history[-1]["exec"][which].items():
        out[NAMES.get(name, name)] = n
    return out


@pytest.fixture(scope="module")
def lanes(params, pparams):
    return RefLazy(params, CFG), LazyTransformer(pparams, PCFG, device="cpu")


def test_lazy_lane_defaults(lanes):
    _, lt = lanes
    assert lt.rt.executor.backends == LM_STACK
    assert lt.rt.device.type == "cpu"


def test_lazy_forward_matches_reference_lane_and_direct_model(lanes, pparams):
    ref_lt, lt = lanes
    want = ref_lt.forward(TOKENS)
    got = lt.forward(TOKENS)
    _close(got, want, CROSS)
    _close(got, PT.forward(pparams, TOKENS, PCFG)[0], INSIDE)
    # the same blocks claimed and declined, per backend and slug
    assert _blocks(lt.rt, "backend_blocks") == _blocks(ref_lt.rt,
                                                       "backend_blocks")
    assert _blocks(lt.rt, "backend_fallbacks") == _blocks(ref_lt.rt,
                                                          "backend_fallbacks")
    claims = _blocks(lt.rt, "backend_blocks")
    assert claims["rmsnorm"] >= 2 * CFG.n_layers + 1
    assert claims["flash_attention"] >= 2 * CFG.n_layers


def test_lazy_prefill_decode_and_caches(lanes, pparams):
    ref_lt, lt = lanes
    got = lt.prefill(TOKENS, MAX_SEQ)
    _close(got, ref_lt.prefill(TOKENS, MAX_SEQ), CROSS)
    d_l, d_c = PT.serve_prefill(pparams, TOKENS, PCFG, MAX_SEQ)
    _close(got, d_l, INSIDE)
    counts = [(_blocks(lt.rt, "backend_blocks"),
               _blocks(ref_lt.rt, "backend_blocks"))]
    for step in range(3):
        tok = np.asarray([[5 + step], [11 + step]], np.int32)
        got = lt.decode(tok)
        _close(got, ref_lt.decode(tok), CROSS)
        d_l, d_c = PT.serve_decode(pparams, d_c, tok, PCFG)
        _close(got, d_l, INSIDE)
        counts.append((_blocks(lt.rt, "backend_blocks"),
                       _blocks(ref_lt.rt, "backend_blocks")))
    for mine, ref in counts:
        assert mine == ref
    ref_caches = ref_lt.cache_numpy()
    for li, (k, v) in enumerate(lt.cache_numpy()):
        _close(k, ref_caches[li][0], CROSS)
        _close(v, ref_caches[li][1], CROSS)
        _close(k, d_c["l0"]["k"][li], INSIDE)
        _close(v, d_c["l0"]["v"][li], INSIDE)
