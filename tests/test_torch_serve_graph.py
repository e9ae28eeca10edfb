"""Serving on the CPU with the weights cast once and the prefill and decode
step objects (``launch/serve.py:PrefillStep``, ``DecodeStep``), at the
``rwkv6-3b`` SMOKE config.

``models.transformer.serving_params`` casts the leaves the forward pass
casts anyway, once; a float32-to-bf16 cast is deterministic, so prefill
and decode through the serving copy are held bitwise to the float32 tree
(and, as that tree is in ``tests/test_torch_rwkv.py``, to the jitted JAX
model at ``BF16_MODEL`` / ``F32_MODEL`` of the largest logit).  On the CPU
the step objects run ``serve_prefill`` / ``serve_decode`` and the greedy
pick eagerly: held bitwise to them, step after step.  Its CUDA graph captures
``serve_decode(..., in_place=True)``, which updates the given caches (B6
writes each RWKV state into its own): held bitwise to the step that
returns new caches, and to the jitted JAX decode at the model tolerance.
The graphs themselves are held to eager prefills and decoding on the card
(``tests/test_torch_gpu.py``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as T

from repro_torch.launch import serve
from repro_torch.models import transformer as PT
from test_torch_lm import to_port_config
from test_torch_rwkv import BF16_MODEL, F32_MODEL, MAX_SEQ, TOKENS, _rel, \
    _with_gains

FLOAT32_READ = {"mix", "w0", "w_a", "w_b", "u", "ln_g", "g"}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    from repro.configs import rwkv6_3b
    cfg = rwkv6_3b.SMOKE.scaled(dtype=request.param)
    params, _ = T.init_params(cfg, jax.random.PRNGKey(0))
    params = _with_gains(jax.tree.map(np.asarray, params),
                         np.random.default_rng(1))
    tol = F32_MODEL if request.param == "float32" else BF16_MODEL
    return cfg, to_port_config(cfg), params, PT.params_from_numpy(
        params, "cpu"), tol


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_serving_params_cast_only_the_compute_leaves(model):
    _, pcfg, _, pparams, _ = model
    sp = PT.serving_params(pparams, pcfg)
    paths = dict(_paths(pparams))
    assert set(dict(_paths(sp))) == set(paths)
    names = {p[-1] for p in paths}
    assert PT.COMPUTE_LEAVES & names == {"wr", "wk", "wv", "wg", "wo",
                                         "w_gate", "w_up", "w_down", "embed",
                                         "lm_head"}
    assert names - PT.COMPUTE_LEAVES == FLOAT32_READ
    for path, leaf in paths.items():
        got = _get(sp, path)
        if path[-1] in PT.COMPUTE_LEAVES:
            assert got.dtype == pcfg.compute_dtype, path
            assert torch.equal(got, leaf.to(pcfg.compute_dtype)), path
        else:
            assert got is leaf and got.dtype == torch.float32, path


def test_serving_params_prefill_and_decode_bitwise(model):
    cfg, pcfg, params, pparams, tol = model
    sp = PT.serving_params(pparams, pcfg)
    want_l, want_c = PT.serve_prefill(pparams, TOKENS, pcfg, MAX_SEQ)
    got_l, got_c = PT.serve_prefill(sp, TOKENS, pcfg, MAX_SEQ)
    assert torch.equal(got_l, want_l)
    jl, jc = jax.jit(lambda p, t: T.serve_prefill(p, t, cfg, MAX_SEQ))(
        params, TOKENS)
    _rel(got_l, jl, tol)
    dec = jax.jit(lambda p, c, t: T.serve_decode(p, c, t, cfg))
    tok = want_l[:, -1].argmax(-1)[:, None].to(torch.int32)
    for _ in range(3):
        want_l, want_c = PT.serve_decode(pparams, want_c, tok, pcfg)
        got_l, got_c = PT.serve_decode(sp, got_c, tok, pcfg)
        jl, jc = dec(params, jc, tok.numpy())
        assert torch.equal(got_l, want_l)
        _rel(got_l, jl, tol)
        for a, b in zip(serve._leaves(got_c), serve._leaves(want_c)):
            assert torch.equal(a, b)
        tok = got_l[:, -1].argmax(-1)[:, None].to(torch.int32)
        assert torch.equal(tok, want_l[:, -1].argmax(-1)[:, None]
                           .to(torch.int32))


def test_decode_step_on_the_cpu_is_serve_decode(model):
    _, pcfg, _, pparams, _ = model
    sp = PT.serving_params(pparams, pcfg)
    step = serve.DecodeStep(sp, pcfg)
    assert not step.graph
    logits, cache = PT.serve_prefill(sp, TOKENS, pcfg, MAX_SEQ)
    want_c = cache
    tok = want_tok = serve._greedy(logits)
    for _ in range(4):
        want_l, want_c = PT.serve_decode(sp, want_c, want_tok, pcfg)
        want_tok = serve._greedy(want_l)
        got_l, tok, cache = step(cache, tok)
        assert torch.equal(got_l, want_l) and torch.equal(tok, want_tok)
        assert tok.dtype == torch.int32 and tok.shape == (TOKENS.shape[0], 1)
        for a, b in zip(serve._leaves(cache), serve._leaves(want_c)):
            assert torch.equal(a, b)
    assert step.replays == step.captures == 0


def test_serve_decode_in_place_is_serve_decode(model):
    """``in_place`` writes every new cache leaf into the given caches (the
    wkv states through the kernel's ``out_state``, the token shift by a
    copy) and returns them: bitwise the caches and logits of the step that
    returns new ones, within the model tolerance of the jitted JAX step."""
    cfg, pcfg, params, pparams, tol = model
    sp = PT.serving_params(pparams, pcfg)
    logits, want_c = PT.serve_prefill(sp, TOKENS, pcfg, MAX_SEQ)
    got_c = {k: {n: z.clone() for n, z in v.items()}
             for k, v in want_c.items()}
    ptrs = [z.data_ptr() for z in serve._leaves(got_c)]
    _, jc = jax.jit(lambda p, t: T.serve_prefill(p, t, cfg, MAX_SEQ))(
        params, TOKENS)
    dec = jax.jit(lambda p, c, t: T.serve_decode(p, c, t, cfg))
    tok = serve._greedy(logits)
    for _ in range(3):
        want_l, want_c = PT.serve_decode(sp, want_c, tok, pcfg)
        got_l, same = PT.serve_decode(sp, got_c, tok, pcfg, in_place=True)
        jl, jc = dec(params, jc, tok.numpy())
        assert same is got_c and torch.equal(got_l, want_l)
        assert [z.data_ptr() for z in serve._leaves(got_c)] == ptrs
        for a, b in zip(serve._leaves(got_c), serve._leaves(want_c)):
            assert torch.equal(a, b)
        _rel(got_l, jl, tol)
        tok = serve._greedy(got_l)


def test_serve_decode_in_place_for_attention_caches():
    """The same for the dense model's KV caches and write index, which
    ``in_place`` copies into the given caches layer by layer, against the
    step that returns new caches (bitwise) and the jitted JAX step
    (``test_torch_lm.CROSS``)."""
    import test_torch_lm as lm
    params, _ = T.init_params(lm.CFG, jax.random.PRNGKey(0))
    pparams = PT.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    _, want_c = PT.serve_prefill(pparams, lm.TOKENS, lm.PCFG, lm.MAX_SEQ)
    got_c = {k: {n: z.clone() for n, z in v.items()}
             for k, v in want_c.items()}
    _, jc = jax.jit(lambda p, t: T.serve_prefill(p, t, lm.CFG, lm.MAX_SEQ))(
        params, lm.TOKENS)
    dec = jax.jit(lambda p, c, t: T.serve_decode(p, c, t, lm.CFG))
    for step in range(3):
        tok = np.asarray([[5 + step], [11 + step]], np.int32)
        want_l, want_c = PT.serve_decode(pparams, want_c, tok, lm.PCFG)
        got_l, same = PT.serve_decode(pparams, got_c, tok, lm.PCFG,
                                      in_place=True)
        jl, jc = dec(params, jc, tok)
        assert same is got_c and torch.equal(got_l, want_l)
        for a, b in zip(serve._leaves(got_c), serve._leaves(want_c)):
            assert torch.equal(a, b)
        lm._close(got_l, jl, lm.CROSS)
    assert got_c["l0"]["idx"].tolist() == np.asarray(jc["l0"]["idx"]).tolist()


def test_decode_step_refuses_a_graph_on_the_cpu(model):
    _, pcfg, _, pparams, _ = model
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        serve.DecodeStep(pparams, pcfg, graph=True)


def test_serve_requests_reports_its_eager_step(model):
    _, pcfg, _, pparams, _ = model
    prompts = serve.draw_prompts(3, 3, 20, pcfg.vocab_size)
    tokens, times = serve.serve_requests(pcfg, pparams, prompts, batch=2,
                                         max_prompt=20, new_tokens=3)
    again, _ = serve.serve_requests(pcfg, PT.serving_params(pparams, pcfg),
                                    prompts, batch=2, max_prompt=20,
                                    new_tokens=3, graph=False)
    for a, b in zip(tokens, again):
        np.testing.assert_array_equal(a, b)
    for t in times:
        assert not t["step"].graph and t["step"].replays == 0


def test_prefill_step_on_the_cpu_is_serve_prefill(model):
    """On the CPU the prefill step runs ``serve_prefill`` and the greedy
    pick eagerly: logits, token and caches bitwise, for two batches of one
    shape and one of another, and no capture."""
    _, pcfg, _, pparams, _ = model
    sp = PT.serving_params(pparams, pcfg)
    step = serve.PrefillStep(sp, pcfg)
    assert not step.graph
    rng = np.random.default_rng(5)
    for shape in ((2, 12), (2, 12), (3, 7)):
        toks = rng.integers(0, pcfg.vocab_size, shape).astype(np.int32)
        want_l, want_c = PT.serve_prefill(sp, toks, pcfg, 20)
        got_l, tok, got_c = step(toks, 20)
        assert torch.equal(got_l, want_l)
        assert torch.equal(tok, serve._greedy(want_l))
        assert tok.dtype == torch.int32 and tok.shape == (shape[0], 1)
        for a, b in zip(serve._leaves(got_c), serve._leaves(want_c)):
            assert torch.equal(a, b)
    assert step.replays == step.captures == 0


def test_prefill_step_refuses_a_graph_on_the_cpu(model):
    _, pcfg, _, pparams, _ = model
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        serve.PrefillStep(pparams, pcfg, graph=True)


def test_serve_requests_reports_its_prefill_step(model):
    """``serve_requests`` prefills each batch through its
    :class:`PrefillStep` (eager on the CPU: no capture, no replay) and
    returns it beside the decode step; the tokens are a plain loop's."""
    _, pcfg, _, pparams, _ = model
    prompts = serve.draw_prompts(4, 3, 16, pcfg.vocab_size)
    tokens, times = serve.serve_requests(pcfg, pparams, prompts, batch=2,
                                         max_prompt=16, new_tokens=3)
    assert len(times) == 2
    assert times[0]["prefill"] is times[1]["prefill"]
    for t in times:
        pre = t["prefill"]
        assert isinstance(pre, serve.PrefillStep) and not pre.graph
        assert pre.captures == pre.replays == 0
    sp = PT.serving_params(pparams, pcfg)
    for start in (0, 2):
        group = prompts[start:start + 2]
        toks = np.zeros((2, 16), np.int32)
        for i, p in enumerate(group):
            toks[i, 16 - len(p):] = p
        logits, cache = PT.serve_prefill(sp, toks, pcfg, 19)
        outs = [serve._greedy(logits)]
        for _ in range(2):
            logits, cache = PT.serve_decode(sp, cache, outs[-1], pcfg)
            outs.append(serve._greedy(logits))
        want = torch.cat(outs, 1).numpy()
        for got, w in zip(tokens[start:start + 2], want):
            np.testing.assert_array_equal(got, w)
