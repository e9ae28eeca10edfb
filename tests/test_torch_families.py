"""The port's model families against the JAX package, on the CPU.

The direct model (``repro_torch.models``) runs every config of
``repro/configs`` as published; here the attention and MoE / Mamba ones:
Gemma2-9B (sliding-window layers with ring-buffer caches, logit softcaps,
tied embeddings, GeGLU), Qwen3-4B (qk-norm, GQA), StarCoder2-3B (GQA 12,
gelu), LLaVA-NeXT-Mistral-7B (patch embeddings), Whisper-tiny
(encoder-decoder, cross-attention), Qwen1.5-4B (QKV bias), OLMoE-1B-7B and
Qwen3-MoE-235B-A22B (a MoE layer for every MLP, the router's aux loss in
``forward`` and ``lm_loss``) and Jamba-v0.1 (Mamba layers with attention
at unit position 4, MoE every other layer, the SSM state carried from
prefill into decode).  On the CPU attention runs the reference's own
``_dense_attn`` / ``_chunked_attn`` arithmetic and the Mamba scan its
``reference_mamba`` (on the card, kernels B3 and B5:
``tests/test_torch_gpu.py`` and ``chip_smoke.py``); attention feature by
feature is ``tests/test_torch_family_attention.py``, MoE and the Mamba
mixer ``tests/test_torch_family_moe_mamba.py``.  RWKV6-3B is
``tests/test_torch_rwkv.py``.  Every test feeds the
same numpy inputs (``np.random.default_rng``) and the JAX package's own
weights (``params_from_numpy``) to the jitted JAX function and to the
port.  The reference initialises norm gains, QKV biases and qk-norm gains
at zero, which would zero every activation of a plain-``g`` config and
leave the biases untested: they are drawn (``_draw``), the gains around 1
where the config scales by plain ``g``.

Tolerances, as fractions of the largest magnitude of the reference's
output.  float32 (``scaled(dtype="float32")``): ``F32`` = 1e-4 (measured
at most 1.1e-6 on the SMOKE configs: float32 sums in other orders).
bfloat16, as published: ``BF16`` = 0.1, ``tests/test_torch_rwkv.py``'s
bound for the bf16 model (measured at most 0.015: the two packages round
the bf16 products and activations at other places).
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import transformer as T

from repro_torch import configs as PC
from repro_torch.launch import serve
from repro_torch.models import transformer as PT
from test_torch_lm import to_port_config

F32 = 1e-4
BF16 = 0.1
TOL = {"float32": F32, "bfloat16": BF16}
DTYPES = ("float32", "bfloat16")
#: the archs held here as published: the attention-only ones, then the
#: MoE and Mamba ones
FAMILIES = ("gemma2-9b", "qwen3-4b", "starcoder2-3b",
            "llava-next-mistral-7b", "whisper-tiny", "qwen1.5-4b",
            "olmoe-1b-7b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b")
#: the archs with MoE layers (a router's aux loss) and with Mamba layers
MOE = ("olmoe-1b-7b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b")
MAMBA = ("jamba-v0.1-52b",)
PROMPT, STEPS = 20, 3
#: A bf16 MoE model routes each token by a top-k of router probabilities
#: that the two packages compute from activations about 2% apart (their
#: bf16 roundings fall at other places).  At a near-tie they pick other
#: experts, and that token's output — and through attention and the scan
#: every later position's — leaves ``BF16`` (Jamba's SMOKE config, without
#: this: 0.99 of the largest logit, its first flip a gap of 0.0025 in the
#: router logits).  So in bf16 the port's MoE layers take the experts the
#: reference chose (:meth:`_Arch.port_routing`), at the port's own
#: probabilities, and every choice of the port's own that differs must be
#: a near-tie: the probability of the reference's pick at most
#: ``ROUTE_TIE`` below the port's k-th largest (measured: 3 rows of
#: Jamba's forward differ, by at most 3.5e-4; none of OLMoE's or
#: Qwen3-MoE's).  float32 routes
#: unpinned, and ``tests/test_torch_family_moe_mamba.py`` holds the
#: indices of ``moe`` on equal inputs.
ROUTE_TIE = 0.01
_TOP_K = jax.lax.top_k


def _rel(got, want, tol):
    """``got`` within ``tol`` of the largest magnitude of ``want``; returns
    the error as that fraction."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    want = np.asarray(np.asarray(want, np.float32))
    assert got.shape == want.shape and np.all(np.isfinite(got))
    err = float(np.abs(got - want).max()) / max(1e-6,
                                                float(np.abs(want).max()))
    assert err <= tol, (err, tol)
    return err


def _draw(tree, rng, plus_one):
    """The reference's tree with its zero-initialised leaves drawn: norm
    gains ``g`` around 1 for a plain-``g`` config (around 0 for ``1 + g``),
    qk-norm gains (always ``1 + g``) and QKV biases around 0."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out[key] = _draw(v, rng, plus_one)
            continue
        v = np.array(v)
        if key in ("g", "q_norm", "k_norm", "bq", "bk", "bv"):
            base = 1.0 if key == "g" and not plus_one else 0.0
            v = (base + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        out[key] = v
    return out


def _np(x):
    return np.asarray(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# the registry, the shape grid, abstract shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_get_config_matches_reference(arch, smoke):
    assert PC.ARCHS == RC.ARCHS
    cfg = PC.get_config(arch, smoke)
    assert cfg == to_port_config(RC.get_config(arch, smoke))
    # every config is admitted, the MoE and Mamba ones included
    PT.validate_config(cfg)
    kinds = {k for pair in cfg.layer_pattern() for k in pair}
    assert ("moe" in kinds) == (arch in MOE)
    assert ("mamba" in kinds) == (arch in MAMBA)


@pytest.mark.parametrize("shape", list(RC.SHAPES))
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_cell_enabled_matches_reference(arch, shape):
    assert PC.cell_enabled(arch, shape) == RC.cell_enabled(arch, shape)
    assert dataclasses.asdict(PC.SHAPES[shape]) \
        == dataclasses.asdict(RC.SHAPES[shape])


def _port_leaves(tree, prefix=()):
    """(path, tensor) in the order ``jax.tree_util`` flattens a dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(p.key for p in path), leaf) for path, leaf in flat]


def _same_shapes(got, want):
    got, want = list(_port_leaves(got)), _ref_leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path


@pytest.mark.parametrize("shape", list(RC.SHAPES))
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_input_specs_match_reference(arch, shape):
    """Every stand-in input, the decode cache's leaves included (ring
    depth for sliding-window layers, Mamba and RWKV state), in shape and
    dtype; meta tensors, no memory."""
    cfg = PC.get_config(arch)
    _same_shapes(PC.input_specs(cfg, PC.SHAPES[shape]),
                 RC.input_specs(RC.get_config(arch), RC.SHAPES[shape]))


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_abstract_params_match_reference(arch):
    """Every leaf's path, shape and dtype, the experts' stacks and the
    Mamba leaves included, at the published sizes (no memory)."""
    cfg = PC.get_config(arch)
    got, _ = PT.abstract_params(cfg)
    _same_shapes(got, T.abstract_params(RC.get_config(arch))[0])
    names = {p[-1] for p, _ in _port_leaves(got)}
    assert ("router" in names) == (arch in MOE)
    assert ("a_log" in names) == (arch in MAMBA)


# ---------------------------------------------------------------------------
# the model, arch by arch
# ---------------------------------------------------------------------------

def _inputs(cfg, rng, batch=2):
    """Seeded frames and patch embeddings where the arch takes them."""
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        kw["patch_embeds"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return kw


def _reference_weights(arch):
    """The reference's SMOKE weights of ``arch`` (the compute dtype does
    not change them), the zero-initialised leaves drawn."""
    cfg = RC.get_config(arch, smoke=True)
    params, _ = T.init_params(cfg, jax.random.PRNGKey(0))
    return _draw(jax.tree.map(np.asarray, params), np.random.default_rng(1),
                 cfg.norm_plus_one)


class _Arch:
    """One arch's SMOKE config in one dtype, both packages' weights and
    inputs, and the jitted reference entry points."""

    def __init__(self, arch, dtype, params):
        self.cfg = cfg = RC.get_config(arch, smoke=True).scaled(dtype=dtype)
        self.pcfg = to_port_config(cfg)
        self.params = params
        self.pparams = PT.params_from_numpy(self.params, "cpu")
        rng = np.random.default_rng(2)
        self.tokens = rng.integers(0, cfg.vocab_size,
                                   (2, PROMPT)).astype(np.int32)
        self.kw = _inputs(cfg, rng)
        self.jkw = {k: jnp.asarray(v).astype(cfg.compute_dtype)
                    for k, v in self.kw.items()}
        self.pkw = {k: torch.from_numpy(v) for k, v in self.kw.items()}
        self.max_seq = PROMPT + STEPS + 1 + cfg.n_patches
        self.tol = TOL[dtype]
        # bf16 MoE: the reference's expert choices recorded (ROUTE_TIE)
        self.pinned = cfg.moe is not None and dtype == "bfloat16"
        self.routes = []
        jit = self._recording_jit if self.pinned else jax.jit
        self.forward = jit(lambda p, t, kw: T.forward(p, t, cfg, **kw))
        self.loss = jit(lambda p, b: T.lm_loss(p, b, cfg))
        self.prefill = jit(lambda p, t, kw, max_seq: T.serve_prefill(
            p, t, cfg, max_seq, **kw), static_argnums=3)
        self.decode = jit(lambda p, c, t, e: T.serve_decode(
            p, c, t, cfg, enc_out=e))
        self.encode = jax.jit(lambda p, f: T.encode(p, f, cfg))

    def _recording_jit(self, fn, **kw):
        """``jax.jit(fn)`` traced with ``jax.lax.top_k`` recording each
        call's indices into ``self.routes``, in order, at run time."""
        def top_k(x, k):
            vals, idx = _TOP_K(x, k)
            jax.debug.callback(lambda i: self.routes.append(np.asarray(i)),
                               idx, ordered=True)
            return vals, idx

        def traced(*args):
            with mock.patch.object(jax.lax, "top_k", top_k):
                return fn(*args)
        return jax.jit(traced, **kw)

    @contextlib.contextmanager
    def port_routing(self):
        """Around a port call that follows the same reference call: in bf16
        MoE (``self.pinned``) each of the port's top-k calls takes the
        indices the reference recorded, in order, at the port's own
        probabilities, each differing choice a near-tie (``ROUTE_TIE``),
        and all of them are used; otherwise nothing changes."""
        if not self.pinned:
            yield
            return
        jax.effects_barrier()
        queue, real = list(self.routes), torch.topk
        self.routes.clear()

        def topk(x, k):
            idx = torch.as_tensor(np.array(queue.pop(0)), dtype=torch.long)
            own, _ = real(x, k)
            chosen = torch.gather(x, -1, idx)
            gap = float((own[..., -1:] - chosen).max())
            assert gap <= ROUTE_TIE, (gap, ROUTE_TIE)
            return chosen, idx

        with mock.patch.object(torch, "topk", topk):
            yield
        assert not queue, f"{len(queue)} recorded routings left unused"

    def enc_out(self):
        if "frames" not in self.kw:
            return None, None
        return (self.encode(self.params, self.jkw["frames"]),
                PT.encode(self.pparams, self.pkw["frames"], self.pcfg))


@pytest.fixture(scope="module")
def archs():
    """``archs(arch, dtype)``: that arch's :class:`_Arch`, built at its
    first use in this module (each reference function jitted once) and
    dropped with the module."""
    weights, built = {}, {}

    def get(arch, dtype):
        if (arch, dtype) not in built:
            if arch not in weights:
                weights[arch] = _reference_weights(arch)
            built[arch, dtype] = _Arch(arch, dtype, weights[arch])
        return built[arch, dtype]

    yield get
    built.clear()
    weights.clear()


@pytest.fixture(scope="module", params=[(a, d) for a in FAMILIES
                                        for d in DTYPES],
                ids=[f"{a}-{d}" for a in FAMILIES for d in DTYPES])
def model(request, archs):
    return archs(*request.param)


def test_forward_matches_jitted_reference(model):
    m = model
    want, want_aux = m.forward(m.params, m.tokens, m.jkw)
    with m.port_routing():
        got, aux = PT.forward(m.pparams, m.tokens, m.pcfg, **m.pkw)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert got.shape == (2, PROMPT, m.cfg.vocab_size)
    _rel(got, want, m.tol)
    # the MoE layers' router losses, zero without them
    assert (float(aux) > 0) == (float(want_aux) > 0) == (
        m.cfg.moe is not None)
    _rel(aux.reshape(1), np.asarray(want_aux).reshape(1), m.tol)


def test_prefill_and_decode_match_jitted_reference(model):
    """``serve_prefill`` then ``STEPS`` ``serve_decode`` steps (the decode
    cross-attending to the encoder output where there is one): logits at
    every step, and every cache leaf (ring-deep for local layers; Mamba's
    conv inputs and float32 SSM state) at the end."""
    m = model
    want_l, want_c = m.prefill(m.params, m.tokens, m.jkw, m.max_seq)
    with m.port_routing():
        got_l, got_c = PT.serve_prefill(m.pparams, m.tokens, m.pcfg,
                                        m.max_seq, **m.pkw)
    _rel(got_l, want_l, m.tol)
    j_enc, p_enc = m.enc_out()
    for step in range(STEPS):
        tok = np.asarray([[5 + step], [11 + step]], np.int32)
        want_l, want_c = m.decode(m.params, want_c, tok, j_enc)
        with m.port_routing():
            got_l, got_c = PT.serve_decode(m.pparams, got_c, tok, m.pcfg,
                                           enc_out=p_enc)
        _rel(got_l, want_l, m.tol)
    got, want = list(_port_leaves(got_c)), _ref_leaves(want_c)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        if path[-1] == "idx":
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
            _rel(g, _np(w), m.tol)


def test_encode_and_loss_match_jitted_reference(model):
    """The encoder's output (Whisper) and ``lm_loss`` with some labels
    masked out."""
    m = model
    j_enc, p_enc = m.enc_out()
    if j_enc is not None:
        assert p_enc.dtype == m.pcfg.compute_dtype
        _rel(p_enc, _np(j_enc), m.tol)
    labels = np.roll(m.tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    batch = {"tokens": m.tokens, "labels": labels, **m.kw}
    (want, wparts) = m.loss(
        m.params, {k: jnp.asarray(v).astype(m.cfg.compute_dtype)
                   if k in m.kw else jnp.asarray(v)
                   for k, v in batch.items()})
    with m.port_routing():
        got, parts = PT.lm_loss(m.pparams, {k: torch.from_numpy(v)
                                            for k, v in batch.items()},
                                m.pcfg)
    # the router's aux loss is in the loss (zero without MoE layers)
    assert (float(parts["aux"]) > 0) == (m.cfg.moe is not None)
    _rel(parts["aux"].reshape(1), np.asarray(wparts["aux"]).reshape(1),
         m.tol)
    # the loss is of order log(vocab): held to the same fraction of it
    _rel(got.reshape(1), np.asarray(want).reshape(1), m.tol)
    _rel(parts["nll"].reshape(1), np.asarray(wparts["nll"]).reshape(1),
         m.tol)


def _pad(prompts, start, batch, width):
    toks = np.zeros((batch, width), np.int32)
    for i, p in enumerate(prompts[start:start + batch]):
        toks[i, width - len(p):] = p
    return toks


def _reference_serving(m, prompts, kw, new_tokens, with_enc=True):
    """The reference's ``serve_prefill`` / ``serve_decode`` called
    directly, batch by batch as ``serve_requests`` batches, greedy; the
    decode steps get the encoder's output unless ``with_enc`` is false
    (what the reference launcher does: ROADMAP C23)."""
    out = []
    for start in range(0, len(prompts), 2):
        toks = _pad(prompts, start, 2, PROMPT)
        bkw = {k: jnp.asarray(v[start:start + 2]).astype(m.cfg.compute_dtype)
               for k, v in kw.items()}
        logits, cache = m.prefill(m.params, toks, bkw,
                                  PROMPT + new_tokens + m.cfg.n_patches)
        enc = m.encode(m.params, bkw["frames"]) \
            if with_enc and "frames" in bkw else None
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        gen = [tok]
        for _ in range(new_tokens - 1):
            logits, cache = m.decode(m.params, cache, tok, enc)
            tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            gen.append(tok)
        out.extend(np.concatenate([np.asarray(t) for t in gen], 1))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_requests_matches_reference_serving(archs, arch):
    """``serve_requests`` (float32) gives the tokens of the reference's
    ``serve_prefill`` / ``serve_decode`` called directly on the same
    weights, prompts, frames and patches."""
    m = archs(arch, "float32")
    prompts = serve.draw_prompts(3, 4, PROMPT, m.cfg.vocab_size)
    kw = _inputs(m.cfg, np.random.default_rng(9), batch=4)
    tokens, times = serve.serve_requests(m.pcfg, m.pparams, prompts,
                                         batch=2, max_prompt=PROMPT,
                                         new_tokens=STEPS + 1, **kw)
    assert [t["batch"] for t in times] == [2, 2]
    want = _reference_serving(m, prompts, kw, STEPS + 1)
    for got, w in zip(tokens, want):
        np.testing.assert_array_equal(got, w)


def test_whisper_decode_sees_the_audio(archs):
    """ROADMAP C23: the reference launcher decodes without the encoder's
    output, so its decode steps skip cross-attention; the port's launcher
    hands every decode step the batch's encoded frames.  With nonzero
    frames the port's tokens are those of the reference's ``serve_decode(
    ..., enc_out=...)`` and not those of the launcher's path."""
    m = archs("whisper-tiny", "float32")
    prompts = serve.draw_prompts(4, 2, PROMPT, m.cfg.vocab_size)
    kw = _inputs(m.cfg, np.random.default_rng(10), batch=2)
    new = 8
    tokens, _ = serve.serve_requests(m.pcfg, m.pparams, prompts, batch=2,
                                     max_prompt=PROMPT, new_tokens=new, **kw)
    right = _reference_serving(m, prompts, kw, new)
    launcher = _reference_serving(m, prompts, kw, new, with_enc=False)
    for got, w in zip(tokens, right):
        np.testing.assert_array_equal(got, w)
    assert any(not np.array_equal(got, w) for got, w in zip(tokens,
                                                            launcher))


@pytest.mark.parametrize("arch", ["whisper-tiny", "llava-next-mistral-7b",
                                  "gemma2-9b", "olmoe-1b-7b",
                                  "qwen3-moe-235b-a22b", "jamba-v0.1-52b"])
def test_launcher_serves_the_family_on_the_cpu(arch, capsys):
    """``main`` serves the SMOKE config with zero frames or patches, as the
    reference launcher does."""
    serve.main(["--arch", arch, "--requests", "3", "--batch", "2",
                "--max-prompt", "12", "--new-tokens", "3", "--device",
                "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("[serve] batch of") for line in out) == 2
    assert out[-1].startswith("[serve] 3 requests, 9 tokens")
