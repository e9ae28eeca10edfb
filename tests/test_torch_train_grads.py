"""The port's gradient path and train step against the JAX package, on
the CPU.

Same weights in both packages: the JAX package's SMOKE weights with the
zero-initialised norm gains, qk-norm gains and QKV biases drawn
(``test_torch_families._reference_weights``: a plain-``g`` config's zero
gains would zero every activation and every gradient but the gains'),
handed to the port by ``params_from_numpy``; the same numpy batches.

* ``lm_loss`` value and gradient, leaf by leaf, against ``jax.grad`` for
  seven families in float32: dense (Qwen3-4B), local/global attention with
  softcaps (Gemma2-9B), MoE (OLMoE-1B-7B), Mamba + attention + MoE
  (Jamba-v0.1, whose parameters are bfloat16), RWKV6 (RWKV6-3B), the
  encoder-decoder (Whisper-tiny) and the VLM (LLaVA-NeXT-Mistral-7B).  On
  the CPU attention runs the reference's own arithmetic and the scans
  their plain versions; backward is autograd there as in the reference.
* remat (``torch.utils.checkpoint`` around each layer group and encoder
  layer) against no remat: bitwise on the CPU, loss and every gradient.
* The slice as a whole: 5 steps of the port's ``make_train_step`` against
  the reference's ``make_train_step`` on a 1 x 1 mesh of ``Auto`` axes
  under ``jax.jit`` (its default ``Explicit`` axes refuse the step's
  sharding constraints on this JAX: ROADMAP C2), Qwen3-4B SMOKE in
  float32, float32 and int8 moments, 2 microbatches of bf16-accumulated
  gradients.

Tolerances.  Gradients: each leaf's largest error over the larger of its
own largest reference magnitude and 1e-3 of the tree's (a leaf whose
gradient is nearly zero is held against the tree's scale), ``GRAD_F32`` =
1e-4 for float32 leaves (measured at most 3.4e-6: float32 sums in other
orders), ``GRAD_BF16`` = 2**-6 for bfloat16 leaves (two bf16 ulps of the
leaf's largest value; measured 0.0042, one ulp: the two packages round
the same float32 gradient on either side of a bf16 boundary).  Train
steps: loss within ``LOSS_TOL`` = 1e-6 relative (measured 1e-7), lr
within 2 float32 ulps (XLA's and PyTorch's ``cos`` differ by one), the
final parameters within ``PARAM_TOL`` of the largest parameter magnitude:
1e-4 for float32 moments (measured 3.6e-5: early Adam steps divide the
first moment by the root of a second moment that is still small, which
magnifies the gradients' last-ulp differences) and 5e-4 for int8 moments
(measured 1.1e-4: a moment code one apart, libm's ``log1p`` against
XLA's, moves its weight by about 1% of that step's update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro.core.lazy  # noqa: F401  (x64 on, as in the rest of the suite)
from repro import configs as RC
from repro.data.pipeline import SyntheticLM as RefData
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import transformer as T
from repro.optim.adamw import adamw_init as ref_adamw_init

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import steps as PS
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PA
from test_torch_families import _inputs, _reference_weights
from test_torch_lm import to_port_config

GRAD_F32 = 1e-4
GRAD_BF16 = 2.0 ** -6
LOSS_TOL = 1e-6
PARAM_TOL = {"f32": 1e-4, "int8": 5e-4}
GRAD_FAMILIES = ("qwen3-4b", "gemma2-9b", "olmoe-1b-7b", "jamba-v0.1-52b",
                 "rwkv6-3b", "whisper-tiny", "llava-next-mistral-7b")


def _batch(cfg, seed=3, batch=2, seq=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    return {"tokens": toks, "labels": labels, **_inputs(cfg, rng, batch)}


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(p.key for p in path), leaf) for path, leaf in flat]


def _port_grads(pcfg, params, batch):
    """``(loss, {path: gradient})`` of the port's ``lm_loss``."""
    paths = [path for path, _ in PA._paths(params)]
    flat = [leaf.detach().requires_grad_() for _, leaf in PA._paths(params)]
    loss, _ = PT.lm_loss(PA._unflatten(paths, flat),
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         pcfg)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(paths, grads))


@pytest.mark.parametrize("arch", GRAD_FAMILIES)
def test_lm_loss_gradients_match_jax_grad(arch):
    cfg = RC.get_config(arch, smoke=True).scaled(dtype="float32")
    weights = _reference_weights(arch)
    batch = _batch(cfg)
    (want, _), wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: T.lm_loss(p, b, cfg), has_aux=True))(
        weights, {k: jnp.asarray(v) for k, v in batch.items()})
    got, grads = _port_grads(to_port_config(cfg),
                             PT.params_from_numpy(weights, "cpu"), batch)
    assert abs(float(got) - float(want)) <= LOSS_TOL * abs(float(want))
    ref = _ref_paths(wgrads)
    assert sorted(grads) == sorted(p for p, _ in ref)
    scale = max(float(np.abs(np.asarray(g, np.float32)).max()) for _, g in ref)
    for path, w in ref:
        g = grads[path]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        w = np.asarray(w, np.float32)
        tol = GRAD_BF16 if g.dtype == torch.bfloat16 else GRAD_F32
        err = float(np.abs(g.float().numpy() - w).max()) \
            / max(float(np.abs(w).max()), 1e-3 * scale)
        assert err <= tol, (path, err, tol)


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-tiny",
                                  "jamba-v0.1-52b"])
def test_remat_is_bitwise_no_remat(arch):
    """Rematerialized groups (and Whisper's encoder layers) give the loss
    and every gradient bit for bit, on the CPU."""
    cfg = to_port_config(RC.get_config(arch, smoke=True).scaled(
        dtype="float32"))
    params = PT.params_from_numpy(_reference_weights(arch), "cpu")
    batch = _batch(cfg)
    plain = _port_grads(cfg.scaled(remat=False), params, batch)
    remat = _port_grads(cfg.scaled(remat=True), params, batch)
    assert torch.equal(plain[0], remat[0])
    for path, g in plain[1].items():
        assert torch.equal(g, remat[1][path]), path


def test_remat_recomputes_each_group_in_the_backward():
    """With remat the backward runs each group's forward again: the
    attention of each of the 2 layers is called twice a loss and
    gradient."""
    from repro_torch.models import layers
    cfg = to_port_config(RC.get_config("qwen3-4b", smoke=True).scaled(
        dtype="float32"))
    params = PT.params_from_numpy(_reference_weights("qwen3-4b"), "cpu")
    calls = []
    real = layers._attend

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    batch = _batch(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "_attend", spy)
        _port_grads(cfg.scaled(remat=False), params, batch)
        assert len(calls) == cfg.n_layers
        calls.clear()
        _port_grads(cfg.scaled(remat=True), params, batch)
        assert len(calls) == 2 * cfg.n_layers


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@pytest.mark.parametrize("opt_state", ["f32", "int8"])
def test_train_steps_follow_the_reference(opt_state):
    cfg = RC.get_config("qwen3-4b", smoke=True).scaled(dtype="float32")
    kw = dict(num_microbatches=2, opt_state_dtype=opt_state, peak_lr=3e-3,
              warmup=2, total_steps=10)
    step, _ = ref_make_train_step(cfg, _auto_mesh(), **kw)
    step = jax.jit(step)
    params = jax.tree.map(jnp.asarray, _reference_weights("qwen3-4b"))
    opt = ref_adamw_init(params, state_dtype=opt_state)
    pparams = PT.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    popt = PA.state_from_numpy(jax.tree.map(np.asarray, tuple(opt)), "cpu")
    pstep, specs = PS.make_train_step(to_port_config(cfg), device="cpu",
                                      **kw)
    data, ref_data = SyntheticLM(cfg, 4, 32, seed=0), RefData(cfg, 4, 32,
                                                              seed=0)
    start = jax.tree.map(np.asarray, params)
    for s in range(5):
        params, opt, m = step(params, opt, {
            k: jnp.asarray(v) for k, v in ref_data.batch_at(s).items()})
        pparams, popt, pm = pstep(pparams, popt, data.batch_at(s))
        assert abs(float(pm["loss"]) - float(m["loss"])) \
            <= LOSS_TOL * float(m["loss"])
        np.testing.assert_allclose(float(pm["lr"]), float(m["lr"]),
                                   rtol=2 * np.finfo(np.float32).eps)
    assert int(popt.step) == int(opt.step) == 5
    ref = _ref_paths(params)
    scale = max(float(np.abs(np.asarray(w)).max()) for _, w in ref)
    moved = 0.0
    for path, w in ref:
        got = _node(pparams, path).numpy()
        err = float(np.abs(got - np.asarray(w)).max())
        assert err <= PARAM_TOL[opt_state] * scale, (path, err)
        moved = max(moved, float(np.abs(np.asarray(w)
                                        - _node(start, path)).max()))
    # the steps moved the weights far beyond the tolerance
    assert moved > 10 * PARAM_TOL[opt_state] * scale
    # specs: shapes only, on the meta device
    assert specs["pshapes"]["embed"].device.type == "meta"
    leaf = specs["oshapes"].m["embed"]
    if opt_state == "int8":
        assert leaf["q"].dtype == torch.int8 and leaf["q"].is_meta
    else:
        assert leaf.dtype == torch.float32 and leaf.is_meta


@pytest.mark.parametrize("batch,seq,cfg_n,requested,want", [
    (8, 128, None, 2, 2), (8, 128, 4, None, 4), (8, 128, None, None, 1),
    (4, 32768, None, None, 4), (2, 65536, None, None, 2)])
def test_microbatch_count_is_the_reference_heuristic(batch, seq, cfg_n,
                                                     requested, want):
    pcfg = to_port_config(RC.get_config("qwen3-4b", smoke=True)).scaled(
        num_microbatches=cfg_n)
    assert PS.microbatch_count(pcfg, batch, seq, requested) == want
