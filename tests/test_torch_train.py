"""The port's training modules against the JAX package, on the CPU: the
schedule, the μ-law int8 quantizer, AdamW for every moment dtype, the
synthetic data, the checkpoint manager, the fault-tolerant loop, the
straggler watchdog, the training driver and the WSP-fused AdamW tape.

Same numpy inputs in both packages (``np.random.default_rng``); the
reference's optimizer state reaches the port through
``optim.adamw.state_from_numpy``.

Tolerances.  ``cosine_warmup``: float32, within 2 ulps (XLA's and
PyTorch's float32 ``cos`` differ by one).  ``_quantize``: ``scale``
bitwise; ``q`` equal but for at most ``Q_OFF_SHARE`` = 1e-3 of the codes,
each off by exactly one (XLA's and libm's float32 ``log1p`` differ in the
last ulp, which moves a value lying at a rounding edge across it; measured
none off on these arrays).  ``_dequantize``: ``DEQ_RTOL`` = 1e-6 relative
(measured 3.0e-7: ``expm1``'s last ulps).  One AdamW update from the same
moments: parameters within ``UPD_TOL`` = 1e-6 of the largest parameter
magnitude (measured 5.6e-8), float32 moments within ``MOM_TOL`` = 1e-5 of
their largest (measured 3.4e-6: the clip factor comes from a float32 sum
of squares over every leaf, in other orders, and a moment's update can
cancel), bfloat16 moments within one bf16 ulp (``BF16_ULP`` = 2**-7 of
their largest; measured 6.3e-4), int8 codes as ``_quantize``'s (measured
one code in 8192 off by one) and their scales within ``MOM_TOL``
relative (measured 3.3e-6).  The reference's own quadratic and int8-vs-f32 tests keep their
bounds.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.lazy  # noqa: F401  (x64 on, as in the rest of the suite)
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import SyntheticLM as RefData
from repro.data.pipeline import make_batch_specs as ref_batch_specs
from repro.optim import adamw as RA
from repro.optim.schedule import cosine_warmup as ref_cosine

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, make_batch_specs
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PA
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               cosine_warmup)
from repro_torch.runtime import FaultTolerantLoop, StragglerWatchdog

F32_EPS = float(np.finfo(np.float32).eps)
Q_OFF_SHARE = 1e-3
DEQ_RTOL = 1e-6
UPD_TOL = 1e-6
MOM_TOL = 1e-5
BF16_ULP = 2.0 ** -7
STATE_DTYPES = ("f32", "int8", "bf16", "factored")


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("as_tensor", [True, False], ids=["tensor", "int"])
def test_cosine_warmup_matches_reference(as_tensor):
    kw = dict(peak_lr=1e-3, warmup=10, total=100)
    got = [float(cosine_warmup(torch.tensor(s, dtype=torch.int32)
                               if as_tensor else s, **kw))
           for s in range(101)]
    want = [float(ref_cosine(jnp.int32(s), **kw)) for s in range(101)]
    np.testing.assert_allclose(got, want, rtol=2 * F32_EPS, atol=0)
    assert got[0] == 0.0                # step 0 gives lr 0
    out = cosine_warmup(torch.tensor(7, dtype=torch.int32), **kw)
    assert out.dtype == torch.float32 and out.shape == ()


def test_cosine_schedule_shape():
    """The reference's shape test, on the port."""
    lrs = [float(cosine_warmup(torch.tensor(s, dtype=torch.int32),
                               peak_lr=1e-3, warmup=10, total=100))
           for s in range(101)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9
    assert abs(lrs[10] - 1e-3) < 1e-6
    assert lrs[100] < lrs[50] < lrs[10]
    assert lrs[100] >= 1e-4 - 1e-9     # floor


# ---------------------------------------------------------------------------
# The μ-law int8 quantizer
# ---------------------------------------------------------------------------

def _wide(rng, shape):
    """Values over twelve decades, signs mixed, one row all zero."""
    x = rng.standard_normal(shape) * np.exp(rng.uniform(-28, 0, shape))
    x[1] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 512), (3, 40, 300)])
def test_quantize_matches_reference(shape):
    x = _wide(np.random.default_rng(0), shape)
    want = RA._quantize(jnp.asarray(x))
    got = PA._quantize(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and got["q"].shape == x.shape
    assert got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    diff = got["q"].numpy().astype(int) - np.asarray(want["q"]).astype(int)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() <= Q_OFF_SHARE
    # round half to even, as jnp.round
    assert torch.equal(PA._quantize(torch.tensor([[0.0, 1.0]]))["q"],
                       torch.tensor([[0, 127]], dtype=torch.int8))


def test_dequantize_matches_reference():
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, (32, 256)).astype(np.int8)
    scale = np.exp(rng.uniform(-20, 2, (32, 1))).astype(np.float32)
    want = np.asarray(RA._dequantize({"q": jnp.asarray(q),
                                      "scale": jnp.asarray(scale)},
                                     q.shape, q.size))
    got = PA._dequantize({"q": torch.from_numpy(q),
                          "scale": torch.from_numpy(scale)}).numpy()
    np.testing.assert_allclose(got, want, rtol=DEQ_RTOL, atol=0)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _params(rng):
    """A leaf of every kind adamw_init tells apart: 1-D, 2-D big enough to
    quantize and to factor, 2-D too small for either, and a 3-D stack
    (updated a slice at a time in place)."""
    return {"b": rng.standard_normal(96).astype(np.float32),
            "w": rng.standard_normal((64, 128)).astype(np.float32),
            "small": rng.standard_normal((4, 8)).astype(np.float32),
            "stack": {"k": rng.standard_normal((3, 64, 80)).astype(
                np.float32)}}


def _grads(rng, params, scale=1.0):
    return jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape))
                        .astype(np.float32), params)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_tree(tree):
    return PT.params_from_numpy(_np_tree(tree), "cpu")


def _held(got, want, what):
    """One moment leaf or dict of the port against the reference's."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        if "q" in want:
            diff = got["q"].numpy().astype(int) \
                - np.asarray(want["q"]).astype(int)
            assert np.abs(diff).max() <= 1, what
            assert (diff != 0).mean() <= Q_OFF_SHARE, what
            np.testing.assert_allclose(got["scale"].numpy(),
                                       np.asarray(want["scale"]),
                                       rtol=MOM_TOL, err_msg=what)
            return
        for k in want:
            _held(got[k], want[k], f"{what}/{k}")
        return
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), what
    w = np.asarray(want, np.float32)
    big = float(np.abs(w).max()) or 1.0
    tol = BF16_ULP if got.dtype == torch.bfloat16 else MOM_TOL
    err = float(np.abs(got.float().numpy() - w).max())
    assert err <= tol * big, what


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_adamw_update_matches_reference(state_dtype):
    """From the reference's moments after one step, a second update with
    the clip active (the gradients' norm is far above 1) and a bf16
    gradient tree, as the train step hands it over."""
    rng = np.random.default_rng(2)
    params = jax.tree.map(jnp.asarray, _params(rng))
    state = RA.adamw_init(params, state_dtype=state_dtype)
    params, state = RA.adamw_update(params, _grads(rng, params), state,
                                    lr=1e-2)
    grads = jax.tree.map(lambda g: jnp.asarray(g).astype(jnp.bfloat16),
                         _grads(rng, params, scale=3.0))
    want_p, want_s = RA.adamw_update(params, grads, state, lr=1e-2,
                                     grad_scale=0.5)
    pparams = _port_tree(params)
    pstate = PA.state_from_numpy(_np_tree(tuple(state)), "cpu")
    pgrads = _port_tree(grads)
    got_p, got_s = adamw_update(pparams, pgrads, pstate, lr=1e-2,
                                grad_scale=0.5)
    assert isinstance(got_s, OptState) and int(got_s.step) == 2
    # updated in place, as the reference's jitted step donates them
    assert got_p is pparams and got_s.m is pstate.m and got_s.v is pstate.v
    assert int(pstate.step) == 1
    scale = max(float(np.abs(np.asarray(x)).max())
                for x in jax.tree.leaves(want_p))
    for path, w in jax.tree_util.tree_flatten_with_path(want_p)[0]:
        g = got_p
        for k in path:
            g = g[k.key]
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        assert err <= UPD_TOL * scale, (path, err)
    for name in ("m", "v"):
        is_leaf = lambda x: RA._is_q(x) or RA._is_factored(x)  # noqa: E731
        flat = jax.tree_util.tree_flatten_with_path(
            getattr(want_s, name), is_leaf=is_leaf)[0]
        for path, w in flat:
            g = getattr(got_s, name)
            for k in path:
                g = g[k.key]
            _held(g, w, f"{name}/{'/'.join(k.key for k in path)}")


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_adamw_init_matches_reference(state_dtype):
    params = _params(np.random.default_rng(3))
    want = RA.adamw_init(jax.tree.map(jnp.asarray, params),
                         state_dtype=state_dtype)
    got = adamw_init(_port_tree(params), state_dtype=state_dtype)
    assert got.step.dtype == torch.int32 and int(got.step) == 0
    for name in ("m", "v"):
        ref = jax.tree_util.tree_flatten_with_path(getattr(want, name))[0]
        port = dict(PA._paths(getattr(got, name)))
        flat = {}
        for path, leaf in port.items():
            if isinstance(leaf, dict):
                flat.update({path + (k,): v for k, v in leaf.items()})
            else:
                flat[path] = leaf
        assert sorted(flat) == sorted(tuple(k.key for k in p)
                                      for p, _ in ref)
        for path, w in ref:
            g = flat[tuple(k.key for k in path)]
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
    meta = adamw_init({"w": torch.empty(64, 256, device="meta")},
                      state_dtype=state_dtype)
    for leaf in PA._leaves(meta.m) + PA._leaves(meta.v):
        parts = leaf.values() if isinstance(leaf, dict) else [leaf]
        assert all(t.is_meta for t in parts)
    with pytest.raises(ValueError, match="state dtype"):
        adamw_init(_port_tree(params), state_dtype="int4")


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_adamw_reduces_quadratic(state_dtype):
    """The reference's test on the port: minimize ||x - t||^2; every state
    variant must converge."""
    gen = torch.Generator().manual_seed(0)
    target = torch.randn((128, 256), generator=gen)
    params = {"w": torch.zeros((128, 256))}
    state = adamw_init(params, state_dtype=state_dtype)

    def loss(p):
        return torch.mean((p["w"] - target) ** 2)

    l0 = float(loss(params))
    for _ in range(60):
        w = params["w"].detach().requires_grad_()
        grads = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        params, state = adamw_update(params, grads, state, lr=0.05,
                                     weight_decay=0.0)
    l1 = float(loss(params))
    assert l1 < 0.2 * l0, (state_dtype, l0, l1)


def test_adamw_int8_matches_f32_closely():
    """The reference's test on the port."""
    target = torch.randn((64, 512), generator=torch.Generator().manual_seed(1))
    outs = {}
    for sd in ("f32", "int8"):
        params = {"w": torch.zeros((64, 512))}
        state = adamw_init(params, state_dtype=sd)
        for _ in range(20):
            w = params["w"].detach().requires_grad_()
            g = torch.autograd.grad(torch.mean((w - target) ** 2), w)[0]
            params, state = adamw_update(params, {"w": g}, state, lr=0.05,
                                         weight_decay=0.0)
        outs[sd] = params["w"]
    err = float(torch.mean(torch.abs(outs["int8"] - outs["f32"])))
    ref = float(torch.mean(torch.abs(outs["f32"]))) + 1e-9
    assert err / ref < 0.15


def test_adamw_refuses_mismatched_trees():
    params = {"a": torch.zeros(4), "b": torch.zeros(4)}
    state = adamw_init(params, state_dtype="f32")
    with pytest.raises(ValueError, match="2 parameters, 1 gradients"):
        adamw_update(params, {"a": torch.zeros(4)}, state, lr=0.1)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-tiny",
                                  "llava-next-mistral-7b"])
def test_synthetic_batches_are_the_reference_bitwise(arch):
    """Dense, encoder-decoder (frames) and VLM (patch embeddings), two
    steps, a host shard."""
    for kw in ({}, {"host_id": 1, "n_hosts": 2}):
        ref = RefData(ref_get_config(arch, smoke=True), 4, 600, seed=5, **kw)
        port = SyntheticLM(get_config(arch, smoke=True), 4, 600, seed=5,
                           **kw)
        for step in (0, 13):
            want, got = ref.batch_at(step), port.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    it = port.iter(13)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  port.batch_at(13)["tokens"])
    assert (port.batch_at(0)["labels"] == -1).any()


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-tiny",
                                  "llava-next-mistral-7b"])
def test_batch_specs_match_reference(arch):
    want = ref_batch_specs(ref_get_config(arch), 8, 128)
    got = make_batch_specs(get_config(arch), 8, 128)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].is_meta and tuple(got[k].shape) == w.shape
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype)


# ---------------------------------------------------------------------------
# Checkpoint manager
# ---------------------------------------------------------------------------

def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=gen),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.tensor(3.5),
                  "h": torch.randn(5, generator=gen).to(torch.bfloat16)},
            "opt": OptState(step=torch.tensor(3, dtype=torch.int32),
                            m={"q": torch.tensor([[1, -2]], dtype=torch.int8),
                               "scale": torch.tensor([[0.5]])},
                            v=[torch.ones(2), torch.zeros(3)])}


def _same_tree(a, b):
    fa, fb = list(_flat(a)), list(_flat(b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def _flat(tree, prefix=""):
    from repro_torch.checkpoint.manager import _flatten
    return _flatten(tree, prefix)


def test_checkpoint_roundtrip_is_bitwise(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(10, t, blocking=True)
    like = _tree(1)
    step, got = mgr.restore(None, like)
    assert step == 10
    _same_tree(got, t)
    assert isinstance(got["opt"], OptState) and isinstance(got["opt"].v, list)
    # each leaf takes the like-leaf's dtype (and device)
    like["a"] = like["a"].double()
    _, got = mgr.restore(10, like)
    assert got["a"].dtype == torch.float64
    with pytest.raises(ValueError, match="other key paths"):
        mgr.restore(10, {"a": t["a"]})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(None, t)


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.latest_step() == 4
    steps = sorted(mgr.latest_steps())
    assert steps == [3, 4]


def test_checkpoint_atomicity(tmp_path):
    """A leftover .tmp dir is never picked up as a checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_99.tmp")
    mgr.save(5, _tree(), blocking=True)
    assert mgr.latest_step() == 5
    assert sorted(os.listdir(tmp_path / "step_5")) == ["leaves.npz",
                                                       "meta.json"]


def test_async_checkpoint_copies_at_save(tmp_path):
    """An async save holds the values of the call: a leaf updated in place
    right after (as the train step does) is saved as it was."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = _tree(7)
    want = _tree(7)
    mgr.save(7, t)
    t["a"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 7
    _same_tree(mgr.restore(7, t)[1], want)


def test_async_checkpoint_error_surfaces(tmp_path, monkeypatch):
    """A failed background write is raised by the next ``wait`` (or
    ``save``), and publishes nothing."""
    from repro_torch.checkpoint import manager

    def full_disk(*args, **kw):
        raise OSError("no space left on device")

    mgr = CheckpointManager(str(tmp_path), async_save=True)
    monkeypatch.setattr(manager.np, "savez", full_disk)
    mgr.save(2, {"x": torch.zeros(2)})
    with pytest.raises(OSError, match="no space"):
        mgr.wait()
    mgr.wait()                          # raised once
    assert mgr.latest_step() is None


# ---------------------------------------------------------------------------
# Fault tolerance
# ---------------------------------------------------------------------------

def _make_step(fail_at=None):
    fired = []

    def step_fn(state, batch):
        if fail_at is not None and batch == fail_at and not fired:
            fired.append(True)
            raise RuntimeError("injected node failure")
        return state + batch * 0.5
    return step_fn


def test_fault_loop_restores_and_replays(tmp_path):
    """A failure mid-run: the loop restores the checkpoint and gives the
    final state of a failure-free run (step-indexed data)."""
    loop1 = FaultTolerantLoop(CheckpointManager(str(tmp_path / "a"), keep=3),
                              save_every=3)
    clean = loop1.run(torch.tensor(0.0), _make_step(None), lambda s: s, 10)
    loop2 = FaultTolerantLoop(CheckpointManager(str(tmp_path / "b"), keep=3),
                              save_every=3)
    faulty = loop2.run(torch.tensor(0.0), _make_step(fail_at=7),
                       lambda s: s, 10)
    assert loop2.restarts == 1 and loop1.restarts == 0
    assert torch.equal(clean, faulty)
    assert loop2.ckpt.latest_step() == 10


def test_fault_loop_restores_a_save_in_flight(tmp_path, monkeypatch):
    """A failure while an async save is still being written: the loop
    waits for it and restores that step (the reference would find no
    checkpoint yet and replay from the start on the advanced state)."""
    from repro_torch.checkpoint import manager
    real_rename = os.rename

    def slow_rename(src, dst):
        time.sleep(0.3)
        real_rename(src, dst)

    monkeypatch.setattr(manager.os, "rename", slow_rename)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    restored, real_restore = [], mgr.restore
    monkeypatch.setattr(mgr, "restore", lambda step, like: (
        restored.append(step), real_restore(step, like))[1])
    loop = FaultTolerantLoop(mgr, save_every=2)
    out = loop.run(torch.tensor(0.0), _make_step(fail_at=2), lambda s: s, 4)
    assert restored == [2]
    assert float(out) == sum(s * 0.5 for s in range(4))


def test_fault_loop_gives_up_after_retries(tmp_path):
    loop = FaultTolerantLoop(CheckpointManager(str(tmp_path), keep=2),
                             save_every=100, max_retries=2)

    def always_fails(state, batch):
        raise RuntimeError("dead host")

    with pytest.raises(RuntimeError, match="dead host"):
        loop.run(torch.tensor(0.0), always_fails, lambda s: s, 5)
    assert loop.restarts == 3          # max_retries + the final attempt


def test_straggler_watchdog():
    fired = []
    w = StragglerWatchdog(factor=3.0, warmup_steps=3,
                          on_straggler=lambda s, d: fired.append(s))
    for i in range(5):
        assert not w.observe(i, 0.1)
    assert not fired
    assert w.observe(5, 0.9)           # 9x the median
    assert fired == [5] and w.straggler_steps == [5]
    for i in range(70):
        w.observe(6 + i, 0.1)
    assert len(w.durations) == 64      # a running window


# ---------------------------------------------------------------------------
# The driver and the fused AdamW tape
# ---------------------------------------------------------------------------

def test_train_driver_loss_improves(tmp_path, capsys):
    """The reference driver's run (30 steps of Qwen3-4B SMOKE, batch 4 x
    64, 2 microbatches, int8 moments) on the CPU: the loss falls; the
    final checkpoint holds step 30."""
    from repro_torch.launch.train import main
    main(["--arch", "qwen3-4b", "--smoke", "--steps", "30", "--batch", "4",
          "--seq", "64", "--lr", "3e-3", "--microbatches", "2",
          "--ckpt-dir", str(tmp_path), "--save-every", "10",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "loss improved" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 30


def test_wsp_fused_optimizer_single_block():
    """The reference's test on the port: greedy fuses the ~12-op update
    into fewer blocks than singleton, with the temporaries contracted
    (cost below 0.45x)."""
    from repro_torch.optim.fused import fused_update_cost
    single = fused_update_cost(n=4096, algorithm="singleton", device="cpu")
    fused = fused_update_cost(n=4096, algorithm="greedy", device="cpu")
    assert fused["n_blocks"] < single["n_blocks"]
    assert fused["n_blocks"] == 1
    assert fused["cost"] < 0.45 * single["cost"]


def test_adamw_tape_runs_as_one_block_on_the_floor_and_triton_plain():
    """The tape's outputs: the torch floor and the triton backend's plain
    route (the CPU's) agree bitwise, and equal the update in torch ops."""
    from repro_torch.core import lazy
    from repro_torch.optim.fused import record_adamw_tape
    outs = {}
    for backend in ("torch", "triton"):
        with lazy.fresh_runtime(backend=backend, device="cpu",
                                loop_fusion=False) as rt:
            res = record_adamw_tape(rt, 1000, lr=1e-2, c1=0.1, c2=0.05)
            outs[backend] = [r.numpy() for r in res]
            update = max((h for h in rt.history if not h.get("cached")),
                         key=lambda h: h["n_ops"])
            assert update["n_blocks"] == 1 and update["n_ops"] > 10
    for a, b in zip(outs["torch"], outs["triton"]):
        np.testing.assert_array_equal(a, b)
