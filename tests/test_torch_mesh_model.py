"""The model on the mesh (``launch/steps.py``'s ``make_train_step(cfg,
mesh)`` and ``make_serve_steps``, the kernels' local calls) held against
the port's mesh-less runs and the JAX package's steps on a 2 x 2 mesh.

* Four gloo ranks at (2, 2) over ``("data", "model")``
  (``testing.mesh.spawn``, one spawn for the module, running
  ``testing.mesh.model_suite`` for each family): float32 SMOKE configs
  (the JAX package's weights, every leaf float32, the zero-initialised
  gains drawn) train two steps of two microbatches with float32 moments
  and serve a prefill and two decode steps (the tokens fed).  The
  reference runs the same in one subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on a (2, 2)
  mesh of ``AxisType.Auto`` axes (its default ``Explicit`` axes refuse
  the steps' sharding constraints on this JAX: ROADMAP C2), one thread
  for XLA's CPU work (the ranks take one each).  Losses
  within ``LOSS_TOL`` relative, parameters within ``PARAM_TOL["f32"]``
  of the largest parameter magnitude (``tests/test_torch_train_grads.py``:
  float32 sums in other orders, now also split over the ranks), lr within
  2 float32 ulps, serve logits within ``SERVE_TOL`` = 5e-5 of their
  largest magnitude; every rank's losses equal rank 0's.

This file takes the dense and Gemma2 families;
``tests/test_torch_mesh_families.py`` (VLM, encoder-decoder),
``tests/test_torch_mesh_moe.py``, ``tests/test_torch_mesh_mamba.py`` and
``tests/test_torch_mesh_rwkv.py`` the others with the same machinery
(each file starts its gloo world once and stays under a minute);
``tests/test_torch_mesh_one.py`` the 1 x 1 mesh and
``tests/test_torch_mesh_pipeline.py`` the launchers.
"""

import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro import configs as RC
from repro_torch.testing import mesh as tmesh
from test_torch_families import _inputs, _reference_weights
from test_torch_lm import to_port_config
from test_torch_train_grads import LOSS_TOL, PARAM_TOL, _batch

ROOT = Path(__file__).resolve().parents[1]
N = 4
SHAPE = (2, 2)
SERVE_TOL = 5e-5
TRAIN_KW = dict(num_microbatches=2, opt_state_dtype="f32", peak_lr=3e-3,
                warmup=2, total_steps=10)
STEPS = 2
PROMPT, DECODE = 16, 2
FAMILIES = ("qwen3-4b", "gemma2-9b")


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


#: families cut to fewer layers than their SMOKE config (Jamba-v0.1's is
#: one 8-layer period; at 2 layers, a Mamba layer with an MLP and one with
#: a MoE layer)
LAYERS = {"jamba-v0.1-52b": 2}


def reference_start(arch):
    """The weights a family's steps start from: the reference's SMOKE
    weights (``_reference_weights``; drawn from its ``init_params`` the
    same way for a cut config), every leaf float32."""
    if arch not in LAYERS:
        return _f32(_reference_weights(arch))
    import jax
    from repro.models import transformer as T
    from test_torch_families import _draw
    cfg = RC.get_config(arch, smoke=True).scaled(n_layers=LAYERS[arch])
    params, _ = T.init_params(cfg, jax.random.PRNGKey(0))
    return _f32(_draw(jax.tree.map(np.asarray, params),
                      np.random.default_rng(1), cfg.norm_plus_one))


def case(arch):
    """One family's float32 SMOKE config (reference and port), weights,
    train batches and serve inputs."""
    cfg = RC.get_config(arch, smoke=True).scaled(dtype="float32",
                                                 param_dtype="float32")
    if arch in LAYERS:
        cfg = cfg.scaled(n_layers=LAYERS[arch])
    rng = np.random.default_rng(5)
    serve = {"tokens": rng.integers(0, cfg.vocab_size, (2, PROMPT)).astype(
        np.int32), "decode": rng.integers(0, cfg.vocab_size, (2, DECODE))
        .astype(np.int32), **_inputs(cfg, rng)}
    return {"cfg": cfg, "pcfg": to_port_config(cfg),
            "weights": reference_start(arch),
            "batches": [_batch(cfg, seed=s, batch=4, seq=16)
                        for s in range(STEPS)], "serve": serve}


#: the reference on a (2, 2) mesh of Auto axes: each family's losses, lr,
#: trained parameters and serve logits, pickled to the path in argv[1]
REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.launch.steps import make_serve_steps, make_train_step
    from repro.models import transformer as T
    from repro.optim.adamw import adamw_init
    cases, kw, path = pickle.load(open(sys.argv[1], "rb"))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, c in cases.items():
        cfg, res = c["cfg"], {}
        params = jax.tree.map(jnp.asarray, c["weights"])
        step, _ = make_train_step(cfg, mesh, **kw)
        step = jax.jit(step)
        opt = adamw_init(params, state_dtype=kw["opt_state_dtype"])
        res["losses"], res["lr"] = [], []
        for b in c["batches"]:
            params, opt, m = step(params, opt, {k: jnp.asarray(v)
                                                for k, v in b.items()})
            res["losses"].append(float(m["loss"]))
            res["lr"].append(float(m["lr"]))
        flat, _ = jax.tree_util.tree_flatten_with_path(params)
        res["params"] = {tuple(p.key for p in path): np.asarray(x)
                         for path, x in flat}
        s = c["serve"]
        max_seq = s["tokens"].shape[1] + s["decode"].shape[1] + (
            cfg.n_patches if cfg.family == "vlm" else 0)
        prefill, decode, _ = make_serve_steps(cfg, mesh, max_seq,
                                              s["tokens"].shape[0])
        params = jax.tree.map(jnp.asarray, c["weights"])
        inputs = {"tokens": jnp.asarray(s["tokens"])}
        for k in ("frames", "patch_embeds"):
            if k in s:
                inputs[k] = jnp.asarray(s[k])
        logits, cache = jax.jit(prefill)(params, inputs)
        res["prefill"] = np.asarray(logits)
        enc = None
        if "frames" in s:
            enc = jax.jit(lambda p, f: T.encode(p, f, cfg))(
                params, inputs["frames"])
        dec = jax.jit(decode)
        res["decode"] = []
        for j in range(s["decode"].shape[1]):
            logits, cache = dec(params, cache,
                                jnp.asarray(s["decode"][:, j:j + 1]), enc)
            res["decode"].append(np.asarray(logits))
        out[arch] = res
    pickle.dump(out, open(path, "wb"))
""")


def run_both(families):
    """Each family's results from the reference's subprocess and the
    port's 4 ranks (run at once): ``{arch: (reference, [rank results])}``."""
    cases = {arch: case(arch) for arch in families}
    ref_cases = {a: {k: c[k] for k in ("cfg", "weights", "batches", "serve")}
                 for a, c in cases.items()}
    with tempfile.TemporaryDirectory() as tmp:
        args = os.path.join(tmp, "in.pkl")
        with open(args, "wb") as f:
            pickle.dump((ref_cases, TRAIN_KW, os.path.join(tmp, "out.pkl")),
                        f)
        proc = subprocess.Popen(
            [sys.executable, "-c", REFERENCE, args],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            ranks = tmesh.spawn(tmesh.run_suites, N, device="cpu", jobs=[
                ("model_suite", dict(cfg=c["pcfg"], weights=c["weights"],
                                     shape=SHAPE, batches=c["batches"],
                                     train_kw=TRAIN_KW, serve=c["serve"]))
                for c in cases.values()])
        finally:
            _, err = proc.communicate()
        assert proc.returncode == 0, err[-3000:]
        with open(os.path.join(tmp, "out.pkl"), "rb") as f:
            ref = pickle.load(f)
    return {a: (ref[a], [r[i] for r in ranks])
            for i, a in enumerate(families)}


def check_losses(ref, ranks):
    got = ranks[0]
    for r in ranks[1:]:
        assert r["losses"] == got["losses"]
    for g, w in zip(got["losses"], ref["losses"]):
        assert abs(g - w) <= LOSS_TOL * abs(w), (g, w)
    np.testing.assert_allclose(got["lr"], ref["lr"],
                               rtol=2 * np.finfo(np.float32).eps)


def check_params(ref, ranks, start):
    got = ranks[0]["params"]
    assert sorted(got) == sorted(ref["params"])
    scale = max(float(np.abs(w).max()) for w in ref["params"].values())
    moved = worst = 0.0
    for path, w in ref["params"].items():
        err = float(np.abs(got[path] - np.asarray(w, np.float32)).max())
        assert err <= PARAM_TOL["f32"] * scale, (path, err)
        worst = max(worst, err)
        node = start
        for k in path:
            node = node[k]
        moved = max(moved, float(np.abs(np.asarray(w) - node).max()))
    # the steps moved the weights far beyond the two packages' difference
    assert moved > 10 * worst


def check_serve(ref, ranks):
    for r in ranks:
        for got, want in zip([r["prefill"]] + r["decode"],
                             [ref["prefill"]] + ref["decode"]):
            want = np.asarray(want, np.float32)
            assert got.shape == want.shape
            err = float(np.abs(got - want).max())
            assert err <= SERVE_TOL * float(np.abs(want).max()), err


@pytest.fixture(scope="module")
def both():
    return run_both(FAMILIES)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_losses_follow_the_reference_mesh(both, arch):
    ref, ranks = both[arch]
    check_losses(ref, ranks)


@pytest.mark.parametrize("arch", FAMILIES)
def test_trained_params_follow_the_reference_mesh(both, arch):
    ref, ranks = both[arch]
    check_params(ref, ranks, reference_start(arch))


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_logits_follow_the_reference_mesh(both, arch):
    ref, ranks = both[arch]
    check_serve(ref, ranks)


@pytest.mark.parametrize("arch", FAMILIES)
def test_attention_runs_on_each_ranks_heads(both, arch):
    """Every rank ran the train steps with collectives (CommDebugMode saw
    them), its moments placed by ``adamw_init`` as ``opt_state_specs``
    places them, and the serve steps; on the CPU the local calls take the
    plain attention (no kernel launch)."""
    _, ranks = both[arch]
    for r in ranks:
        assert r["opt_placed"]      # adamw_init placed them as the specs
        assert len(r["losses"]) == STEPS
        assert sum(r["comm"]["train_step_0"].values()) > 0
        assert all(n == 0 for n in r["serve_launches"].values())
