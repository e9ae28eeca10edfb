"""The pipeline, the elastic re-shard and the launchers on a mesh of four
gloo ranks, held against the JAX package.

* ``distributed.pipeline.pipeline_apply`` (GPipe over the ``pod`` axis:
  paired ``isend``/``irecv`` a hop, the last stage's outputs all-reduced)
  of ``tanh(x @ w_s)`` stages on (4, 1) and (2, 2) meshes over ``("pod",
  "data")``, against the reference's ``pipeline_apply`` on a (4, 2) and a
  (2, 4) mesh of ``AxisType.Auto`` axes (its default ``Explicit`` axes
  refuse the final ``out[0]`` on this JAX: ROADMAP C2) on the same
  weights and inputs, and against the stages composed in order, to 2e-5
  (``tests/test_distributed.py``'s bound); ``bubble_fraction`` exactly.
* The elastic round trip: Qwen3-4B's SMOKE weights placed by
  ``runtime.elastic.reshard_params`` on (4, 1), checkpointed, restored
  onto (2, 2) as ``reshard_params`` places them there, checkpointed,
  restored onto (1, 4): every leaf bitwise the reference's leaves (its
  ``init_params``, through its own ``reshard_params`` and
  ``CheckpointManager`` on 8 host devices), each mesh's placements those
  of its specs.
* The launchers' ``main`` under 4 gloo ranks at SMOKE size: each takes
  the host mesh ``(4, 1)``; training checkpoints from rank 0.
"""

import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.distributed.pipeline import bubble_fraction
from repro_torch.testing import mesh as tmesh

ROOT = Path(__file__).resolve().parents[1]
N = 4
PIPE_TOL = 2e-5
SHAPES = ((4, 1), (2, 2))
ELASTIC = ((4, 1), (2, 2), (1, 4))

#: the reference's pipeline on (4, 2) and (2, 4) Auto meshes over the
#: port's weights and inputs (argv[1], an npz), and its elastic round trip:
#: each mesh's leaves, to the npz at argv[2]
REFERENCE = textwrap.dedent("""
    import os, sys, tempfile
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.checkpoint.manager import CheckpointManager
    from repro.configs import get_config
    from repro.distributed.pipeline import pipeline_apply
    from repro.models.transformer import init_params
    from repro.runtime.elastic import reshard_params
    inp = np.load(sys.argv[1])
    out = {}
    for stages in (4, 2):
        mesh = jax.make_mesh((stages, 8 // stages), ("pod", "data"),
                             axis_types=(AxisType.Auto,) * 2)
        got = pipeline_apply(lambda w, x: jnp.tanh(x @ w),
                             jnp.asarray(inp[f"w{stages}"]),
                             jnp.asarray(inp[f"x{stages}"]), mesh=mesh,
                             axis="pod")
        out[f"pipe{stages}"] = np.asarray(got)
    cfg = get_config("qwen3-4b", smoke=True)
    params, axes = init_params(cfg, jax.random.PRNGKey(0))
    mgr = CheckpointManager(tempfile.mkdtemp())
    current = None
    for i, shape in enumerate(((4, 1), (2, 2), (1, 4))):
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        like = reshard_params(params, axes, mesh)
        current = like if current is None else mgr.restore(i, like)[1]
        mgr.save(i + 1, current, blocking=True)
        flat, _ = jax.tree_util.tree_flatten_with_path(current)
        for path, x in flat:
            key = "/".join(p.key for p in path)
            out[f"elastic{i}:/{key}"] = np.asarray(x)
    np.savez(sys.argv[2], **out)
""")


def _inputs():
    """The stages' weights and inputs, as ``testing.mesh.pipeline_suite``
    draws them for 4 and 2 stages."""
    import torch
    out = {}
    for stages in (4, 2):
        gen = torch.Generator().manual_seed(0)
        out[f"w{stages}"] = (torch.randn(stages, 16, 16, generator=gen)
                             * 0.3).numpy()
        out[f"x{stages}"] = torch.randn(6, 8, 16, generator=gen).numpy()
    return out


@pytest.fixture(scope="module")
def both():
    import jax
    from repro.configs import get_config
    from repro.models.transformer import init_params
    from repro_torch import configs as PC
    params, _ = init_params(get_config("qwen3-4b", smoke=True),
                            jax.random.PRNGKey(0))
    weights = jax.tree.map(np.asarray, params)
    cfg = PC.get_config("qwen3-4b", smoke=True)
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "in.npz"), **_inputs())
        proc = subprocess.Popen(
            [sys.executable, "-c", REFERENCE, os.path.join(tmp, "in.npz"),
             os.path.join(tmp, "out.npz")],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            ranks = tmesh.spawn(tmesh.run_suites, N, device="cpu", jobs=[
                ("pipeline_suite", {"shape": shape}) for shape in SHAPES] + [
                ("elastic_suite", dict(cfg=cfg, weights=weights,
                                       shapes=ELASTIC,
                                       directory=os.path.join(tmp, "ck"))),
                ("launcher_suite", {"directory": os.path.join(tmp, "run")})])
        finally:
            _, err = proc.communicate()
        assert proc.returncode == 0, err[-3000:]
        with np.load(os.path.join(tmp, "out.npz")) as z:
            ref = dict(z)
    n = len(SHAPES)
    return ref, [{"pipe": dict(zip(SHAPES, r[:n])), "elastic": r[n],
                  "launch": r[n + 1]} for r in ranks]


@pytest.mark.parametrize("shape", SHAPES)
def test_pipeline_equals_the_sequential_composition(both, shape):
    _, ranks = both
    for r in ranks:
        assert r["pipe"][shape]["err"] <= PIPE_TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_pipeline_follows_the_reference(both, shape):
    ref, ranks = both
    want = ref[f"pipe{shape[0]}"]
    for r in ranks:
        np.testing.assert_allclose(r["pipe"][shape]["out"], want,
                                   rtol=PIPE_TOL, atol=PIPE_TOL)


def test_bubble_fraction():
    assert bubble_fraction(2, 8) == 1 / 9
    assert bubble_fraction(4, 4) == 3 / 7
    assert bubble_fraction(1, 5) == 0.0


@pytest.mark.parametrize("i", range(len(ELASTIC)))
def test_elastic_round_trip_is_bitwise_the_reference(both, i):
    ref, ranks = both
    want = {k.split(":", 1)[1]: v for k, v in ref.items()
            if k.startswith(f"elastic{i}:")}
    for r in ranks:
        got = r["elastic"]["leaves"][i]
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            g = got[path]
            if w.dtype.name == "bfloat16":
                w = w.astype(np.float32)
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert g.tobytes() == w.tobytes(), path


def test_elastic_round_trip_is_bitwise_the_start(both):
    _, ranks = both
    assert all(r["elastic"]["bitwise"] for r in ranks)


def test_elastic_places_each_mesh_by_its_specs(both):
    from repro_torch import configs as PC
    from repro_torch.distributed.sharding import RULES_TRAIN, params_specs
    from repro_torch.models.transformer import abstract_params
    from types import SimpleNamespace
    shapes, axes = abstract_params(PC.get_config("qwen3-4b", smoke=True))
    _, ranks = both
    placed = ranks[0]["elastic"]["placements"]
    for i, (d, m) in enumerate(ELASTIC):
        specs = params_specs(shapes, axes, RULES_TRAIN, SimpleNamespace(
            shape={"data": d, "model": m}))
        wq = specs["groups"]["l0"]["mixer"]["wq"]
        want = ["Replicate()", "Replicate()"]
        for dim, axis in enumerate(wq):
            if axis is not None:
                want[("data", "model").index(axis)] = f"Shard(dim={dim})"
        assert placed[i]["/groups/l0/mixer/wq"] == f"({', '.join(want)})"


# ---------------------------------------------------------------------------
# The launchers under 4 gloo ranks
# ---------------------------------------------------------------------------

def test_serve_launcher_main_on_four_ranks(both):
    _, ranks = both
    for r in ranks:
        out = r["launch"]["serve"]
        assert sum(line.startswith("[serve] batch of") for line in out) == 2
        assert out[-1].startswith("[serve] 3 requests, 9 tokens")


def test_train_launcher_main_on_four_ranks(both):
    _, ranks = both
    losses = []
    for r in ranks:
        out = r["launch"]["train"]
        assert "mesh={'data': 4, 'model': 1}" in out[0]
        assert out[-1].startswith("[train] 3 steps in")
        losses.append([line.split("loss ")[1].split()[0] for line in out
                       if line.startswith("[train] step")])
    # every rank logged the same losses
    assert len(losses[0]) == 3 and all(x == losses[0] for x in losses)
