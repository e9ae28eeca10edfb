"""The model's placement on the mesh, in pure Python (no process group but
the fake one): ``models.transformer.abstract_params``' logical axes and
``launch/steps.py``'s ``opt_state_specs``, ``batch_specs_tree``,
``cache_specs`` and the specs of ``make_train_step`` and
``make_serve_steps``, each equal to the JAX package's for all ten configs
at their published sizes on the (16, 16) and (2, 16, 16) production mesh
shapes (duck-typed meshes: only the axis sizes are read).  Every
``ShapeSpec`` of ``configs.SHAPES`` gives the batch and cache shapes: a
train or prefill cell's inputs, a decode cell's cache (``long_500k``'s
batch of one takes the sequence-sharded k/v fallbacks) and Whisper's
``enc_out``.  Then ``launch/mesh.py``'s production meshes over the fake
process group (``torch.testing._internal.distributed.fake_pg``) of 256
and 512 ranks, in a subprocess, with the reference test's Qwen3-4B
expectations (``tests/test_distributed.py::
test_fsdp_shards_embed_on_production_mesh``)."""

import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro import configs as RC
from repro.distributed.sharding import RULES_TRAIN as REF_RULES
from repro.distributed.sharding import params_specs as ref_params_specs
from repro.launch import steps as RS
from repro.models import transformer as T
from repro.optim.adamw import adamw_init as ref_adamw_init

from repro_torch import configs as PC
from repro_torch.distributed.sharding import RULES_TRAIN, params_specs
from repro_torch.launch import steps as PS
from repro_torch.models import transformer as PT
from repro_torch.optim.adamw import adamw_init

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
MOMENTS = ("int8", "f32", "factored")


def _mesh(name):
    return SimpleNamespace(shape=MESHES[name])


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    return k


def _ref_flat(tree):
    """Key path -> the reference's spec entries, or a leaf's shape."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP) or (
            isinstance(x, tuple) and not hasattr(x, "_fields")))
    return {tuple(_key(k) for k in path):
            tuple(x.shape) if hasattr(x, "shape") else tuple(x)
            for path, x in flat}


def _port_flat(tree, prefix=()):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f, v in zip(tree._fields, tree):
            out.update(_port_flat(v, prefix + (f,)))
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree.shape) if hasattr(tree, "shape")
            else tuple(tree)}


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    return (T.abstract_params(RC.get_config(arch)),
            PT.abstract_params(PC.get_config(arch)))


@pytest.mark.parametrize("arch", RC.ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_abstract_params_axes_match_reference(arch, smoke):
    (_, want), (_, got) = (T.abstract_params(RC.get_config(arch, smoke)),
                           PT.abstract_params(PC.get_config(arch, smoke)))
    assert _port_flat(got) == _ref_flat(want)


@pytest.mark.parametrize("arch", RC.ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("moments", MOMENTS)
def test_opt_state_specs_match_reference(arch, mesh, moments):
    (rshapes, raxes), (pshapes, paxes) = _abstract(arch)
    m = _mesh(mesh)
    rspecs = ref_params_specs(rshapes, raxes, REF_RULES, m)
    want = RS.opt_state_specs(jax.eval_shape(functools.partial(
        ref_adamw_init, state_dtype=moments), rshapes), rspecs, m)
    got = PS.opt_state_specs(adamw_init(pshapes, state_dtype=moments),
                             params_specs(pshapes, paxes, RULES_TRAIN, m), m)
    assert _port_flat(got) == _ref_flat(want)


@pytest.mark.parametrize("arch", RC.ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_batch_and_cache_specs_match_reference(arch, mesh):
    m = _mesh(mesh)
    rcfg, pcfg = RC.get_config(arch), PC.get_config(arch)
    seen = set()
    for shape in RC.SHAPES.values():
        want_in = RC.input_specs(rcfg, shape)
        got_in = PC.input_specs(pcfg, PC.SHAPES[shape.name])
        if shape.kind != "decode":
            assert _port_flat(PS.batch_specs_tree(got_in, m)) == _ref_flat(
                RS.batch_specs_tree(want_in, m)), shape.name
            continue
        b = shape.global_batch
        got = _port_flat(PS.cache_specs(got_in["cache"], m, b))
        assert got == _ref_flat(RS.cache_specs(want_in["cache"], m, b)), \
            shape.name
        seen.update(v for v in got.values())
        if "enc_out" in want_in:        # Whisper's cross-attention source
            assert _port_flat(PS.batch_specs_tree(
                {"x": got_in["enc_out"]}, m)) == _ref_flat(
                RS.batch_specs_tree({"x": want_in["enc_out"]}, m))
    if arch in ("qwen3-4b", "gemma2-9b"):
        # long_500k's batch of one shards the cache's sequence instead
        assert any("data" in spec[2:3] or "model" in spec[2:3]
                   for spec in seen if len(spec) == 5)


@pytest.mark.parametrize("arch", RC.ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_specs_match_reference(arch, mesh):
    m = _mesh(mesh)
    _, want = RS.make_train_step(RC.get_config(arch), m)
    _, got = PS.make_train_step(PC.get_config(arch), m)
    for key in ("params", "opt", "axes", "pshapes", "oshapes"):
        assert _port_flat(got[key]) == _ref_flat(want[key]), key


@pytest.mark.parametrize("arch", RC.ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_serve_step_specs_match_reference(arch, mesh):
    m = _mesh(mesh)
    _, _, want = RS.make_serve_steps(RC.get_config(arch), m, 4096, 32)
    _, _, got = PS.make_serve_steps(PC.get_config(arch), m, 4096, 32)
    for key in ("params", "cache", "axes", "pshapes", "cshapes"):
        assert _port_flat(got[key]) == _ref_flat(want[key]), key


def test_train_step_without_a_mesh_has_the_one_by_one_specs():
    cfg = PC.get_config("qwen3-4b", smoke=True)
    _, got = PS.make_train_step(cfg, device="cpu")
    _, one = PS.make_train_step(cfg, SimpleNamespace(
        shape={"data": 1, "model": 1}))
    for key in ("params", "opt", "axes"):
        assert _port_flat(got[key]) == _port_flat(one[key])


PRODUCTION = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import RULES_TRAIN, params_specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import abstract_params
    out = {}
    for world, multi in ((256, False), (512, True), (4, False)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
        except ValueError as e:
            out[world] = {"error": str(e)}
            dist.destroy_process_group()
            continue
        shapes, axes = abstract_params(get_config("qwen3-4b"))
        specs = params_specs(shapes, axes, RULES_TRAIN, mesh)
        out[world] = {
            "shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
            "device": mesh.device_type,
            "wq": list(specs["groups"]["l0"]["mixer"]["wq"]),
            "embed": list(specs["embed"]),
            "lm_head": list(specs["lm_head"]),
            "wq_placements": [repr(p) for p in
                              specs["groups"]["l0"]["mixer"]["wq"]
                              .placements(mesh)]}
        dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def production():
    import json
    out = subprocess.run([sys.executable, "-c", PRODUCTION],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_production_mesh_over_256_fake_ranks(production):
    got = production["256"]
    assert got["shape"] == [16, 16] and got["names"] == ["data", "model"]
    assert got["device"] == "cpu"
    assert got["wq"] == [None, "data", "model"]     # (layers, embed, heads)
    assert got["embed"] == [None, "model"]          # gather-local table
    assert got["lm_head"] == ["data", "model"]
    assert got["wq_placements"] == ["Shard(dim=1)", "Shard(dim=2)"]


def test_multi_pod_mesh_over_512_fake_ranks(production):
    got = production["512"]
    assert got["shape"] == [2, 16, 16]
    assert got["names"] == ["pod", "data", "model"]
    assert got["wq"] == [None, "data", "model"]


def test_production_mesh_never_shrinks(production):
    assert "needs 256 ranks" in production["4"]["error"]


def test_importing_launch_mesh_starts_no_group():
    out = subprocess.run(
        [sys.executable, "-c", "import torch.distributed as d; "
         "import repro_torch.launch.mesh; print(d.is_initialized())"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0 and out.stdout.strip() == "False"
