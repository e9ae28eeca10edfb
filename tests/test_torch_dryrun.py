"""The multi-pod dry run (``launch/dryrun.py``), the port of
``repro/launch/dryrun.py``, on the CPU: the record heads and skipped
reasons of every (arch × shape) cell equal the reference's (its skipped
records written by its own ``run_cell`` in a subprocess: importing it sets
``XLA_FLAGS``); each argument tree's bytes on the (16, 16) production mesh
equal ``NamedSharding(mesh, spec).shard_shape``'s over the reference's
own specs (a subprocess with 256 host devices, nothing compiled); and the
CLI writes a skipped cell's record, imports no JAX, starts no process
group and sets no environment variable.  ``test_torch_dryrun_traces.py``
traces SMOKE configs at production shapes, ``test_torch_dryrun_mesh.py``
holds traces against real steps."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro import configs as RC

from repro_torch import configs as PC
from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
SKIPPED = [a for a in RC.ARCHS if not RC.cell_enabled(a, "long_500k")[0]]

REF_SKIPPED = textwrap.dedent("""
    import sys
    from repro.configs import ARCHS, cell_enabled
    from repro.launch.dryrun import run_cell
    for a in ARCHS:
        if not cell_enabled(a, "long_500k")[0]:
            run_cell(a, "long_500k", "single", out_dir=sys.argv[1])
""")

REF_BYTES = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    import json, math
    import jax
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs import ARCHS, SHAPES, get_config, input_specs
    from repro.launch.steps import (batch_specs_tree, cache_specs,
                                    make_serve_steps, make_train_step)
    mesh = jax.make_mesh((16, 16), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

    def nbytes(shapes, specs):
        sizes = jax.tree.map(
            lambda s, x: math.prod(NamedSharding(mesh, s).shard_shape(
                x.shape)) * x.dtype.itemsize, specs, shapes,
            is_leaf=lambda s: isinstance(s, P))
        return sum(jax.tree.leaves(sizes))

    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = SHAPES[name]
            ins = input_specs(cfg, shape)
            if shape.kind == "train":
                _, specs = make_train_step(cfg, mesh)
                got = {"params": nbytes(specs["pshapes"], specs["params"]),
                       "opt": nbytes(specs["oshapes"], specs["opt"]),
                       "batch": nbytes(ins, batch_specs_tree(ins, mesh))}
            else:
                _, _, specs = make_serve_steps(cfg, mesh, shape.seq_len,
                                               shape.global_batch)
                got = {"params": nbytes(specs["pshapes"], specs["params"])}
                if shape.kind == "prefill":
                    got["batch"] = nbytes(ins, batch_specs_tree(ins, mesh))
                else:
                    got["cache"] = nbytes(ins["cache"], cache_specs(
                        ins["cache"], mesh, shape.global_batch))
                    got["token"] = nbytes(ins["token"], P())
                    if "enc_out" in ins:
                        bs = batch_specs_tree({"x": ins["enc_out"]},
                                              mesh)["x"][0]
                        got["enc_out"] = nbytes(ins["enc_out"],
                                                P(bs, None, None))
            out[f"{arch}/{name}"] = got
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_bytes():
    """The reference's per-tree argument bytes, from a subprocess started
    at once (it runs while the port's side is computed)."""
    proc = subprocess.Popen([sys.executable, "-c", REF_BYTES], env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def result():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        return json.loads(out.strip().splitlines()[-1])

    yield result
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def fake256():
    """A fake group of 256 ranks and the (16, 16) production mesh on the
    CPU, for the module."""
    with D.fake_group(256):
        yield D.make_production_mesh(device="cpu")


@pytest.mark.parametrize("shape", RC.SHAPES)
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_record_heads_equal_the_references(arch, shape):
    rcfg, ref_shape = RC.get_config(arch), RC.SHAPES[shape]
    want = {"arch": arch, "shape": shape, "mesh": "single",
            "kind": ref_shape.kind, "seq_len": ref_shape.seq_len,
            "global_batch": ref_shape.global_batch,
            "n_params": rcfg.n_params(),
            "n_active_params": rcfg.active_params()}
    got = D._head(PC.get_config(arch), arch, PC.SHAPES[shape], "single")
    assert got == want
    assert PC.cell_enabled(arch, shape) == RC.cell_enabled(arch, shape)


def test_skipped_records_equal_the_references(tmp_path):
    """Every skipped cell's record, the reference's written by its own
    ``run_cell``: the same keys and values."""
    assert SKIPPED
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    out = subprocess.run([sys.executable, "-c", REF_SKIPPED, str(ref_dir)],
                         env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    for arch in SKIPPED:
        rec = D.run_cell(arch, "long_500k", "single", out_dir=str(port_dir))
        name = f"{arch}__long_500k__single.json"
        want = json.loads((ref_dir / name).read_text())
        assert json.loads((port_dir / name).read_text()) == want == rec


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_argument_bytes_equal_the_references_shards(fake256, shape,
                                                    reference_bytes):
    from torch._subclasses.fake_tensor import FakeTensorMode
    got = {}
    with FakeTensorMode():
        for arch in PC.ARCHS:
            _, args, _ = D.step_call(PC.get_config(arch),
                                     PC.SHAPES[shape], fake256)
            got[arch] = {k: D._local_bytes(v) for k, v in args.items()}
    want = reference_bytes()
    for arch in PC.ARCHS:
        assert got[arch] == want[f"{arch}/{shape}"], arch


def test_cli_writes_a_skipped_cells_record(tmp_path):
    """A full-attention arch's long_500k cell (Gemma2-9B's runs: its
    config is sub-quadratic, as the reference's is)."""
    assert RC.cell_enabled("gemma2-9b", "long_500k")[0]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-4b", "--shape", "long_500k", "--out", str(tmp_path)],
        env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "qwen3-4b__long_500k__single.json")
                     .read_text())
    assert rec["skipped"].startswith("full-attention arch")
    assert "skipped:" in out.stdout


def test_importing_the_dry_run_changes_nothing():
    """No JAX, no process group, no environment variable set."""
    code = ("import os, sys, torch.distributed as d\n"
            "env = dict(os.environ)\n"
            "import repro_torch.launch.dryrun\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad, d.is_initialized(), dict(os.environ) == env)\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[] False True"
