"""The PyTorch port stands alone: ``repro_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package, and the port's entry points refuse
to run on the CPU unless asked to."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "explain_torch.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import_in_source(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_import_leaves_jax_and_reference_out_of_sys_modules():
    """Every module of the port imports without pulling in JAX or the JAX
    package."""
    modules = sorted(
        ".".join(path.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for path in PORT_FILES if path.is_relative_to(ROOT / "src"))
    assert "repro_torch.models.lazy_transformer" in modules
    for kernel in ("flash_attention", "rmsnorm", "mamba_scan", "rwkv6_scan"):
        for part in ("ref", "kernel", "ops"):
            assert f"repro_torch.kernels.{kernel}.{part}" in modules
    for mod in ("kernels.rwkv6_scan.kernel_chunked", "configs.rwkv6_3b",
                "launch.serve", "core.tuning.calibrate",
                "core.tuning.profile", "core.partition_ilp",
                "core.obs.explain", "core.serve", "core.serve.server",
                "core.serve.store", "core.serve.admission",
                "core.backends.batch_body", "configs.gemma2_9b",
                "configs.qwen3_4b", "configs.starcoder2_3b",
                "configs.llava_next_mistral_7b", "configs.whisper_tiny",
                "configs.olmoe_1b_7b", "configs.qwen3_moe_235b_a22b",
                "configs.jamba_v01_52b", "optim", "optim.adamw",
                "optim.schedule", "optim.fused", "data", "data.pipeline",
                "checkpoint", "checkpoint.manager", "runtime",
                "runtime.fault", "launch.steps", "launch.train",
                "launch.mesh", "runtime.elastic", "distributed.pipeline",
                "launch.dryrun"):
        assert f"repro_torch.{mod}" in modules
    # neither JAX nor the JAX package, nor Triton (a kernel imports it when
    # it launches), nor the CUDA library (built and loaded at first launch)
    code = (f"import sys, {', '.join(modules)}\n"
            "from repro_torch.kernels import cuda_build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton'))\n"
            "print(bad, cuda_build._lib)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] None", out.stdout


def test_runtime_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.core import lazy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lazy.Runtime()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with lazy.fresh_runtime():
            pass
    monkeypatch.setattr(lazy, "_rt", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lazy.zeros(4)                   # the process default runtime too
    assert lazy.Runtime(device="cpu").device.type == "cpu"


def _one_op_block():
    from repro_torch.core.ir import BaseArray, Op, View
    n = 8
    a, b = BaseArray(n, np.dtype(np.float64)), BaseArray(n, np.dtype(np.float64))
    return [Op("mul", View.contiguous(b, (n,)), (View.contiguous(a, (n,)), 2.0),
               new_bases=frozenset({b}))]


def _entry_points():
    """Every public entry point that takes a device, called without one
    (``call()``) and with the CPU asked for (``call("cpu")``)."""
    from repro_torch.core.backends import LoweringContext
    from repro_torch.core.lazy import Runtime
    from repro_torch.core.serve import Server
    from repro_torch.core.executor import BlockExecutor, make_block_fn
    from repro_torch.kernels.fused_block import codegen, rowblock
    from repro_torch.kernels.fused_block.kernel import build_fused_kernel
    from repro_torch.kernels.fused_block.ops import fused_block_fn
    from repro_torch.kernels.fused_block.ref import reference_block
    from repro_torch.models.config import ModelConfig
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_cache, init_params
    from test_torch_rowblock import _replay_ops
    cfg = ModelConfig(name="tiny", family="dense", n_layers=1, d_model=8,
                      n_heads=2, n_kv_heads=2, d_ff=16, vocab_size=11)
    ops = _one_op_block()
    return {
        "fused_block_fn": lambda **kw: fused_block_fn(ops, **kw),
        "build_fused_kernel": lambda **kw: build_fused_kernel(ops, **kw),
        "build_block_kernel": lambda **kw: codegen.build_block_kernel(ops, **kw),
        "build_rowblock_kernel": lambda **kw: rowblock.build_rowblock_kernel(
            _replay_ops(2, 4), **kw),
        "make_block_fn": lambda **kw: make_block_fn(ops, **kw),
        "BlockExecutor": lambda **kw: BlockExecutor(**kw),
        "LoweringContext": lambda **kw: LoweringContext(**kw),
        "init_cache": lambda **kw: init_cache(cfg, 1, 4, **kw),
        "init_params": lambda **kw: init_params(
            cfg.scaled(dtype="float32"), torch.Generator(), **kw),
        "reference_block": lambda **kw: reference_block(ops, **kw),
        "Server": lambda **kw: Server(**kw),
        "Runtime.session": lambda **kw: Runtime(**kw).session(),
        "serve": lambda **kw: serve.main(
            ["--requests", "1", "--new-tokens", "2"]
            + [f"--{k}={v}" for k, v in kw.items()]),
        "make_train_step": lambda **kw: _train_step(cfg, **kw),
        "train": _train,
        "host_mesh": _host_mesh,
        "make_host_mesh": _make_host_mesh,
    }


def _host_mesh(**kw):
    """A mesh over a world of one (started here, then shut down)."""
    import torch.distributed as tdist
    from repro_torch.core.dist import host_mesh
    started = not tdist.is_initialized()
    try:
        mesh = host_mesh(**kw)
        assert mesh.device_type == "cpu" and mesh.size() == 1
    finally:
        if started and tdist.is_initialized():
            tdist.destroy_process_group()


def _make_host_mesh(**kw):
    """The launchers' ``(world, 1)`` mesh over a world of one (started
    here, then shut down)."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_host_mesh
    started = not tdist.is_initialized()
    try:
        mesh = make_host_mesh(**kw)
        assert mesh.device_type == "cpu" and tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
    finally:
        if started and tdist.is_initialized():
            tdist.destroy_process_group()


def _train_step(cfg, **kw):
    """One step of the train step on weights made on the CPU, wherever the
    step runs (it raises for weights off its device)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    cfg = cfg.scaled(dtype="float32")
    step, _ = make_train_step(cfg, **kw)
    params = init_params(cfg, torch.Generator(), "cpu")
    batch = {"tokens": np.ones((2, 4), np.int32),
             "labels": np.ones((2, 4), np.int32)}
    step(params, adamw_init(params), batch)


def _train(**kw):
    import tempfile
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as ckpt:
        train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq", "8",
                    "--ckpt-dir", ckpt]
                   + [f"--{k}={v}" for k, v in kw.items()])


ENTRY_POINTS = ["fused_block_fn", "build_fused_kernel", "build_block_kernel",
                "build_rowblock_kernel", "make_block_fn", "BlockExecutor",
                "LoweringContext", "init_cache", "init_params",
                "reference_block", "Server", "Runtime.session", "serve",
                "make_train_step", "train", "host_mesh", "make_host_mesh"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_needs_cuda_unless_cpu_is_asked(monkeypatch, name):
    """Without a card an entry point raises instead of running on the CPU
    behind the caller's back; asked for the CPU, it runs there."""
    call = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    call(device="cpu")


def test_dry_run_entry_point_needs_no_card(monkeypatch, tmp_path):
    """The dry run's entry points (``launch.dryrun.main`` and ``run_cell``)
    trace fake tensors: they run without a card, the CLI on fake CUDA
    tensors where PyTorch has CUDA and on the card's route on fake CPU
    tensors where it has not, ``run_cell`` on the device asked for."""
    import json
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen3-4b__long_500k__single.json")
                     .read_text())
    assert "skipped" in rec
    cfg = get_config("qwen3-4b", smoke=True).scaled(n_layers=1)
    with dryrun.fake_group(1):
        mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        rec = dryrun.run_cell(cfg, ShapeSpec("t", 16, 2, "train"), "1x1",
                              out_dir=None, mesh=mesh, device="cpu")
    assert rec["device"] == "cpu" and rec["flops_per_device"] > 0


def test_deferred_options_raise():
    """The mesh's options build and record: the ``comm`` model,
    ``gpu_dist`` (the port's ``tpu_dist``) and ``gpu_fma`` (its
    ``tpu_fma``), and sharded programs, whose tapes carry placement
    annotations.  The TPU-named models stay unknown.  Loop fusion (the
    default) and the ILP partitioner run."""
    from repro_torch.core import lazy
    from repro_torch.core.cost import make_cost_model
    from repro_torch.core.dist import tape_has_sharding
    from repro_torch.testing.tapegen import TapeProgram
    assert lazy.Runtime(device="cpu", loop_fusion=True)._loop is not None
    with lazy.fresh_runtime(device="cpu", partition_backend="ilp") as rt:
        x = lazy.ones(8) * 2.0
        assert x.numpy().tolist() == [2.0] * 8
        assert rt.history[-1]["ilp_status"] == "optimal"
    assert make_cost_model("comm").name == "comm"
    assert make_cost_model("comm").sparse_weights
    assert make_cost_model("gpu_dist").name == "gpu_dist"
    assert make_cost_model("gpu_fma").name == "gpu_fma"
    for name in ("tpu_dist", "tpu_fma"):
        with pytest.raises(ValueError, match="unknown cost model"):
            make_cost_model(name)
    prog = TapeProgram(0, sharded=True)
    assert prog.sharded and tape_has_sharding(prog.record())


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the script exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin",
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
