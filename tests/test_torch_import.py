"""The PyTorch port stands alone: ``repro_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package, and the port's entry points refuse
to run on the CPU unless asked to."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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
        for path in PORT_FILES if path.name != "chip_smoke.py")
    assert "repro_torch.models.lazy_transformer" in modules
    code = (f"import sys, {', '.join(modules)}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


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


def test_deferred_options_raise():
    from repro_torch.core import lazy
    with pytest.raises(NotImplementedError):
        lazy.Runtime(device="cpu", loop_fusion=True)
    with lazy.fresh_runtime(device="cpu", partition_backend="ilp"):
        x = lazy.ones(8) * 2.0
        with pytest.raises(NotImplementedError):
            x.numpy()
        x._alive = False


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the script exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin",
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
