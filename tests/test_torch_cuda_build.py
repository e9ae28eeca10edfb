"""The build of the port's CUDA kernels, checked without a compiler or a
card: the one ``nvcc`` command, where the library goes and how it is
named, and the errors a missing or failing compiler gives.  The kernels
themselves are built and held to their plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import os
import stat

import pytest
import torch

from repro_torch.kernels import cuda_build

ROOT = cuda_build.CSRC_DIR.parents[2]


def test_one_nvcc_call_for_every_source_for_sm_90a(tmp_path):
    """One compile command per source (run together), then one link."""
    compile_cmds, link = cuda_build.build_commands(tmp_path / "lib.so",
                                                   tmp_path / "obj", "nvcc")
    names = set()
    for cmd in compile_cmds:
        assert cmd[0] == "nvcc"
        i = cmd.index("-gencode")
        assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
        for flag in ("-std=c++17", "-O3", "-c"):
            assert flag in cmd
        assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
        srcs = [a for a in cmd if a.endswith(".cu")]
        assert len(srcs) == 1
        names.add(os.path.basename(srcs[0]))
        obj = cmd[cmd.index("-o") + 1]
        assert obj.endswith(".o") and obj in link
    assert names == {"decode_attention.cu", "errors.cu", "flash_attention.cu",
                     "mamba_scan.cu", "rwkv6_chunked.cu", "rwkv6_scan.cu"}
    assert len(compile_cmds) == len(names)
    assert link[0] == "nvcc" and "-shared" in link
    assert link[link.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert link[link.index("-o") + 1] == str(tmp_path / "lib.so")


def test_sources_include_no_torch_headers():
    """Plain C launchers: a source that includes PyTorch's headers takes
    minutes to build."""
    for src in cuda_build.CSRC_DIR.glob("*.cu*"):
        text = src.read_text()
        assert "torch/" not in text and "ATen" not in text, src
    for src in cuda_build.sources():
        assert 'extern "C"' in src.read_text(), src


def test_library_lives_under_build_named_by_its_sources(tmp_path, monkeypatch):
    path = cuda_build.library_path()
    assert path.parent == ROOT / "build" / "cuda"
    assert path.name.startswith("repro_torch_kernels_") and path.suffix == ".so"
    assert cuda_build.library_path() == path            # stable
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in cuda_build.CSRC_DIR.glob("*.cu*"):
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    assert cuda_build.library_path() == path            # same sources
    (csrc / "rwkv6_scan.cu").write_text("// edited\n")
    assert cuda_build.library_path() != path            # a stale name never


def test_missing_nvcc_raises_clearly(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "cuda")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.library()
    assert cuda_build._lib is None


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """One nvcc call per source; a failure raises with what the compiler
    said, links nothing, and leaves no library behind."""
    log = tmp_path / "args"
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\n"
                    "echo 'flash_attention.cu(1): error: boom' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "cuda")
    monkeypatch.setenv("PATH", f"{fake.parent}:{os.environ['PATH']}")
    with pytest.raises(RuntimeError, match="error: boom"):
        cuda_build.build()
    calls = log.read_text().splitlines()
    assert len(calls) == len(cuda_build.sources())
    assert all("arch=compute_90a,code=sm_90a" in c and " -c " in c
               for c in calls)
    assert not list((tmp_path / "cuda").glob("*.so"))
    assert not list((tmp_path / "cuda").glob("*.objects"))


@pytest.mark.parametrize("call", ["attention", "rmsnorm", "mamba", "rwkv6"])
def test_kernel_wrappers_run_on_cuda_or_cpu_only(call):
    """A tensor on any other device is refused, not computed somewhere
    else.  B4 (``rmsnorm``) refuses ``meta`` tensors; B3, B5 and B6 are
    custom operators whose fake implementation serves ``meta`` tensors
    with outputs on ``meta`` (shapes only, nothing computed), and which
    refuse every device type but the CPU, CUDA and ``meta``."""
    from types import SimpleNamespace
    from repro_torch.core.device import op_device
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan
    from repro_torch.kernels.rmsnorm.kernel import fused_add_rmsnorm
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan
    meta = lambda *shape: torch.empty(shape, device="meta")   # noqa: E731
    fns = {
        "attention": lambda: flash_attention(meta(1, 2, 8, 32),
                                             meta(1, 1, 8, 32),
                                             meta(1, 1, 8, 32)),
        "rmsnorm": lambda: fused_add_rmsnorm(meta(4, 32), meta(4, 32),
                                             meta(32)),
        "mamba": lambda: mamba_scan(meta(1, 8, 16), meta(1, 8, 16),
                                    meta(1, 8, 4), meta(1, 8, 4),
                                    meta(16, 4), meta(16)),
        "rwkv6": lambda: rwkv6_scan(*(meta(2, 8, 32) for _ in range(4)),
                                    meta(32)),
    }
    if call == "rmsnorm":
        with pytest.raises(RuntimeError, match="kernel for device meta"):
            fns[call]()
        return
    out = fns[call]()
    assert out.device.type == "meta"
    other = SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(RuntimeError, match="kernel for device xpu"):
        op_device({"a": other}, call)


def test_cuda_inputs_must_be_contiguous_and_of_one_dtype():
    x = torch.zeros(4)
    with pytest.raises(TypeError, match="one dtype"):
        cuda_build.require({"a": x, "b": x.double()}, (torch.float32,), "k")
    with pytest.raises(TypeError, match="one dtype"):
        cuda_build.require({"a": x.double()}, (torch.float32,), "k")
    with pytest.raises(ValueError, match="contiguous"):
        cuda_build.require({"a": torch.zeros(4, 4).t()}, (torch.float32,),
                           "k")
    cuda_build.require({"a": x}, (torch.float32,), "k")


def test_kernel_device_is_cpu_cuda_or_an_error():
    from repro_torch.core.device import kernel_device
    x = torch.zeros(4)
    assert kernel_device({"a": x, "b": x}, "k") is None
    with pytest.raises(ValueError, match="span devices"):
        kernel_device({"a": x, "b": torch.empty(4, device="meta")}, "k")
    with pytest.raises(RuntimeError, match="no k kernel for device meta"):
        kernel_device({"a": torch.empty(4, device="meta")}, "k")
