"""Build and load the port's CUDA C++ kernels.

Every ``src/repro_torch/csrc/*.cu`` is compiled for Hopper (``sm_90a``) by
its own ``nvcc`` process, all started together, and the objects are linked
by one more ``nvcc`` call into one shared library with a plain C interface,
``build/cuda/repro_torch_kernels_<hash>.so`` at the repository root, named
by a hash of the sources and the flags, so a stale library is never
loaded.  So the build takes as long as its slowest source, however many
kernels there are.  It is built at first use and loaded with
:mod:`ctypes`; the compiler's report (``-Xptxas -v``: registers, shared
memory, spills per kernel) is kept beside it in a ``.log`` file.

No source includes PyTorch's headers: each ``extern "C"`` launcher takes
raw device pointers, sizes and a ``cudaStream_t``, launches its kernel on
that stream and returns ``cudaGetLastError()``; :func:`check` raises on
anything but 0.  Nothing here touches CUDA when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", ARCH, "-shared")

#: dtype codes of the launchers (``csrc/common.cuh``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: ctypes types of the launchers' arguments, by the letter used in
#: :func:`function`'s signatures: p pointer or stream, i int, f float
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: dict = {}


def sources() -> list:
    """The CUDA sources compiled into the library, in a fixed order."""
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    """``nvcc`` on the ``PATH``, else the toolkit's default one; raises when
    there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError(f"nvcc not found (on the PATH or at {DEFAULT_NVCC}): "
                       "the CUDA kernels are built on a machine with the CUDA "
                       "toolkit")


def build_commands(out: Path, objects: Path, nvcc: str = "nvcc"):
    """The ``nvcc`` commands that build every source into ``out``: one
    compile command per source (its object under ``objects``), to run
    together, and the link command that follows them."""
    compile_cmds, objs = [], []
    for src in sources():
        obj = objects / f"{src.stem}.o"
        compile_cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                             str(src)])
        objs.append(str(obj))
    return compile_cmds, [nvcc, *LINK_FLAGS, "-o", str(out), *objs]


def build() -> Path:
    """Compile the library unless it exists; returns its path.  Compiles
    every source at once, then links; writes to a temporary name first, so
    a concurrent reader never sees half a file."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    objects = out.with_name(f"{out.stem}.{os.getpid()}.objects")
    objects.mkdir(exist_ok=True)
    try:
        compile_cmds, link_cmd = build_commands(tmp, objects, nvcc)
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compile_cmds]
        log, failed = [], []
        for cmd, proc in zip(compile_cmds, procs):
            text, _ = proc.communicate()
            log.append(f"== {Path(cmd[-1]).name}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{Path(cmd[-1]).name} ({proc.returncode})")
        if not failed:
            link = subprocess.run(link_cmd, capture_output=True, text=True)
            log.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append(f"link ({link.returncode})")
        text = "".join(log)
        out.with_suffix(".log").write_text(text)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{text}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(objects, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def function(name: str, signature: str):
    """The launcher ``name`` with its ``argtypes`` declared from
    ``signature`` (one letter per argument, see ``_CTYPES``): every pointer
    and the stream as ``c_void_p``, so ctypes never cuts them to 32 bits."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = [_CTYPES[c] for c in signature]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def launch(name: str, signature: str, args: Sequence,
           device: torch.device) -> None:
    """Call launcher ``name`` with ``args`` and the current stream of
    ``device`` (appended as the last argument), and raise on its error
    code."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        check(function(name, signature)(*args, stream), name)


def require(tensors: dict, dtypes, what: str) -> None:
    """Raise unless ``tensors`` (name -> tensor) are all contiguous and of
    one dtype among ``dtypes``: what the launchers take."""
    dts = {t.dtype for t in tensors.values()}
    if len(dts) != 1 or next(iter(dts)) not in dtypes:
        raise TypeError(f"{what}: the kernel takes inputs of one dtype among "
                        f"{[str(d) for d in dtypes]}, got "
                        f"{ {n: str(t.dtype) for n, t in tensors.items()} }")
    for n, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {n} is not contiguous")


def ptxas_report() -> str:
    """The ``-Xptxas -v`` lines of the last build of these sources: each
    kernel's name, then its registers and shared memory, then its spills."""
    log = library_path().with_suffix(".log")
    if not log.exists():
        return ""
    keep = ("Compiling entry function", "Used", "spill")
    return "\n".join(line.strip() for line in log.read_text().splitlines()
                     if any(k in line for k in keep))
