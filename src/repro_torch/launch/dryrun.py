"""Multi-pod dry run: the port of ``repro/launch/dryrun.py``.  Every (arch
× shape) cell is traced over the production mesh, one rank's step on fake
tensors, and its roofline inputs recorded; nothing is computed and no
memory is allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-4b --shape train_4k --mesh single

The reference lowers and compiles each cell with XLA over 512 placeholder
host devices and reads the compiled program.  PyTorch has no HLO: here a
cell starts the fake process group
(``torch.testing._internal.distributed.fake_pg``) with 256 ranks
(``single``) or 512 (``multi``), builds ``launch/mesh.py``'s production
mesh on it (``"cuda"`` by default: the card's tensors, faked; the CPU only
when asked), makes every argument under ``FakeTensorMode`` a DTensor from
its local shard (``DTensor.from_local`` with the spec's placements: the
parameters, the moments, the batch, the decode cache, Whisper's
``enc_out``) and runs one call of the step the card runs —
``make_train_step``'s, or ``make_serve_steps``' prefill or decode — at
the cell's published shape and full depth.  The trace runs every
microbatch and layer, so nothing is folded.  Kernels B3, B5, B6 and B7 are
custom operators: their fake implementations pass the trace through what
the card would launch.  So is B5's plain backward
(``mamba_scan_backward``), whose fake also makes a buffer of the plain
backward's peak temporaries, labelled ``mamba_scan.backward``.  What the trace sees of one rank is counted by
:class:`LocalCounter` (a dispatch mode below DTensor: the local operations,
never DTensor's global ones) and by ``MemTracker``.

Fake CUDA tensors need a PyTorch built with CUDA (the card's machine
has one; no card and no CUDA memory is used): its Python bindings' device
guards refuse them in a CPU-only build.  There the CLI traces fake CPU
tensors on the card's route instead (``core.device.card_route``: every
kernel call site on its operator, DTensor's shard-to-shard moves as
all-to-alls), the same local operations; ``run_cell`` traces the device
it is given.

Per cell it writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(the reference's names and head keys, then ``n_devices``, ``device`` and
``route``) with:
  * ``memory``: ``argument_size_in_bytes`` (this rank's local shards of
    every argument) and ``arguments`` (the same by argument),
    ``output_size_in_bytes``, ``alias_size_in_bytes`` (outputs in an
    argument's memory: written in place) and ``temp_peak_bytes``
    (``MemTracker``'s peak over the trace, less the arguments);
  * ``flops_per_device``: the FLOPs of the local operations, each kernel
    by its formula; ``dot_flops_per_device`` the matmuls' alone,
    ``kernel_flops_per_device`` the kernels', ``kernel_calls`` by kernel;
  * ``op_bytes_per_device``: the input and output bytes of each local
    operation that is not a view;
  * ``collectives``: each kind's result bytes on the local shapes, and
    ``counts`` (the reference's five kinds, then any other the trace
    makes: ``scatter`` and ``broadcast`` where a step places a whole
    tensor);
  * ``top_buffers``: the 12 largest tensors the trace made, by the
    operation and the source line that made them and, as ``range``, the
    innermost program span open around it (``core.obs.trace``, which the
    trace installs where no tracer is): a forward buffer names its
    sublayer (``layer.attn``, ``layer.moe``, ...) or ``model.embed`` /
    ``model.head``, not the whole ``train_step.forward_backward``;
  * ``t_trace_s``: the trace's wall time.
A cell ``cell_enabled`` skips writes the reference's skipped record.

Importing this module starts no process group and sets no environment
variable.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time
import traceback
from collections import Counter
from collections.abc import Mapping
from typing import Dict, Optional

import torch

from ..core.device import card_route
from ..core.obs import trace
from ..configs import ARCHS, SHAPES, ShapeSpec, cell_enabled, get_config, \
    input_specs
from ..models.config import ModelConfig
from .mesh import make_production_mesh

OUT_DIR = "experiments/dryrun_torch"

#: the reference's collective kinds, by the words of the ops' names
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"))
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_TOP = 12
#: a tensor's device queried through the dispatcher (the autograd engine
#: asks it of every gradient): no operation, nothing read or made
_DEVICE = torch.ops.prim.device.default
_propagating = threading.local()


def _is_uncounted() -> bool:
    return getattr(_propagating, "on", False)


@contextlib.contextmanager
def _propagation_uncounted():
    """While active, the ops DTensor's sharding propagation runs (each op
    once more, on global fake tensors) are not counted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        prev = _is_uncounted()
        _propagating.on = True
        try:
            return orig(self, op_schema)
        finally:
            _propagating.on = prev

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


@contextlib.contextmanager
def _card_collectives():
    """DTensor's shard-to-shard moves as the card makes them, on a CPU
    mesh too: one all-to-all (``_dtensor.shard_dim_alltoall``), where a
    CPU mesh of real ranks falls back to an all-gather and a chunk (gloo
    has no all-to-all)."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._collective_utils import funcol
    orig = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, Mapping):
        for y in x.values():
            yield from _tensors(y)


def _where() -> str:
    """The innermost frame of the port's models, launchers or optimizer
    that is running: ``file:line function``."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename.replace(os.sep, "/")
        if "/repro_torch/" in path and "/launch/dryrun.py" not in path \
                and "/kernels/" not in path:
            rel = path.split("/repro_torch/", 1)[1]
            return f"{rel}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return ""


def _collective_kind(name: str) -> str:
    """The reference's kind of a collective op, else its own name
    (``scatter``, ``broadcast``...)."""
    for word, kind in _KINDS:
        if word in name:
            return kind
    return name.strip("_")


def _collective_ops() -> set:
    """The ops ``CommDebugMode`` counts as collectives."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.debug._comm_mode import c10d_collective_ops
    return set(CommDebugMode().comm_registry) | set(c10d_collective_ops)


def _innermost_span() -> str:
    """The name of the innermost span open on this thread, or ""."""
    t = trace.active()
    spans = t.open_spans() if t is not None else ()
    return spans[-1] if spans else ""


class LocalCounter:
    """What one rank's local operations do, counted by a dispatch mode that
    lets DTensor run first (it returns ``NotImplemented`` for DTensor
    arguments, as ``CommDebugMode`` and ``MemTracker`` do) and so sees the
    local operations DTensor issues: FLOPs by ``torch.utils.flop_counter``'s
    formulas (a kernel's registered with it), ops not in the registry
    decomposed first as ``FlopCounterMode`` does; input and output bytes;
    the collectives; the kernels' calls; the largest tensors made."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self
        self.flops = 0
        self.dot_flops = 0
        self.kernel_flops = 0
        self.op_bytes = 0
        self.kernel_calls: Counter = Counter()
        self.collectives = {k: 0 for k in KINDS}
        self.collective_counts = {k: 0 for k in KINDS}
        self.sites: Dict[tuple, int] = {}
        self.registry = registry = flop_registry   # the kernels' too
        self.comms = _collective_ops()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                if isinstance(func, torch._ops.HigherOrderOperator) \
                        or _is_uncounted() or func is _DEVICE:
                    return func(*args, **kwargs)
                packet = func._overloadpacket
                if packet not in registry:
                    with self:
                        r = func.decompose(*args, **kwargs)
                        if r is not NotImplemented:
                            return r
                out = func(*args, **kwargs)
                counter._count(func, packet, args, kwargs, out)
                return out

        self.mode = Mode()

    def _count(self, func, packet, args, kwargs, out):
        name = packet.__name__
        ns = packet._qualified_op_name.split("::")[0]
        if packet in self.registry:
            n = int(self.registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            if ns == "repro_torch":
                self.kernel_flops += n
            else:
                self.dot_flops += n
        if ns == "repro_torch":         # a kernel (an in-place form: _)
            self.kernel_calls[name.rstrip("_")] += 1
        if packet in self.comms:
            kind = _collective_kind(name)
            self.collectives.setdefault(kind, 0)
            self.collective_counts.setdefault(kind, 0)
            self.collectives[kind] += sum(_nbytes(t) for t in _tensors(out))
            self.collective_counts[kind] += 1
        if func.is_view:
            return
        outs = list(_tensors(out))
        self.op_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.op_bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            b = _nbytes(t)
            if len(self.sites) >= _TOP and b <= min(self.sites.values()):
                continue
            site = (str(func), _where(), _innermost_span(),
                    tuple(t.shape), str(t.dtype).removeprefix("torch."))
            if b > self.sites.get(site, 0):
                self.sites[site] = b
                if len(self.sites) > 4 * _TOP:
                    keep = sorted(self.sites.items(), key=lambda kv: -kv[1])
                    self.sites = dict(keep[:_TOP])

    def top_buffers(self, k: int = _TOP):
        top = sorted(self.sites.items(), key=lambda kv: -kv[1])[:k]
        return [{"name": op, "where": where, "range": rng,
                 "shape": list(shape), "dtype": dtype, "bytes": b,
                 "gb": round(b / 1e9, 4)}
                for (op, where, rng, shape, dtype), b in top]

    def record(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "dot_flops_per_device": self.dot_flops,
            "kernel_flops_per_device": self.kernel_flops,
            "kernel_calls": dict(self.kernel_calls),
            "op_bytes_per_device": self.op_bytes,
            "collectives": {**self.collectives,
                            "counts": dict(self.collective_counts)},
            "top_buffers": self.top_buffers()}


def _memory_tracker():
    """``MemTracker``, blind to DTensor's propagation
    (:func:`_propagation_uncounted`)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is _DEVICE:         # a query: no tensor is made
                return func(*args, **(kwargs or {}))
            if _is_uncounted():
                from torch.distributed.tensor import DTensor
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Tracker()


# ---------------------------------------------------------------------------
# The fake group and the arguments
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks (this process is rank 0) for
    as long as the block runs; no collective moves any data."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        raise RuntimeError("a process group is already up")
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def _local(meta: torch.Tensor, spec, mesh):
    """A DTensor of ``meta``'s shape and dtype placed by ``spec``, from this
    rank's local shard (made under the active fake mode)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    placements = spec.placements(mesh)
    shape = tuple(meta.shape)
    with unset_fake_temporarily():      # it reads the rank's coordinates
        local, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                         placements)
    t = torch.empty(local, dtype=meta.dtype, device=mesh.device_type)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _place_tree(shapes, specs, mesh):
    """``shapes`` (nested dicts of ``meta`` tensors) as DTensors placed by
    ``specs`` (the same nesting; a moment's spec may be a dict)."""
    if isinstance(shapes, Mapping):
        return {k: _place_tree(v, specs[k], mesh) for k, v in shapes.items()}
    return _local(shapes, specs, mesh)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(t._local_tensor if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def _locals(tree):
    from torch.distributed.tensor import DTensor
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


# ---------------------------------------------------------------------------
# A cell
# ---------------------------------------------------------------------------

def step_call(cfg: ModelConfig, shape: ShapeSpec, mesh, train_kw=None):
    """``(fn, args, inplace)``: the step the card runs for this cell, its
    arguments by name (in call order) as DTensors from their local shards
    (made under the active fake mode) and the names of those it writes
    into: ``params``, ``opt`` (the moments and the step count) and
    ``batch`` for a train step; ``params`` and ``batch`` for a prefill;
    ``params``, ``cache``, ``token`` and Whisper's ``enc_out`` for a
    decode step."""
    from ..distributed.sharding import PartitionSpec as P
    from ..optim.adamw import OptState
    from .steps import (batch_specs_tree, cache_specs, make_serve_steps,
                        make_train_step)
    ins = input_specs(cfg, shape)
    if shape.kind == "train":
        step, specs = make_train_step(cfg, mesh, **(train_kw or {}))
        o = specs["oshapes"]
        args = {"params": _place_tree(specs["pshapes"], specs["params"],
                                      mesh),
                "opt": OptState(step=torch.zeros((), dtype=torch.int32,
                                                 device=mesh.device_type),
                                m=_place_tree(o.m, specs["opt"].m, mesh),
                                v=_place_tree(o.v, specs["opt"].v, mesh)),
                "batch": _place_tree(ins, batch_specs_tree(ins, mesh),
                                     mesh)}
        return step, args, ("params", "opt")
    prefill, decode, specs = make_serve_steps(
        cfg, mesh, max_seq=shape.seq_len, batch=shape.global_batch)
    params = _place_tree(specs["pshapes"], specs["params"], mesh)
    if shape.kind == "prefill":
        return prefill, {"params": params, "batch": _place_tree(
            ins, batch_specs_tree(ins, mesh), mesh)}, ()
    args = {"params": params,
            "cache": _place_tree(ins["cache"], cache_specs(
                ins["cache"], mesh, shape.global_batch), mesh),
            "token": _local(ins["token"], P(), mesh)}
    if "enc_out" in ins:               # whisper's cross-attention source
        bs = batch_specs_tree({"x": ins["enc_out"]}, mesh)["x"][0]
        args["enc_out"] = _local(ins["enc_out"], P(bs, None, None), mesh)
    return decode, args, ("cache",)


def _head(cfg: ModelConfig, name: str, shape: ShapeSpec, mesh_kind: str):
    return {"arch": name, "shape": shape.name, "mesh": mesh_kind,
            "kind": shape.kind, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch,
            "n_params": cfg.n_params(),
            "n_active_params": cfg.active_params()}


def run_cell(arch, shape, mesh_kind: str = "single",
             out_dir: Optional[str] = OUT_DIR, *, mesh=None,
             device="cuda", train_kw: Optional[dict] = None,
             kernels: bool = True) -> Dict:
    """Trace one cell and return (and, unless ``out_dir`` is None, write)
    its record.  ``arch``: a name of ``configs.ARCHS`` or a
    ``ModelConfig``; ``shape``: a name of ``configs.SHAPES`` or a
    ``ShapeSpec``.  Without ``mesh`` the cell starts the fake group of 256
    or 512 ranks (``mesh_kind``) and the production mesh on ``device``;
    with one (a ``DeviceMesh`` over ``("data", "model")`` or ``("pod",
    "data", "model")`` on a group that is up, fake or real) it traces over
    it, and ``mesh_kind`` only labels the record.  ``train_kw`` goes to
    ``make_train_step`` (``num_microbatches``, ``opt_state_dtype``...).
    ``kernels``: trace the card's route on CPU tensors too (every kernel
    call site on its operator, ``core.device.card_route``, and DTensor's
    shard-to-shard moves as all-to-alls); with False a CPU trace takes the
    CPU's own route (B3's plain attention, gloo's all-gather in place of an
    all-to-all), as a real step over gloo does."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    name = arch if isinstance(arch, str) else cfg.name
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    rec = _head(cfg, name, shape, mesh_kind)
    enabled, why = (cell_enabled(name, shape.name)
                    if name in ARCHS and SHAPES.get(shape.name) == shape
                    else (True, ""))
    if not enabled:
        rec["skipped"] = why
        if out_dir is not None:
            _write(rec, out_dir)
        return rec
    if mesh is None:
        world = 512 if mesh_kind == "multi" else 256
        with fake_group(world):
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                        device=device)
            return _trace(cfg, shape, mesh, rec, out_dir, train_kw,
                          kernels)
    return _trace(cfg, shape, mesh, rec, out_dir, train_kw, kernels)


def _trace(cfg, shape, mesh, rec, out_dir, train_kw, kernels) -> Dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    rec["n_devices"] = mesh.size()
    rec["device"] = mesh.device_type
    rec["route"] = "card" if kernels or mesh.device_type == "cuda" \
        else "cpu"
    t0 = time.perf_counter()
    counter = LocalCounter()
    route = contextlib.ExitStack()
    if kernels:
        route.enter_context(card_route())
        if mesh.device_type == "cpu":
            route.enter_context(_card_collectives())
    with FakeTensorMode(), _propagation_uncounted(), route:
        fn, args, inplace = step_call(cfg, shape, mesh, train_kw)
        by_tree = {k: _local_bytes(v) for k, v in args.items()}
        arg_locals = _locals(list(args.values()))
        tracker = _memory_tracker()
        tracker.track_external(*arg_locals)
        owned = trace.active() is None
        if owned:
            trace.enable()
        try:
            with tracker, counter.mode:
                out = fn(*args.values())
        finally:
            if owned:
                trace.disable()
        peak = tracker.get_tracker_snapshot("peak")
        out_locals = _locals(out)
        written = _locals([args[k] for k in inplace])
        alias = sum(_nbytes(t) for t in out_locals
                    if any(torch._C._is_alias_of(t, a) for a in written))
    rec["t_trace_s"] = time.perf_counter() - t0
    arg_bytes = sum(_nbytes(t) for t in arg_locals)
    peak_bytes = max((d.get("Total", 0) for d in peak.values()), default=0)
    rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                     "arguments": by_tree,
                     "output_size_in_bytes": sum(_nbytes(t)
                                                 for t in out_locals),
                     "alias_size_in_bytes": alias,
                     "temp_peak_bytes": peak_bytes - arg_bytes}
    rec.update(counter.record())
    if out_dir is not None:
        _write(rec, out_dir)
    return rec


def summary(rec: Dict) -> str:
    """One line of a traced cell's record: the trace's seconds, FLOPs a
    device, arguments and peak temporaries in GiB and whether they fit an
    80 GiB card, and each collective kind's count and result GB."""
    mem = rec["memory"]
    args, temp = mem["argument_size_in_bytes"], mem["temp_peak_bytes"]
    col = rec["collectives"]
    kinds = ", ".join(f"{k} {n} / {col[k] / 1e9:.4g} GB"
                      for k, n in col["counts"].items() if n)
    flops = rec["flops_per_device"]
    return (f"trace {rec['t_trace_s']:.1f}s, flops={flops:.4g}, "
            f"arguments {args / 2 ** 30:.3f} GiB + temporaries "
            f"{temp / 2 ** 30:.3f} GiB (fit 80 GiB: "
            f"{args + temp <= 80 * 2 ** 30}); {kinds or 'no collectives'}")


def _write(rec: Dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    print(f"[dryrun] wrote {path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", choices=("all",) + ARCHS)
    ap.add_argument("--shape", default="all",
                    choices=("all",) + tuple(SHAPES))
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    # fake CUDA tensors need a PyTorch built with CUDA; without it the
    # trace takes the card's route on fake CPU tensors
    device = "cuda" if torch.backends.cuda.is_built() else "cpu"
    print(f"[dryrun] fake {device} tensors on the card's route", flush=True)
    archs = ARCHS if args.arch == "all" else (args.arch,)
    shapes = tuple(SHAPES) if args.shape == "all" else (args.shape,)
    failures = []
    for a in archs:
        for s in shapes:
            print(f"=== {a} × {s} × {args.mesh} ===", flush=True)
            try:
                rec = run_cell(a, s, args.mesh, out_dir=args.out,
                               device=device)
                if "skipped" in rec:
                    print(f"    skipped: {rec['skipped']}")
                else:
                    print(f"    ok: {summary(rec)}")
            except Exception as e:
                traceback.print_exc()
                failures.append((a, s, str(e)))
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("dry-run complete: all cells traced")


if __name__ == "__main__":
    main()
