"""Programs and a rank launcher for the mesh (``core/dist``): the
reference's distributed test programs, a suite one rank of a process group
runs, and :func:`spawn`, which starts the ranks over gloo.

The three programs are ``tests/test_dist_fusion.py``'s, sized by
``size``: ``window`` (three shifted windows of a sharded vector: one
allgather a read site, one collective once fused), ``aligned`` (an
elementwise chain over a sharded vector: shard-local, no collective) and
``reduction`` (a sum over the sharded axis: one allgather).  Each takes
the lazy module and the dist module it runs on (``bh``, ``dist``), so the
same body records the same tape in either package.

:func:`mesh_suite` runs on every rank (SPMD): each program under
``cost_model="comm"`` with ``greedy`` and ``singleton`` on a mesh of every
rank and once without a mesh, the benchmark programs it is given the same
way, and :func:`~repro_torch.testing.tapegen.check_dist` on tapegen seeds;
it returns the results, each run's executor stats and its warm wall.

:func:`spawn` starts ``n`` ranks of a job over gloo with a ``FileStore``
in a temporary directory (no network), each with one CPU thread; a rank
that raises fails the call.  On the card every rank uses device 0, so
gloo stages each collective through host memory (``dist.mesh.all_gather``):
a functional check of the multi-rank path, not a fabric measurement.
``pg_backend="hoststaged"`` starts them over ``dist.mesh.HostStagedGroup``,
which stages every collective of the model on the mesh the same way.

The model on the mesh: :func:`model_suite` (the train and serve steps on
a ``("data", "model")`` mesh), :func:`pipeline_suite`
(``distributed.pipeline``), :func:`elastic_suite` (``runtime.elastic``
through a checkpoint) and :func:`launcher_suite` (the launchers' ``main``);
:func:`run_suites` runs several in one spawn.  The tests and
``chip_smoke.py``'s ``MESH`` part (c) spawn them.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np


def window(bh, dist, n: int, size: Optional[int] = None):
    size = size or 64
    x = bh.asarray(np.arange(size, dtype=np.float64))
    dist.shard(x, n=n)
    w = size - 4
    zs = [x[i:w + i] * float(i + 1) for i in range(3)]
    return (zs[0] + zs[1] + zs[2]).numpy()


def aligned(bh, dist, n: int, size: Optional[int] = None):
    x = bh.asarray(np.linspace(0.0, 2.0, size or 8 * n))
    dist.shard(x, n=n)
    y = bh.exp(x) * 0.5 + bh.sqrt(x + 1.0)
    return y.numpy()


def reduction(bh, dist, n: int, size: Optional[int] = None):
    x = bh.asarray(np.arange(float(size or 32 * n)))
    dist.shard(x, n=n)
    return np.asarray((x * x).sum().numpy())


PROGRAMS: Dict[str, Callable] = {"window": window, "aligned": aligned,
                                 "reduction": reduction}

#: the executor stats the suite keeps from each run
STATS = ("shard_map_blocks", "collectives", "interconnect_bytes",
         "blocks_run")


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_once(fn, device, warm: bool, **runtime_kw) -> dict:
    """One program in a fresh runtime: the result and the executor stats of
    one run; with ``warm``, of a second run in the same runtime, with its
    wall."""
    from ..core.executor import stats_delta
    from ..core.lazy import fresh_runtime
    with fresh_runtime(device=device, loop_fusion=False,
                       **runtime_kw) as rt:
        before = rt.executor.snapshot_stats()
        out = fn()
        wall = None
        if warm:
            _sync(device)
            before = rt.executor.snapshot_stats()
            t0 = time.perf_counter()
            out = fn()
            _sync(device)
            wall = time.perf_counter() - t0
        st = stats_delta(before, rt.executor.stats)
    return {"out": np.asarray(out), "wall_s": wall,
            "backend_blocks": dict(st["backend_blocks"]),
            **{k: st.get(k, 0) for k in STATS}}


def mesh_suite(size: Optional[int] = None, device="cpu", backend="torch",
               seeds: Sequence[int] = (), seed_size: int = 64,
               benchmarks: Optional[Dict[str, tuple]] = None,
               keep_outputs: bool = True, warm: bool = False) -> dict:
    """Every rank of the process group runs this (SPMD).  For each program
    of :data:`PROGRAMS` (and each ``benchmarks`` entry, name -> args of
    ``testing.programs.BENCHMARKS``): ``greedy`` and ``singleton`` under
    ``comm`` on a mesh of every rank, and ``greedy`` with no mesh; each
    mesh run must equal the mesh-less one bitwise.  Then ``check_dist`` on
    ``seeds`` (``seed_size`` elements, the torch floor), keeping its mesh
    outputs.  Returns ``{"runs": {name: {mode: run}}, "seeds": {seed:
    outputs}}``; without ``keep_outputs`` the runs keep no arrays."""
    from ..core import dist
    from ..core import lazy as bh
    from ..core.dist import host_mesh
    from .programs import BENCHMARKS
    from .tapegen import check_dist
    mesh = host_mesh(device=device)
    n = dist.world_size()
    todo = {name: (lambda f=f: f(bh, dist, n, size))
            for name, f in PROGRAMS.items()}
    for name, args in (benchmarks or {}).items():
        todo[name] = lambda f=BENCHMARKS[name], a=args: f(*a).numpy()
    runs: Dict[str, dict] = {}
    for name, fn in todo.items():
        modes = {}
        for mode, kw in (("greedy", dict(algorithm="greedy", mesh=mesh)),
                         ("singleton", dict(algorithm="singleton",
                                            mesh=mesh)),
                         ("single", dict(algorithm="greedy"))):
            modes[mode] = run_once(fn, device, warm, backend=backend,
                                   cost_model="comm", **kw)
        want = modes["single"]["out"]
        for mode in ("greedy", "singleton"):
            got = modes[mode]["out"]
            if got.dtype != want.dtype or got.shape != want.shape or \
                    got.tobytes() != want.tobytes():
                raise AssertionError(f"{name} [{mode} on a mesh of {n}] "
                                     "differs from the single-device run")
        if not keep_outputs:
            for run in modes.values():
                run.pop("out")
        runs[name] = modes
    outs = {seed: check_dist(seed, size=seed_size, device=device)
            for seed in seeds}
    return {"runs": runs, "seeds": outs if keep_outputs else {},
            "n_seeds": len(outs)}


def _rank(rank: int, world: int, store: str, out_dir: str, device: str,
          job: Callable, kwargs: dict, pg_backend: str = "gloo") -> None:
    import torch
    import torch.distributed as tdist
    torch.set_num_threads(1)
    if pg_backend != "gloo":
        from ..core.dist.mesh import register_host_staged
        register_host_staged()
    tdist.init_process_group(pg_backend, store=tdist.FileStore(store, world),
                             rank=rank, world_size=world,
                             timeout=datetime.timedelta(seconds=300))
    try:
        res = job(device=device, **kwargs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        tdist.destroy_process_group()


def spawn(job: Callable, n: int, device: str = "cpu",
          pg_backend: str = "gloo", **kwargs) -> list:
    """Run ``job(device=device, **kwargs)`` on ``n`` ranks over gloo (a
    ``FileStore`` in a temporary directory) and return each rank's result,
    in rank order.  A rank that raises fails the call (the others are
    terminated).  ``pg_backend="hoststaged"`` (``core.dist.mesh.
    HostStagedGroup``) stages every collective of CUDA tensors through
    host gloo: the model on a mesh of ranks that share one card."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(n, os.path.join(tmp, "store"), tmp, device,
                              job, kwargs, pg_backend), nprocs=n,
                 join=True)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# The model on the mesh
# ---------------------------------------------------------------------------

def draw_gains(tree, gen, plus_one: bool) -> None:
    """The zero-initialised leaves of ``init_params``' tree drawn in place
    (their zeros would zero every activation of a plain-``g`` config):
    norm gains ``g`` around 1 (unless ``plus_one``), QKV biases and
    qk-norm gains around 0."""
    import torch
    for key, v in tree.items():
        if isinstance(v, dict):
            draw_gains(v, gen, plus_one)
        elif key in ("bq", "bk", "bv", "q_norm", "k_norm") or (
                key == "g" and not plus_one):
            base = 1.0 if key == "g" else 0.0
            v.copy_(base + 0.1 * torch.randn(v.shape, generator=gen,
                                             device=v.device))


def _weights(cfg, weights, device):
    """``weights``: a numpy tree (the JAX package's, as the tests convert
    them) or a seed (``init_params`` on ``device``, gains drawn)."""
    import torch
    from ..models import transformer as T
    if isinstance(weights, int):
        gen = torch.Generator(device=device).manual_seed(weights)
        params = T.init_params(cfg, gen, device)
        draw_gains(params, gen, cfg.norm_plus_one)
        return params
    return T.params_from_numpy(weights, device)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _kernel_modules():
    from ..kernels.decode_attention import kernel as da
    from ..kernels.flash_attention import kernel as b3
    from ..kernels.mamba_scan import kernel as b5
    from ..kernels.rwkv6_scan import kernel as b6, kernel_chunked as b7
    return b3, b5, b6, b7, da


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the kernels the model runs on a mesh: B3, B5,
    B6, B7 and the decode-attention kernel."""
    return {k: n for mod in _kernel_modules() for k, n in mod.LAUNCHES.items()}


def zero_launches() -> None:
    for mod in _kernel_modules():
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def model_suite(cfg, weights, *, device="cpu", shape=(2, 2),
                batches=(), train_kw=None, serve=None,
                keep_params: bool = True,
                place_inputs: bool = False) -> dict:
    """The model on a ``shape`` mesh over ``("data", "model")`` (every
    rank runs this, SPMD): ``make_train_step(cfg, mesh, **train_kw)`` over
    ``batches`` (numpy dicts) from ``weights`` (a numpy tree or a seed),
    then ``make_serve_steps``' prefill of ``serve["tokens"]`` (with
    ``serve`` holding ``frames`` / ``patch_embeds`` where the model takes
    them) and a decode step for each column of ``serve["decode"]`` (the
    tokens fed, as a ``(B, n)`` array).  Returns each step's loss, lr,
    wall ms and kernel launches, the serve logits (whole, numpy), each
    phase's collectives (``CommDebugMode``: kind -> count), peak device
    memory and, with ``keep_params``, the trained parameters whole (key
    path -> numpy).  ``place_inputs``: the prompt's inputs placed over
    the data axes first (as a dry run's are), else whole on every rank.
    A phase's collectives are its steps' own (the logits are gathered
    whole after)."""
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.debug import CommDebugMode
    from ..distributed.sharding import shard_tree
    from ..launch.steps import make_serve_steps, make_train_step
    from ..models import transformer as T
    from ..optim import adamw as A
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    mesh = DeviceMesh(device, torch.arange(tdist.get_world_size()).reshape(
        shape), mesh_dim_names=("data", "model"))
    out: dict = {"losses": [], "lr": [], "step_ms": [], "launches": [],
                 "comm": {}}

    from ..core.dist.mesh import STAGED
    out["staged"] = {}

    def comm(phase, cm, staged):
        out["comm"][phase] = {str(k).split(".")[-1]: int(v) for k, v in
                              cm.get_comm_counts().items()}
        out["staged"][phase] = {k: [v[0] - staged.get(k, (0, 0))[0],
                                    v[1] - staged.get(k, (0, 0))[1]]
                                for k, v in STAGED.items()}

    if batches:
        step, specs = make_train_step(cfg, mesh, **(train_kw or {}))
        params = shard_tree(_weights(cfg, weights, device), specs["params"],
                            mesh)
        _free(device)
        # the moments placed shard by shard, as the specs place them
        opt = A.adamw_init(params, state_dtype=(train_kw or {}).get(
            "opt_state_dtype") or cfg.opt_state_dtype)
        out["opt_placed"] = all(
            list(x.placements) == spec.placements(mesh)
            for tree, specs_tree in ((opt.m, specs["opt"].m),
                                     (opt.v, specs["opt"].v))
            for (_, x), (_, spec) in zip(_moment_leaves(tree),
                                         _moment_leaves(specs_tree)))
        for i, batch in enumerate(batches):
            zero_launches()
            _sync(device)
            staged = {k: tuple(v) for k, v in STAGED.items()}
            t0 = time.perf_counter()
            with CommDebugMode() as cm:
                params, opt, m = step(params, opt, batch)
            _sync(device)
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["launches"].append(kernel_launches())
            out["losses"].append(float(m["loss"]))
            out["lr"].append(float(m["lr"]))
            comm(f"train_step_{i}", cm, staged)
        if keep_params:
            from ..optim.adamw import _paths
            out["params"] = {p: _whole(x) for p, x in _paths(params)}
        del params, opt, step, m
        _free(device)
    if serve is not None:
        toks = serve["tokens"]
        n_dec = serve["decode"].shape[1]
        max_seq = toks.shape[1] + n_dec + (
            cfg.n_patches if cfg.family == "vlm" else 0)
        prefill, decode, specs = make_serve_steps(cfg, mesh, max_seq,
                                                  toks.shape[0])
        # placed first, then cast leaf by leaf: no whole-model cast copy
        sp = T.serving_params(shard_tree(_weights(cfg, weights, device),
                                         specs["params"], mesh), cfg)
        _free(device)
        inputs = {"tokens": torch.as_tensor(toks)}
        for k in ("frames", "patch_embeds"):
            if serve.get(k) is not None:
                inputs[k] = torch.as_tensor(serve[k]).to(device)
        if place_inputs:
            from ..launch.steps import _place, batch_specs_tree
            inputs = {k: _place(v, spec, mesh) for (k, v), spec in zip(
                inputs.items(), batch_specs_tree(inputs, mesh).values())}
        zero_launches()
        staged = {k: tuple(v) for k, v in STAGED.items()}
        with CommDebugMode() as cm:
            logits, cache = prefill(sp, inputs)
        comm("prefill", cm, staged)
        out["prefill"] = _whole(logits)
        enc_out = None
        if "frames" in inputs:
            from ..launch.steps import _mesh_scope
            with _mesh_scope(mesh):
                enc_out = T.encode(sp, inputs["frames"], cfg)
        steps = []
        staged = {k: tuple(v) for k, v in STAGED.items()}
        with CommDebugMode() as cm:
            for j in range(n_dec):
                tok = torch.as_tensor(serve["decode"][:, j:j + 1])
                logits, cache = decode(sp, cache, tok, enc_out)
                steps.append(logits)
        comm("decode", cm, staged)
        out["decode"] = [_whole(x) for x in steps]
        out["serve_launches"] = kernel_launches()
    if device == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _moment_leaves(tree, prefix=()):
    """``(key path, tensor or spec)`` of a moment tree, a quantized or
    factored moment's parts included, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _moment_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _free(device) -> None:
    """Return the freed blocks of the card's cache (several ranks share the
    one card)."""
    import gc
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _whole(x):
    """A tensor or DTensor's whole value as a numpy array (float32 for a
    bfloat16 one)."""
    import torch
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


def pipeline_suite(*, device="cpu", shape=(4, 1), d=16, m=6, rows=8,
                   seed=0, scale=0.3) -> dict:
    """``pipeline_apply`` of ``tanh(x @ w_s)`` stages over the ``pod`` axis
    of a ``shape`` mesh over ``("pod", "data")`` (``shape[0]`` stages of
    ``d x d`` normal weights times ``scale``, ``m`` microbatches of
    ``rows``), every rank: the outputs and their largest difference from
    the stages composed in order on one rank.  (A stage's gain is about
    ``scale * sqrt(d)``: above 1 it magnifies the matmuls' last-ulp
    differences stage by stage.)"""
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from ..distributed.pipeline import pipeline_apply
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = DeviceMesh(device, torch.arange(tdist.get_world_size()).reshape(
        shape), mesh_dim_names=("pod", "data"))
    gen = torch.Generator().manual_seed(seed)
    w = (torch.randn(shape[0], d, d, generator=gen) * scale).to(device)
    x = torch.randn(m, rows, d, generator=gen).to(device)

    def stage(wi, a):
        return torch.tanh(a @ wi)

    _sync(device)
    t0 = time.perf_counter()
    got = pipeline_apply(stage, w, x, mesh=mesh, axis="pod")
    _sync(device)
    wall = time.perf_counter() - t0
    want = x
    for s in range(shape[0]):
        want = stage(w[s], want)
    return {"out": got.cpu().numpy(), "err": float((got - want).abs().max()),
            "wall_s": wall}


def elastic_suite(cfg, weights, shapes, *, device="cpu",
                  directory: str = "", keys=None,
                  keep_leaves: bool = True) -> dict:
    """``cfg``'s parameters (``weights``: a numpy tree or a seed; with
    ``keys``, those top-level entries only) through
    ``runtime.elastic.reshard_params`` and a checkpoint over each mesh of
    ``shapes`` in turn (over ``("data", "model")``): placed on the first,
    saved; restored onto the next as ``reshard_params`` places them there,
    saved again; and so on.  Returns each mesh's placements, whether every
    mesh's leaves are bitwise the parameters, and with ``keep_leaves``
    each mesh's leaves whole (key path -> numpy)."""
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from ..checkpoint.manager import CheckpointManager, _flatten
    from ..models.transformer import param_axes
    from ..runtime.elastic import reshard_params
    world = tdist.get_world_size()
    params, axes = _weights(cfg, weights, device), param_axes(cfg)
    if keys is not None:
        params = {k: params[k] for k in keys}
        axes = {k: axes[k] for k in keys}
    ckpt = CheckpointManager(directory, keep=len(shapes) + 1)
    out = {"leaves": [], "placements": [], "bitwise": True}
    want = dict(_flatten(params))
    current = None
    for i, shape in enumerate(shapes):
        mesh = DeviceMesh(device, torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        like = reshard_params(params, axes, mesh)
        if current is None:
            current = like
        else:
            _, current = ckpt.restore(i, like)
        ckpt.save(i + 1, current, blocking=True)
        flat = dict(_flatten(current))
        out["bitwise"] &= all(torch.equal(flat[p].full_tensor(), w)
                              for p, w in want.items())
        if keep_leaves:
            out["leaves"].append({p: _whole(x) for p, x in flat.items()})
        out["placements"].append({p: str(tuple(x.placements))
                                  for p, x in flat.items()})
    return out


def launcher_suite(*, device="cpu", directory: str = "") -> dict:
    """``launch.serve.main`` and ``launch.train.main`` at SMOKE size (on a
    rank of a group of several, each takes the host mesh): their printed
    lines."""
    import contextlib
    import io
    from ..launch import serve, train
    out = {}
    for name, main, argv in (
            ("serve", serve.main, ["--arch", "qwen3-4b", "--requests", "3",
                                   "--batch", "2", "--max-prompt", "12",
                                   "--new-tokens", "3", "--device", device]),
            ("train", train.main, ["--arch", "qwen3-4b", "--smoke",
                                   "--steps", "3", "--batch", "4", "--seq",
                                   "16", "--device", device, "--ckpt-dir",
                                   directory, "--save-every", "2",
                                   "--log-every", "1"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        out[name] = buf.getvalue().splitlines()
    return out


def run_suites(*, device="cpu", jobs=()) -> list:
    """Each ``(suite name, keyword arguments)`` of ``jobs`` in turn, one of
    this module's suites: how a test spawns its ranks once for several
    suites without importing its own module (and JAX) in every rank."""
    return [globals()[name](device=device, **kw) for name, kw in jobs]
