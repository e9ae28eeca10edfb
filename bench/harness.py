"""One run of one cell: set-up, the measured window, the output check and
the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; everything else is found by name, so a cell, a configuration
or a metric is added by adding files, never by editing this one:

- ``<config entry's file>``: the published keys, and under ``port`` the
  port's ``ModelConfig`` fields as run;
- ``bench/reference/<config>.py``: its plain float32 reference
  (``logits_at``); ``bench/work/<config>.py``: its work counts (``work``);
- ``bench/traffic/<traffic>.json``: the mix (``traffic/generator.py``);
- ``bench/cells/<workload>.json``: its output check's ``block`` and
  ``limits`` (``check.py``);
- ``bench/metrics/<metric>.py``: one reader a metric, ``read(run)``
  returning its value from :class:`Run`, or None where the run holds
  nothing to read (the metric is then left out of the line).

Set-up draws the weights from the seed on the card (``weights.py``),
builds one ``PrefillStep`` and one ``DecodeStep`` (``launch/serve.py``)
and captures both shapes with one warm batch (a prefill and two decode
steps).  The window then drives those two steps batch after batch, as
``serve_requests`` does: left-padded prompts, a prefill, greedy decode
steps, a synchronize after every step; a closed loop, so a batch starts
when the last one ends; whole batches until ``--seconds`` have passed,
ending with the batch in flight.  A capture inside the window fails the
run's check.  With ``--trace 1`` CUDA events time every step on the device
and ``torch.profiler`` traces the window's second batch (its prefill and
at most :data:`TRACE_DECODE_STEPS` decode steps); once the window has
closed and the program's steps are freed, the reference works out the
routing of the first batch's rows, and each decode step's distinct routed
experts (``routed_experts``) go into the decode bytes of ``mbu.decode``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from bench import check, trace as trace_mod, weights
from bench.traffic.generator import WARM_UP, Traffic

#: top-level module names a run may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: decode steps of the traced batch under the profiler
TRACE_DECODE_STEPS = 48


class Layout:
    """Where a checkout keeps the benchmark's files, found by name."""

    def __init__(self, root: Path, bench: Optional[Path] = None):
        self.root = Path(root)
        self.bench = Path(bench) if bench is not None else self.root / "bench"

    def benchmark(self) -> dict:
        return json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, workload: str) -> dict:
        for c in self.benchmark()["workloads"]:
            if c["name"] == workload:
                return c
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.benchmark()["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def check(self, workload: str) -> dict:
        """The cell's output check: ``block`` and ``limits``."""
        path = self.bench / "cells" / f"{workload}.json"
        return json.loads(path.read_text())

    def module(self, kind: str, name: str):
        path = self.bench / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name}".replace("-", "_").replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, workload: str, traced: bool) -> List[dict]:
        """The cell's end-to-end metrics, or with ``traced`` its per-layer
        ones: those without a ``workloads`` list and those whose list
        names the cell."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.benchmark()[key]
                if workload in m.get("workloads", [workload])]


def port_config(fields: dict):
    """The port's ``ModelConfig`` from a configuration file's ``port``
    fields (nested groups as dicts)."""
    from repro_torch.models.config import (MambaConfig, ModelConfig,
                                           MoEConfig, RWKVConfig)
    groups = {"moe": MoEConfig, "mamba": MambaConfig, "rwkv": RWKVConfig}
    return ModelConfig(**{k: groups[k](**v) if k in groups and v is not None
                          else v for k, v in fields.items()})


@dataclass
class Served:
    """A cell set up: its files, the port's config, the weights and the
    two steps, captured."""
    workload: str
    cell: dict
    config: dict
    mix: dict
    cfg: object
    params: dict
    prefill: object
    step: object
    device: object
    seed: int

    @property
    def max_seq(self) -> int:
        return self.mix["max_prompt"] + self.mix["new_tokens"]


@dataclass
class Run:
    """What a window saw; the metric readers read it.  ``batches``: per
    batch its host seconds (``prefill_s``, ``decode_s`` a step) and, in a
    traced run, its device seconds from CUDA events (``prefill_dev``,
    ``decode_dev`` a step, ``gaps_dev``: from one decode step's end to the
    next one's start) and, for the batch under the profiler,
    ``profiled``.  ``sample``: the output check's requests of the
    first batch, each with the logits the steps produced for it.
    ``routed``: in a traced run, the distinct experts each decode step of
    the first batch routed its tokens to, ``(steps, MoE layers)``."""
    served: Served
    work: object
    setup_s: float
    window_s: float = 0.0
    batches: List[dict] = field(default_factory=list)
    requests: List[dict] = field(default_factory=list)
    trace: Optional[trace_mod.Trace] = None
    captures_in_window: int = 0
    sample: List[dict] = field(default_factory=list)
    routed: Optional[np.ndarray] = None

    @property
    def mix(self) -> dict:
        return self.served.mix


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(layout: Layout, workload: str, seed: int, device,
          phases: Optional[dict] = None) -> Served:
    """Weights from ``seed``, the two steps, and one warm batch (a prefill
    and two decode steps) that captures both shapes.  ``phases``, where
    given, gets the host seconds of each part (``port``: the port's
    modules and the CUDA context; ``shapes``, ``allocate`` and ``draw``:
    the weights'; ``prefill`` and ``decode``: the warm batch's calls,
    which load the CUDA library and capture)."""
    phases = {} if phases is None else phases
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        _sync(device)
        now = time.perf_counter()
        phases[name] = now - t
        t = now

    from repro_torch.launch.serve import DecodeStep, PrefillStep
    cell = layout.cell(workload)
    config = layout.config(cell["config"])
    mix = layout.traffic(cell["traffic"])
    cfg = port_config(config["port"])
    lap("port")
    params = weights.draw(cfg, seed, device, lap)
    served = Served(workload, cell, config, mix, cfg, params,
                    PrefillStep(params, cfg), DecodeStep(params, cfg),
                    device, seed)
    _, toks = Traffic(mix, seed, cfg.vocab_size, WARM_UP).next_batch()
    _, tok, caches = served.prefill(toks, served.max_seq)
    lap("prefill")
    for _ in range(min(2, mix["new_tokens"] - 1)):
        _, tok, caches = served.step(caches, tok)
    lap("decode")
    return served


class _Events:
    """CUDA events around each step of a traced run (none otherwise)."""

    def __init__(self, on: bool):
        self.on, self.marks = on, []

    def mark(self):
        if self.on:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)

    def seconds(self):
        """``(durations, gaps)`` of the marked steps (mark pairs) and
        between them."""
        m = self.marks
        dur = [m[i].elapsed_time(m[i + 1]) * 1e-3 for i in range(0, len(m), 2)]
        gaps = [m[2 * i + 1].elapsed_time(m[2 * i + 2]) * 1e-3
                for i in range(len(m) // 2 - 1)]
        return dur, gaps


def window(served: Served, seconds: float, traced: bool, work,
           setup_s: float) -> Run:
    """The measured window: whole batches until ``seconds`` have passed
    (two at least in a traced run, whose second batch is profiled)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    mix, dev = served.mix, served.device
    traffic = Traffic(mix, served.seed, served.cfg.vocab_size)
    run = Run(served, work, setup_s)
    captures = served.prefill.captures + served.step.captures
    on_card = dev.type == "cuda"

    def span(name):
        return record_function(name) if traced else contextlib.nullcontext()

    prof = profiled = None
    keep = rows = None
    w0 = time.perf_counter()
    while True:
        prompts, toks = traffic.next_batch()
        if not run.batches:
            rows = check.sample_rows(prompts, mix["check_requests"],
                                     served.seed)
            keep = torch.empty((len(rows), mix["new_tokens"],
                                served.cfg.vocab_size), device=dev)
            at = torch.as_tensor(rows, device=dev)
        if traced and len(run.batches) == 1:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if on_card else [])
            prof = profile(activities=acts)
            prof.start()
        pre_ev, dec_ev = _Events(traced and on_card), _Events(
            traced and on_card)
        _sync(dev)
        b0 = time.perf_counter()
        with span("bench.prefill"):
            pre_ev.mark()
            logits, tok, caches = served.prefill(toks, served.max_seq)
            pre_ev.mark()
            _sync(dev)
        prefill_s = time.perf_counter() - b0
        if keep is not None:
            keep[:, 0] = logits[at, -1]
        outs, decode_s = [tok], []
        for j in range(mix["new_tokens"] - 1):
            if prof is not None and j == TRACE_DECODE_STEPS:
                prof.stop()
                profiled, prof = prof, None
            s0 = time.perf_counter()
            with span("bench.decode"):
                dec_ev.mark()
                logits, tok, caches = served.step(caches, tok)
                dec_ev.mark()
                _sync(dev)
            decode_s.append(time.perf_counter() - s0)
            outs.append(tok)
            if keep is not None:
                keep[:, j + 1] = logits[at, -1]
        if prof is not None:
            prof.stop()
            profiled, prof = prof, None
        gen = torch.cat(outs, dim=1).cpu().numpy()
        batch = {"prefill_s": prefill_s, "decode_s": decode_s}
        if traced and len(run.batches) == 1:
            batch["profiled"] = True
        if pre_ev.on:
            batch["prefill_dev"] = pre_ev.seconds()[0][0]
            batch["decode_dev"], batch["gaps_dev"] = dec_ev.seconds()
        run.batches.append(batch)
        run.requests.extend({"prompt": p, "row": toks[i], "tokens": gen[i]}
                            for i, p in enumerate(prompts))
        if keep is not None:
            run.sample = [dict(run.requests[i], logits=keep[n])
                          for n, i in enumerate(rows)]
            keep = None
        if time.perf_counter() - w0 >= seconds and (
                not traced or len(run.batches) >= 2):
            break
    run.window_s = time.perf_counter() - w0
    run.captures_in_window = (served.prefill.captures + served.step.captures
                              - captures)
    if profiled is not None:
        run.trace = trace_mod.from_profile(profiled)
    return run


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (module names;
    ``sys.modules`` unless given), compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def sampled_readings(layout: Layout, run: Run, control=None) -> dict:
    """``check.readings`` over the sampled requests, concatenated, once
    the program's steps and caches are freed; the weights, which the
    benchmark drew, are shared.  With ``control`` (a precision of
    ``reference/common.py``) the reference in that precision takes the
    program's place."""
    import torch
    from bench.reference.common import set_float32_products
    served = run.served
    served.prefill = served.step = None
    gc.collect()
    if served.device.type == "cuda":
        torch.cuda.empty_cache()
    set_float32_products()
    ref = layout.module("reference", served.cell["config"])
    lw = weights.layers(served.params, served.cfg)
    with torch.no_grad():
        want = check.reference_logits(ref, served.config, lw, run.sample)
        if control is None:
            got = torch.stack([r["logits"] for r in run.sample])
            tokens = torch.as_tensor(np.stack([r["tokens"]
                                               for r in run.sample]))
        else:
            got = check.reference_logits(ref, served.config, lw, run.sample,
                                         prec=control)
            tokens = got.argmax(-1)
        return check.readings(want, got, tokens)


def output_check(layout: Layout, run: Run, control=None) -> dict:
    """The numbers compared, ``{name: (value, limit)}``: the sampled
    requests' worst block of the logit RMS error and largest excess gap
    (``check``), and the captures the window made.  With ``control``
    the reference in that precision takes the program's place
    (:func:`sampled_readings`), through the same comparison."""
    return compare(layout, run, sampled_readings(layout, run,
                                                 control=control))


def compare(layout: Layout, run: Run, r: dict) -> dict:
    """:func:`output_check`'s numbers from the readings ``r``."""
    spec = layout.check(run.served.workload)
    limits = spec["limits"]
    return {"logit_rms_worst_block": (
                check.worst_block(r["rms"], spec["block"]),
                limits["logit_rms_worst_block"]),
            "excess_gap": (float(r["excess"].max()), limits["excess_gap"]),
            "captures_in_window": (run.captures_in_window, 0)}


def correct(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


#: rows of a batch the reference routes at once
ROUTING_ROWS = 8


def routed_experts(layout: Layout, run: Run) -> np.ndarray:
    """The distinct experts that each decode step of the window's first
    batch routed its tokens to, ``(steps, MoE layers)``: the reference
    routes the batch's rows (their padded prompts and served tokens), a
    few rows at a time, once the program's steps are freed
    (:func:`sampled_readings` frees them)."""
    import torch
    served = run.served
    s, n, b = (run.mix["max_prompt"], run.mix["new_tokens"],
               run.mix["batch"])
    if not any(f == "moe" for _, f in run.work.kinds) or n < 2:
        return np.zeros((max(n - 1, 0), 0), dtype=np.int64)
    ref = layout.module("reference", served.cell["config"])
    lw = weights.layers(served.params, served.cfg)
    rows = run.requests[:b]
    per_layer: List[List] = []
    with torch.no_grad():
        for i in range(0, b, ROUTING_ROWS):
            routes: List = []
            check.reference_logits(ref, served.config, lw,
                                   rows[i:i + ROUTING_ROWS], at=[],
                                   routes=routes)
            if not per_layer:
                per_layer = [[] for _ in routes]
            for got, idx in zip(per_layer, routes):
                got.append(idx[:, s:s + n - 1])
    return run.work.routed_experts([torch.cat(g) for g in per_layer])


def read_metrics(layout: Layout, run: Run, traced: bool) -> dict:
    out = {}
    for m in layout.metrics(run.served.workload, traced):
        value = layout.module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(layout: Layout, workload: str, seed: int, seconds: float,
             traced: bool, device, t0: float,
             phases: Optional[dict] = None) -> dict:
    """One run: set-up, window, metrics and the output check; the result
    line's object (``checks`` last).  ``t0``: the process's start on the
    host clock (``setup_s`` runs from it to the window's start);
    ``phases``: the host seconds of what ran before, by part (``start``:
    the interpreter and the imports of the harness and torch;
    ``device_query``); the result's ``setup_phases_s`` adds the set-up's
    parts (:func:`setup`) and ``other``, the rest of ``setup_s``."""
    import torch
    phases = dict(phases or {})
    served = setup(layout, workload, seed, device, phases)
    work = layout.module("work", served.cell["config"]).work(served.config)
    setup_s = time.perf_counter() - t0
    phases["other"] = setup_s - sum(phases.values())
    run = window(served, seconds, traced, work, setup_s)
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": served.cell["chips"],
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
           if on_card else 0}
    if traced and run.trace is not None and on_card:
        dev["busy_s"] = trace_mod.busy_seconds(run.trace)
        lo, hi = run.trace.window
        dev["window_s"] = hi - lo
    checks = output_check(layout, run)
    if traced:
        run.routed = routed_experts(layout, run)
    metrics = read_metrics(layout, run, traced)
    result = {"correct": correct(checks),
              "attempted": len(run.requests), "failed": 0,
              "metrics": metrics, "device": dev,
              "setup_phases_s": phases}
    if run.routed is not None and run.routed.size:
        r = run.routed
        result["routed_experts"] = {"mean": float(r.mean()),
                                    "min": int(r.min()), "max": int(r.max()),
                                    "of": run.work.n_experts}
    if traced and run.trace is not None and on_card:
        result["breakdown"] = trace_mod.breakdown(run.trace)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv, *, t0: float, root: Path) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    t = time.perf_counter()
    phases = {"start": t - t0}
    layout = Layout(root)
    chips = layout.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    phases["device_query"] = time.perf_counter() - t
    result = run_cell(layout, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda"), t0, phases)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("setup phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["setup_phases_s"].items()),
        file=sys.stderr)
    if result.get("routed_experts") is not None:
        print(f"routed experts a decode step: {result['routed_experts']}",
              file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0

