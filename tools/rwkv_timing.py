"""Time the RWKV6-3B serving path on one GPU, for one tree of the port.

    python3 tools/rwkv_timing.py [--src DIR] [--label NAME] [--profile]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
tree's by default), so one call can time two trees in turns, each in its
own process: ``--src old/src --label parent``, then this tree.  The
script uses only what every tree of the port since the RWKV6 path has:
``launch.serve.serve_requests``, ``models.transformer`` and the RWKV6
ops; the decode step is whatever that tree's ``serve_requests`` does (an
eager loop before the CUDA graph, replays after).

It builds RWKV6-3B (``configs/rwkv6_3b.py``, 32 layers, published widths)
with random weights as ``chip_smoke.py``'s RWKV phase does (seed 0, norm
gains around 1, RWKV-LM's decay initialisation), serves 4 requests (left-
padded to 512 tokens, 16 tokens each) once to warm up, then 8 in two
batches of 4 through one ``serve_requests`` call, and reports from the
second batch, as a server runs once warm: the prefill's wall and the
decode step's (steps 2-15, host clock to a synchronize; a first batch's
prefill right after a CUDA graph's capture also pays for the memory the
graph's pool holds).  It times the layer-0 B7 call of the first prefill
and the layer-0 B6 call of a decode step, on their recorded inputs (32 launches, one per layer, in a
CUDA graph: ``chip_smoke.graph_ms``), beside their bounds
(``chip_smoke._rwkv_work``),
and B6 and B7 on the model phase's 8 x 2048 inputs.  With ``--profile``
one ``torch.profiler`` trace over 3 prefills and over 5 decode steps
splits each wall into the device's busy time (the union of the kernels'
intervals) and its idle share, the time the device waits on the host —
the eager prefill, and where the tree has ``PrefillStep`` its replays
too (``profile_prefill_graph``, the step captured before the trace); it
also times one decode step's device work alone (a CUDA graph of the step
replayed between CUDA events), where the tree has the decode graph.
Prints one JSON line tagged ``RWKV_TIMING``; ``prefill_ms`` is whatever
that tree's ``serve_requests`` prefills through (a replay where it has
``PrefillStep``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _model(cfg):
    import chip_smoke as cs
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen, "cuda")
    layers = params["groups"]["l0"]
    for norm in (layers["norm1"], layers["norm2"], params["final_norm"]):
        norm["g"] = 1.0 + 0.1 * torch.randn(norm["g"].shape, generator=gen,
                                            device="cuda")
    layers["mixer"]["w0"] = cs.rwkv_time_decay(cfg.n_layers, cfg.d_model)
    return params


def _scan_cases(gen):
    """B6's and B7's 8 x 2048 inputs of ``chip_smoke.py``'s model phase."""
    bh, t, n = 8 * 40, 2048, 64

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    return (randn(bh, t, n), randn(bh, t, n, scale=0.3), randn(bh, t, n),
            torch.sigmoid(randn(bh, t, n)) * 0.5 + 0.45, randn(n, scale=0.1))


def _kernels(prof):
    """The trace's kernel events (device-side, not the host ops that
    launched them)."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def _busy_ms(kernels) -> float:
    """The device's busy time: the union of the kernels' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _top(kernels, k=8):
    by = {}
    for e in kernels:
        t, n = by.get(e.name, (0.0, 0))
        by[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    rows = sorted(by.items(), key=lambda kv: -kv[1][0])[:k]
    return [(name[:70], round(t / 1e3, 4), n) for name, (t, n) in rows]


def _profile(run, reps: int) -> dict:
    """Wall (host clock to a synchronize) and the kernels' device time of
    ``reps`` calls of ``run`` under one profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = _kernels(prof)
    dev = _busy_ms(kernels) / reps
    return {"wall_ms": wall, "device_busy_ms": dev,
            "idle_share": 1.0 - dev / wall, "kernels": len(kernels) / reps,
            "top_kernels_ms_over_all_reps": _top(kernels)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rwkv_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, args.src)
    import chip_smoke as cs
    from repro_torch.configs import rwkv6_3b
    from repro_torch.kernels.rwkv6_scan import kernel as rw_k
    from repro_torch.kernels.rwkv6_scan import kernel_chunked as rc_k
    from repro_torch.kernels.rwkv6_scan import ops as rw_ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = rwkv6_3b.CONFIG
    params = _model(cfg)
    prompts = serve.draw_prompts(0, 2 * cs.RWKV_BATCH, cs.RWKV_PROMPT,
                                 cfg.vocab_size)
    kw = dict(batch=cs.RWKV_BATCH, max_prompt=cs.RWKV_PROMPT,
              new_tokens=cs.RWKV_NEW_TOKENS)
    serve.serve_requests(cfg, params, prompts[:cs.RWKV_BATCH], **kw)  # cold
    with cs.OpRecorder(rw_ops, "rwkv6_chunked", {0}) as rec7, \
            cs.OpRecorder(rw_ops, "rwkv6", {0}) as rec6:
        _, times = serve.serve_requests(cfg, params, prompts, **kw)
    warm = times[1]                # the second batch of the call
    out = {"label": args.label, "src": args.src,
           "graph": hasattr(serve, "DecodeStep"),
           "prefill_ms": warm["prefill_s"] * 1e3,
           "first_batch_prefill_ms": times[0]["prefill_s"] * 1e3,
           "decode_ms_per_step": statistics.mean(warm["decode_s"][1:]) * 1e3,
           "decode_ms_steps": [round(s * 1e3, 3) for s in warm["decode_s"]]}
    for name, rec, fn in (("b7_prefill_layer", rec7, rc_k.rwkv6_chunked),
                          ("b6_decode_layer", rec6, rw_k.rwkv6_scan)):
        a, k, _ = rec.calls[0]
        nbytes, ops = cs._rwkv_work(a, k, chunked=name.startswith("b7"))
        bound_ms, bound_by = cs._bound(nbytes, ops)
        ms = cs.graph_ms(lambda: fn(*a, **k), calls=cfg.n_layers)
        out[name] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "kernel_over_bound": ms / bound_ms}
    ins = _scan_cases(torch.Generator(device="cuda").manual_seed(0))
    out["b6_8x2048_ms"] = cs.graph_ms(lambda: rw_ops.rwkv6(*ins, 64))
    out["b7_8x2048_ms"] = cs.graph_ms(lambda: rw_ops.rwkv6_chunked(*ins, 32))
    del ins
    if args.profile:
        sp = T.serving_params(params, cfg) if hasattr(
            T, "serving_params") else params
        toks = np.zeros((cs.RWKV_BATCH, cs.RWKV_PROMPT), np.int32)
        for i, p in enumerate(prompts[:cs.RWKV_BATCH]):
            toks[i, cs.RWKV_PROMPT - len(p):] = p
        max_seq = cs.RWKV_PROMPT + cs.RWKV_NEW_TOKENS
        out["profile_prefill"] = _profile(
            lambda: T.serve_prefill(sp, toks, cfg, max_seq), 3)
        if hasattr(serve, "PrefillStep"):
            pstep = serve.PrefillStep(sp, cfg)
            out["profile_prefill_graph"] = _profile(
                lambda: pstep(toks, max_seq), 3)
            graph = next(iter(pstep._static.values()))[0]
            out["prefill_graph_replay_ms"] = cs.cuda_ms(graph.replay,
                                                        reps=5, burst=2)
            del pstep, graph
        logits, cache = T.serve_prefill(sp, toks, cfg, max_seq)
        state = {"cache": cache, "tok": serve._greedy(logits)}
        if out["graph"]:
            step = serve.DecodeStep(sp, cfg)

            def decode():
                _, state["tok"], state["cache"] = step(state["cache"],
                                                       state["tok"])
        else:
            def decode():
                lg, state["cache"] = T.serve_decode(sp, state["cache"],
                                                    state["tok"], cfg)
                state["tok"] = serve._greedy(lg)
        out["profile_decode"] = _profile(decode, 5)
        if out["graph"]:
            graph = next(iter(step._static.values()))[0]
            out["decode_graph_replay_ms"] = cs.cuda_ms(graph.replay)
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    print("RWKV_TIMING " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
