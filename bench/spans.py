"""What the port records of its own serving work in a traced run
(``repro_torch.core.obs.trace``): its host spans (``serve.*``), each
layer's device spans inside its CUDA graphs (``model.embed``,
``layer.<kind>``, ``model.head``, ``model.pick``) and its counters
(``moe.*``, ``serve.cache_load_bytes``).  The per-layer readers of the
model step's layers read it.

The window's steps were captured in set-up with no tracer installed, so
the window runs the program's plain graphs.  This adds one batch after the
window has closed, its peak memory been read and its steps been freed
(the output check frees them): it installs the port's tracer, builds a
fresh ``PrefillStep`` and ``DecodeStep``, captures both with the warm
batch as set-up does, and serves the traffic's next batch: its prefill and
``TRACE_DECODE_STEPS`` decode steps (every decode step of a shorter mix),
CUDA events around each call as in the window.  After each call
synchronizes, the step's device spans and its event time are kept; the
counters of both steps are read once, at the end, and cover the batch.
Both steps are dropped and the tracer uninstalled before it returns.

The first reader that asks runs it, and the result stays on the run.  A
program that has no device spans returns None, and so does every reader
of it."""

from __future__ import annotations

import gc
import json
import statistics
import sys

#: the attribute of a run that holds :func:`recorded`'s result
ATTR = "program_trace"


def recorded(run):
    """The traced batch's records, made at the first call: ``on_card``;
    ``prefill``, ``{"dev_ms", "spans"}`` (``spans``: ``(name, args,
    start_ms, ms)`` a device span); ``decode``, the same a decode step;
    ``counters``, ``{"prefill", "decode", "host"}``.  None where the
    program has no device spans.

    It runs once the output check has freed the window's steps
    (``harness.run_cell`` reads the metrics after it), so its fresh steps
    never hold memory beside the window's graphs."""
    if not hasattr(run, ATTR):
        assert run.served.prefill is None and run.served.step is None, \
            "the traced batch runs after the window's steps are freed"
        setattr(run, ATTR, _traced_batch(run))
    return getattr(run, ATTR)


def _traced_batch(run):
    from repro_torch.core.obs import trace
    if not hasattr(trace, "device_span"):
        return None
    import torch
    from repro_torch.launch.serve import DecodeStep, PrefillStep

    from bench.harness import TRACE_DECODE_STEPS
    from bench.traffic.generator import WARM_UP, Traffic
    served, mix = run.served, run.mix
    dev, cfg = served.device, served.cfg
    on_card = dev.type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def timed(call):
        """``call()`` and its device milliseconds (CUDA events around it),
        after a synchronize."""
        if not on_card:
            return call(), None
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = call()
        b.record()
        sync()
        return out, a.elapsed_time(b)

    tracer = trace.enable(trace.Tracer())
    try:
        prefill = PrefillStep(served.params, cfg)
        step = DecodeStep(served.params, cfg)
        _, toks = Traffic(mix, served.seed, cfg.vocab_size,
                          WARM_UP).next_batch()
        _, tok, caches = prefill(toks, served.max_seq)
        for _ in range(min(2, mix["new_tokens"] - 1)):
            _, tok, caches = step(caches, tok)
        sync()
        for rec in (prefill.record, step.record):
            if rec is not None:
                rec.reset()
        tracer.counters.clear()
        traffic = Traffic(mix, served.seed, cfg.vocab_size)
        for _ in range(len(run.batches)):
            traffic.next_batch()
        _, toks = traffic.next_batch()
        out = {"on_card": on_card, "decode": []}
        # a graph's record sums its replays; an eager call has its own
        records = {"prefill": [], "decode": []}

        def kept(phase, rec):
            if not any(r is rec for r in records[phase]):
                records[phase].append(rec)
            return rec.spans()

        with trace.context(batch=len(run.batches)):
            (_, tok, caches), ms = timed(lambda: prefill(toks,
                                                        served.max_seq))
            out["prefill"] = {"dev_ms": ms,
                              "spans": kept("prefill", prefill.record)}
            for _ in range(min(TRACE_DECODE_STEPS, mix["new_tokens"] - 1)):
                (_, tok, caches), ms = timed(lambda: step(caches, tok))
                out["decode"].append({"dev_ms": ms,
                                      "spans": kept("decode", step.record)})
        sync()
        out["counters"] = {phase: _summed(r.counters() for r in recs)
                           for phase, recs in records.items()}
        out["counters"]["host"] = dict(tracer.counters)
    finally:
        trace.disable()
        prefill = step = caches = tok = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    print("program counters: " + json.dumps(out["counters"]),
          file=sys.stderr)
    if on_card and out["decode"]:
        share = statistics.median(span_ms(d["spans"], bool) / d["dev_ms"]
                                  for d in out["decode"])
        print(f"program spans: a decode step's device spans cover "
              f"{100 * share:.2f}% of its CUDA-event time (median)",
              file=sys.stderr)
    return out


def _summed(counters) -> dict:
    out = {}
    for c in counters:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def span_ms(spans, match) -> float:
    """Milliseconds of the device spans whose name ``match`` accepts."""
    return sum(ms for name, _, _, ms in spans if match(name))


def layer_ms(run, phase: str, match):
    """The device milliseconds of the spans ``match`` accepts: in the
    traced prefill, or the median over the traced decode steps of each
    step's sum.  None off the card (there the spans are host times) or
    where nothing matched."""
    rec = recorded(run)
    if rec is None or not rec["on_card"]:
        return None
    steps = [rec["prefill"]] if phase == "prefill" else rec["decode"]
    sums = [span_ms(s["spans"], match) for s in steps]
    if not any(sums):
        return None
    return statistics.median(sums)


def slot_fill(run, phase: str):
    """100 × the kept (token, expert) pairs over the slots the expert
    products ran over, in ``phase``'s step; None without a MoE layer."""
    rec = recorded(run)
    if rec is None:
        return None
    c = rec["counters"][phase]
    if not c.get("moe.slots"):
        return None
    return 100.0 * c["moe.pairs_kept"] / c["moe.slots"]
