"""The serving steps' spans and counters (``core.obs.trace``), on the CPU
at the SMOKE sizes of OLMoE-1B-7B and Jamba-v0.1.

* With the tracer off a step records nothing and makes no counter tensor.
* Logits and tokens are bitwise equal with the tracer on and off.
* Each step is a ``serve.*`` host span holding one device span a layer and
  sublayer (``layer.<mixer>`` and ``layer.<ffn>``, ``layer=<index>``), plus
  ``model.embed``, ``model.head`` and ``model.pick``; off the card device
  spans are host spans, so the step's record and the tracer's events see
  the same names.
* The MoE counters equal the counts made by hand from ``moe_route`` on
  the hidden states each MoE layer was given.
* Under ``torch.profiler`` the program's spans are annotations that
  enclose the step's ops.
* The disabled span costs under 100 ns a call.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.obs import trace
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = ["olmoe-1b-7b", "jamba-v0.1-52b"]
BATCH, PROMPT, NEW = 2, 16, 3


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_config(request.param, smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = T.serving_params(T.init_params(cfg, gen, "cpu"), cfg)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    return cfg, params, toks


@pytest.fixture
def tracer():
    t = trace.enable()
    try:
        yield t
    finally:
        trace.disable()


def _serve(cfg, params, toks):
    """A prefill and ``NEW - 1`` decode steps through fresh steps: each
    call's logits and token, and the steps' records after each call."""
    prefill = serve.PrefillStep(params, cfg)
    step = serve.DecodeStep(params, cfg)
    logits, tok, caches = prefill(toks, PROMPT + NEW)
    out, records = [(logits, tok)], [prefill.record]
    for _ in range(NEW - 1):
        logits, tok, caches = step(caches, tok)
        out.append((logits, tok))
        records.append(step.record)
    return out, records


def _sublayers(cfg):
    """``(name, layer)`` of each device span a step's layers open."""
    return sorted((f"layer.{kind}", i)
                  for i, pair in enumerate(cfg.layer_pattern())
                  for kind in pair)


def test_tracer_off_records_nothing(model, monkeypatch):
    cfg, params, toks = model

    def no_record(*a, **k):
        raise AssertionError("a record was made with the tracer off")

    monkeypatch.setattr(trace, "DeviceRecord", no_record)
    assert trace.active() is None
    assert trace.counter_rows(("moe.pairs_kept",), 1) is None
    _, records = _serve(cfg, params, toks)
    assert records == [None] * NEW


def test_logits_and_tokens_bitwise_with_the_tracer_on(model, tracer):
    cfg, params, toks = model
    on, _ = _serve(cfg, params, toks)
    trace.disable()
    off, _ = _serve(cfg, params, toks)
    for (lo, to), (lf, tf) in zip(on, off):
        assert torch.equal(lo, lf) and torch.equal(to, tf)


def test_layer_spans_nest_in_their_step(model, tracer):
    cfg, params, toks = model
    with trace.context(batch=7):
        _, records = _serve(cfg, params, toks)
    steps = [e for e in tracer.events if e["name"] in ("serve.prefill",
                                                      "serve.decode")]
    assert [e["name"] for e in steps] == ["serve.prefill"] + [
        "serve.decode"] * (NEW - 1)
    want = _sublayers(cfg)
    for step, rec in zip(steps, records):
        assert step["args"] == {"batch": 7}
        lo, hi = step["ts"], step["ts"] + step["dur"]
        inside = [e for e in tracer.events if lo <= e["ts"]
                  and e["ts"] + e["dur"] <= hi and e is not step]
        got = sorted((e["name"], e["args"]["layer"]) for e in inside
                     if e["name"].startswith("layer."))
        assert got == want
        assert sorted(e["name"] for e in inside
                      if e["name"].startswith("model.")) == [
            "model.embed", "model.head", "model.pick"]
        # the record holds the same device spans, timed alike
        spans = rec.spans()
        assert sorted((n, a["layer"]) for n, a, _, _ in spans
                      if n.startswith("layer.")) == want
        assert all(ms >= 0 and start >= 0 for _, _, start, ms in spans)
        assert rec.runs == 1


def _hand_counts(cfg, hidden):
    """The MoE counters of the hidden states ``moe`` was given, from
    ``moe_route``."""
    m = cfg.moe
    want = dict.fromkeys(("moe.pairs_chosen", "moe.pairs_kept", "moe.slots",
                          "moe.experts_used", "moe.calls"), 0)
    for h, p in hidden:
        b, s, d = h.shape
        s_g = min(s, L.MOE_GROUP_TOKENS)
        r = L.moe_route(p, h.reshape(b * (s // s_g), s_g, d), cfg)
        kept = r["keep"].sum((0, 1))
        g = b * (s // s_g)
        want["moe.pairs_chosen"] += int(r["chosen"].sum())
        want["moe.pairs_kept"] += int(kept.sum())
        want["moe.slots"] += g * m.n_experts * r["cap"]
        want["moe.experts_used"] += int((kept > 0).sum())
        want["moe.calls"] += 1
    return want


def test_moe_counters_match_the_routing(model, tracer, monkeypatch):
    cfg, params, toks = model
    hidden = []
    real = T.moe

    def seen(p, h, cfg, **kw):
        hidden.append((h.clone(), p))
        return real(p, h, cfg, **kw)

    monkeypatch.setattr(T, "moe", seen)
    prefill = serve.PrefillStep(params, cfg)
    step = serve.DecodeStep(params, cfg)
    _, tok, caches = prefill(toks, PROMPT + NEW)
    assert prefill.record.counters() == _hand_counts(cfg, hidden)
    hidden.clear()
    step(caches, tok)
    got = step.record.counters()
    assert got == _hand_counts(cfg, hidden)
    # a decode token routes alone: one slot an expert, every pair kept
    assert got["moe.pairs_kept"] == got["moe.pairs_chosen"] == \
        got["moe.calls"] * BATCH * cfg.moe.top_k
    assert got["moe.slots"] == got["moe.calls"] * BATCH * cfg.moe.n_experts


def test_spans_are_profiler_annotations_around_the_ops(model, tracer):
    cfg, params, toks = model
    prefill = serve.PrefillStep(params, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prefill(toks, PROMPT + NEW)
    events = list(prof.events())
    spans = {}
    for e in events:
        if e.name.startswith(("serve.", "layer.", "model.")):
            spans.setdefault(e.name, []).append((e.time_range.start,
                                                 e.time_range.end))
    assert set(spans) == {"serve.prefill", "model.embed", "model.head",
                          "model.pick"} | {n for n, _ in _sublayers(cfg)}
    (lo, hi), = spans["serve.prefill"]
    for name, found in spans.items():
        assert all(lo <= a <= b <= hi for a, b in found), name
    # every matrix product runs inside a layer's or the head's annotation
    inner = [iv for n, found in spans.items()
             if n.startswith("layer.") or n == "model.head" for iv in found]
    products = [e for e in events if e.name in ("aten::bmm", "aten::mm")]
    assert products
    assert all(any(a <= e.time_range.start and e.time_range.end <= b
                   for a, b in inner) for e in products)


def test_record_counts_a_run_each(tracer):
    """What the recorded code counts in host numbers is a constant of each
    run (a graph's replays run no Python); staged rows are added into the
    accumulator once a run and summed a row; ``reset`` starts again;
    outside a record a host number is the tracer's and no rows are
    staged."""
    rec = trace.new_record("cpu")
    for run in range(2):
        with trace.recording(rec):
            trace.count("n", 2)
            rows = trace.counter_rows(("v", "w"), 2)
            rows.copy_(torch.tensor([[1.0, 2.0], [0.0, 1.0]]))
            more = trace.counter_rows(("v",), 3)
            more.fill_(run)
            assert more.data_ptr() != rows.data_ptr()
        rec.runs += 1
    assert rec.counters() == {"n": 4, "v": 9.0, "w": 2.0}
    with pytest.raises(ValueError), trace.recording(rec):
        trace.counter_rows(("w",), 2)    # a run asking for other rows
    rec.reset()
    assert rec.counters() == {"n": 0, "v": 0.0, "w": 0.0}
    assert trace.counter_rows(("v",), 1) is None
    trace.count("bytes", 5)
    assert tracer.counters == {"bytes": 5}


def test_a_run_keeps_its_own_spans_and_a_raising_run_counts_nothing(tracer):
    rec = trace.new_record("cpu")
    with trace.recording(rec):
        trace.count("n", 1)
        trace.counter_rows(("v",), 1).fill_(2.0)
        with trace.device_span("first"):
            pass
    rec.runs += 1
    with pytest.raises(RuntimeError), trace.recording(rec):
        trace.count("n", 5)
        trace.counter_rows(("v",), 1).fill_(7.0)
        raise RuntimeError("the run fails")
    assert rec.counters() == {"n": 1, "v": 2.0}
    with trace.recording(rec):
        with trace.device_span("second"):
            pass
    assert [name for name, _, _, _ in rec.spans()] == ["second"]


def test_disabled_span_costs_under_100ns():
    # the least of a few readings: noise on a shared host only adds time;
    # a host too busy for 100 ns is held to three empty loop turns instead
    span_ns = min(trace.disabled_span_overhead_ns() for _ in range(5))
    r = range(10_000)
    base_ns = float("inf")
    for _ in range(50):
        t0 = time.perf_counter()
        for _ in r:
            pass
        base_ns = min(base_ns, (time.perf_counter() - t0) / len(r) * 1e9)
    assert span_ns < 100.0 or span_ns < 3 * base_ns, (span_ns, base_ns)
