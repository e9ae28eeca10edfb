"""The output check fails a broken timed path: the rest of a run is driven
on the CPU at the SMOKE sizes with the step broken underneath, and
``correct`` comes out false; a sound run comes out true.  The faults a
served cell can have: a decode step that returns its state unchanged, and
a token altered where it is produced; and two that reach only some of the
sampled positions, which a median pooled over all of them would outvote:
one request's state left unchanged, and every state left unchanged from
the second decode step on.  (Half a batch left out and the exchange
between chips left out are a training step's and a mesh's.)"""

import time

import pytest
import torch

from bench import harness
from bench.tests.tiny import TRAFFIC


def _correct(root, cell):
    r = harness.run_cell(harness.Layout(root), cell, 5, 0.0, False,
                         torch.device("cpu"), time.perf_counter())
    return r["correct"], r["checks"]


CELLS = ["tiny-olmoe.tiny", "tiny-jamba.tiny"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root32, cell):
    assert _correct(tiny_root32, cell)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_state_unchanged_fails(tiny_root32, cell, monkeypatch):
    from repro_torch.launch import serve
    real = serve.serve_decode

    def stale(params, caches, token, cfg, **kw):
        kw["in_place"] = False
        logits, _ = real(params, caches, token, cfg, **kw)
        return logits, caches

    monkeypatch.setattr(serve, "serve_decode", stale)
    ok, gap = _correct(tiny_root32, cell)
    assert not ok, gap


@pytest.mark.parametrize("cell", CELLS)
def test_token_altered_fails(tiny_root32, cell, monkeypatch):
    from repro_torch.launch import serve
    real = serve._greedy

    def off_by_one(logits):
        return (real(logits) + 1) % logits.shape[-1]

    monkeypatch.setattr(serve, "_greedy", off_by_one)
    ok, gap = _correct(tiny_root32, cell)
    assert not ok, gap


def _position(caches) -> int:
    """The position of a decode step's token: its first attention cache's
    write index."""
    for group in caches.values():
        if "idx" in group:
            return int(group["idx"][0])
    raise AssertionError("no attention cache")


@pytest.mark.parametrize("cell", CELLS)
def test_one_row_state_unchanged_fails(tiny_root32, cell, monkeypatch):
    """Every decode step leaves the second request's cache and state as
    they were: 3 of the 10 sampled positions go wrong."""
    from repro_torch.launch import serve
    real = serve.serve_decode

    def one_row_stale(params, caches, token, cfg, **kw):
        kw["in_place"] = False
        logits, new = real(params, caches, token, cfg, **kw)
        for name, group in new.items():
            for key, leaf in group.items():
                if key != "idx":
                    leaf[:, 1] = caches[name][key][:, 1]
        return logits, new

    monkeypatch.setattr(serve, "serve_decode", one_row_stale)
    ok, gap = _correct(tiny_root32, cell)
    assert not ok, gap


@pytest.mark.parametrize("cell", CELLS)
def test_state_unchanged_from_a_later_step_fails(tiny_root32, cell,
                                                 monkeypatch):
    """Decode steps after the first leave every state as it was: only the
    last two positions of each request go wrong, 4 of the 10 sampled."""
    from repro_torch.launch import serve
    real = serve.serve_decode

    def stale_later(params, caches, token, cfg, **kw):
        kw["in_place"] = False
        logits, new = real(params, caches, token, cfg, **kw)
        return logits, (caches if _position(caches) > TRAFFIC["max_prompt"]
                        else new)

    monkeypatch.setattr(serve, "serve_decode", stale_later)
    ok, gap = _correct(tiny_root32, cell)
    assert not ok, gap
