"""SMOKE configs at production shapes traced by the multi-pod dry run
over the fake group of 256 ranks on the card's route: the serve cells
(Qwen3-4B's prefill and decode, RWKV6-3B's 500k-context decode), held as
``test_torch_dryrun_traces.py`` holds the train cells."""

import pytest

from repro_torch import configs as PC
from repro_torch.launch import dryrun as D

from test_torch_dryrun_traces import check_cell

TRACES = [("qwen3-4b", "prefill_32k"), ("qwen3-4b", "decode_32k"),
          ("rwkv6-3b", "long_500k")]


@pytest.fixture(scope="module")
def traced():
    """The (16, 16) production mesh over a fake group of 256 ranks and
    the cells' records."""
    with D.fake_group(256):
        mesh = D.make_production_mesh(device="cpu")
        yield mesh, {cell: D.run_cell(PC.get_config(cell[0], smoke=True),
                                      cell[1], "single", out_dir=None,
                                      mesh=mesh, device="cpu")
                     for cell in TRACES}


@pytest.mark.parametrize("cell", TRACES, ids=["/".join(c) for c in TRACES])
def test_smoke_serve_cells_trace_the_cards_route(traced, cell):
    mesh, recs = traced
    check_cell(mesh, cell, recs[cell])
