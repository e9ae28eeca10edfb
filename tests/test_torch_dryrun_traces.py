"""SMOKE configs at production shapes traced by the multi-pod dry run
(``launch/dryrun.py``) over the fake group of 256 ranks on the card's
route: fake CPU tensors, as this PyTorch has no CUDA (its bindings'
device guards refuse fake CUDA tensors there), with every kernel call
site on its operator (``core.device.card_route``).  Each cell completes
with every key of the record; B3 runs once a layer and pass, RWKV6's
decode step once a layer through B6; no ``(B, H, S, S)`` score tensor
is among the largest buffers outside B3's plain backward; a train step
writes its parameters and moments in place.  This file: the train
cells; ``test_torch_dryrun_serve_traces.py`` the serve cells."""

import pytest

from repro_torch import configs as PC
from repro_torch.launch import dryrun as D


@pytest.fixture(scope="module")
def fake256():
    """A fake group of 256 ranks and the (16, 16) production mesh on the
    CPU, for the module."""
    with D.fake_group(256):
        yield D.make_production_mesh(device="cpu")


#: SMOKE configs at production shapes over the (16, 16) fake mesh
TRACES = [("qwen3-4b", "train_4k"), ("olmoe-1b-7b", "train_4k")]


@pytest.fixture(scope="module")
def traces(fake256):
    return {cell: D.run_cell(PC.get_config(cell[0], smoke=True), cell[1],
                             "single", out_dir=None, mesh=fake256,
                             device="cpu")
            for cell in TRACES}


@pytest.mark.parametrize("cell", TRACES, ids=["/".join(c) for c in TRACES])
def test_smoke_cells_trace_the_cards_route(fake256, traces, cell):
    check_cell(fake256, cell, traces[cell])


def check_cell(mesh, cell, rec):
    """A traced cell's record: every key, the kernels' calls (a decode
    step's attention through the decode-attention kernel, a layer's
    launch each), the alias bytes of a train step, no score tensor outside
    B3's backward."""
    from repro_torch.launch.steps import _dp_total, microbatch_count
    arch, shape_name = cell
    cfg = PC.get_config(arch, smoke=True)
    shape = PC.SHAPES[shape_name]
    for key in ("memory", "flops_per_device", "dot_flops_per_device",
                "kernel_flops_per_device", "kernel_calls",
                "op_bytes_per_device", "collectives", "top_buffers",
                "t_trace_s"):
        assert key in rec, key
    assert rec["n_devices"] == 256 and rec["route"] == "card"
    assert set(rec["collectives"]) >= set(D.KINDS) | {"counts"}
    assert rec["flops_per_device"] == (rec["dot_flops_per_device"]
                                       + rec["kernel_flops_per_device"])
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == sum(mem["arguments"].values())
    assert mem["temp_peak_bytes"] > 0
    layers = cfg.n_layers
    attn = sum(m.startswith("attn") for m, _ in cfg.layer_pattern())
    calls = rec["kernel_calls"]
    if shape.kind == "train":
        n_micro = microbatch_count(cfg, shape.global_batch, shape.seq_len,
                                   dp_total=_dp_total(mesh))
        passes = n_micro * (2 if cfg.remat else 1)
        assert calls.get("flash_attention", 0) == attn * passes
        assert mem["alias_size_in_bytes"] == mem["arguments"]["params"] \
            + mem["arguments"]["opt"] - 4        # all but the step count
    elif shape.kind == "prefill":
        assert calls.get("flash_attention", 0) == attn
    else:
        assert "flash_attention" not in calls
        assert calls.get("decode_attention", 0) == attn
    if cfg.rwkv is not None and shape.kind == "decode":
        assert calls == {"rwkv6_scan": layers}
    # the forward's attention goes through B3: no score tensor but in its
    # plain backward
    s = shape.seq_len
    for buf in rec["top_buffers"]:
        if buf["range"] != "flash_attention.backward":
            assert tuple(buf["shape"][-2:]) != (s, s), buf
