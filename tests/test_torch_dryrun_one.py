"""The multi-pod dry run (``launch/dryrun.py``) held against a real
world-of-one gloo step on the CPU, Qwen3-4B's SMOKE config: on a (1, 1)
mesh the fake trace's ``flops_per_device`` equals ``FlopCounterMode``
over the real step (global equals local there) and its argument bytes
the real parameters', moments' and batch's ``nbytes``: the train step on
the card's route (``core.device.card_route``: B3's operator, whose CPU
implementation is the plain version, counted by its formula), the
prefill and the decode step."""

import numpy as np
import torch
import torch.distributed as tdist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ShapeSpec
from repro_torch.core.device import card_route
from repro_torch.distributed.sharding import shard_tree
from repro_torch.launch import dryrun as D
from repro_torch.launch.steps import make_serve_steps, make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

from test_torch_dryrun_mesh import BATCH, CFG, PROMPT, SEQ, _batch, _fake, \
    _mesh

MICRO = 2
TRAIN_KW = dict(num_microbatches=MICRO)


def _nbytes(tree):
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return sum(_nbytes(v) for v in tree)


def _real_world_of_one():
    """FLOPs and argument bytes of the real steps on a (1, 1) gloo mesh."""
    tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0,
                             world_size=1)
    try:
        mesh = _mesh((1, 1))
        gen = torch.Generator().manual_seed(0)
        step, specs = make_train_step(CFG, mesh, **TRAIN_KW)
        params = shard_tree(T.init_params(CFG, gen, "cpu"), specs["params"],
                            mesh)
        opt = adamw_init(params, state_dtype=CFG.opt_state_dtype)
        batch = _batch(BATCH, SEQ)
        out = {"train_bytes": _nbytes(params) + _nbytes(opt)
               + _nbytes(batch)}
        with card_route(), FlopCounterMode(display=False) as fc:
            step(params, opt, batch)
        out["train"] = fc.get_total_flops()
        prefill, decode, specs = make_serve_steps(CFG, mesh, PROMPT + 1,
                                                  BATCH)
        toks = torch.as_tensor(_batch(BATCH, PROMPT)["tokens"])
        out["prefill_bytes"] = _nbytes(params) + _nbytes(toks)
        with FlopCounterMode(display=False) as fc:
            _, cache = prefill(params, {"tokens": toks})
        out["prefill"] = fc.get_total_flops()
        tok = toks[:, :1]
        out["decode_bytes"] = _nbytes(params) + _nbytes(cache) \
            + _nbytes(tok)
        with FlopCounterMode(display=False) as fc:
            decode(params, cache, tok)
        out["decode"] = fc.get_total_flops()
        return out
    finally:
        tdist.destroy_process_group()


def test_one_by_one_trace_equals_a_real_step():
    want = _real_world_of_one()
    got = _fake((1, 1), {"train": ShapeSpec("t", SEQ, BATCH, "train")},
                train_kw=TRAIN_KW)
    got.update(_fake((1, 1), {
        "prefill": ShapeSpec("p", PROMPT, BATCH, "prefill"),
        "decode": ShapeSpec("d", PROMPT + 1, BATCH, "decode")},
        kernels=False))
    assert got["train"]["kernel_calls"] == {"flash_attention":
                                            CFG.n_layers * MICRO}
    for cell in ("train", "prefill", "decode"):
        rec = got[cell]
        assert rec["flops_per_device"] == want[cell], cell
        assert rec["memory"]["argument_size_in_bytes"] == \
            want[f"{cell}_bytes"], cell
        assert not any(rec["collectives"][k] for k in D.KINDS), cell
