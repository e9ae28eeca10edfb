"""The model on a 1 x 1 mesh (a world of one over gloo in this process,
torn down at the end of the module) against the mesh-less port: the
train step (two steps of two microbatches, float32 and int8 moments) and
the serve steps (a prefill and two decode steps of five families)
bitwise, ``serve_requests`` with the mesh equal to it without one, and
the launchers keeping the mesh-less path in a world of one.  Over one
rank every local shard is the whole tensor, so nothing may change."""

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PA
from test_torch_mesh_model import DECODE, PROMPT, TRAIN_KW, case


@pytest.fixture(scope="module")
def one_by_one():
    if tdist.is_initialized():
        pytest.fail("a process group is already up")
    mesh = make_host_mesh(device="cpu")
    yield mesh
    tdist.destroy_process_group()


def _shard_state(params, opt, specs, mesh):
    from repro_torch.distributed.sharding import shard_tree
    return (shard_tree(params, specs["params"], mesh),
            PA.OptState(opt.step, shard_tree(opt.m, specs["opt"].m, mesh),
                        shard_tree(opt.v, specs["opt"].v, mesh)))


@pytest.mark.parametrize("opt_state", ["f32", "int8"])
def test_one_by_one_train_step_is_bitwise_the_meshless_step(one_by_one,
                                                            opt_state):
    c = case("qwen3-4b")
    kw = dict(TRAIN_KW, opt_state_dtype=opt_state)
    plain, _ = PS.make_train_step(c["pcfg"], device="cpu", **kw)
    on_mesh, specs = PS.make_train_step(c["pcfg"], one_by_one, **kw)
    assert dict(one_by_one.shape and zip(one_by_one.mesh_dim_names,
                                         one_by_one.shape)) == {
        "data": 1, "model": 1}
    p = PT.params_from_numpy(c["weights"], "cpu")
    o = PA.adamw_init(p, state_dtype=opt_state)
    dp, do = _shard_state(PT.params_from_numpy(c["weights"], "cpu"),
                          PA.adamw_init(p, state_dtype=opt_state), specs,
                          one_by_one)
    for b in c["batches"]:
        p, o, m = plain(p, o, b)
        dp, do, dm = on_mesh(dp, do, b)
        assert torch.equal(m["loss"], dm["loss"])
        assert not hasattr(dm["loss"], "placements")
    for (path, a), (_, b) in zip(PA._paths(p), PA._paths(dp)):
        assert torch.equal(a, b.full_tensor()), path
    for (path, a), (_, b) in zip(PA._paths(o.m), PA._paths(do.m)):
        a = a if isinstance(a, dict) else {"": a}
        b = b if isinstance(b, dict) else {"": b}
        for k in a:
            assert torch.equal(a[k], b[k].full_tensor()), (path, k)


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma2-9b", "rwkv6-3b",
                                  "jamba-v0.1-52b", "whisper-tiny"])
def test_one_by_one_serve_steps_are_bitwise_the_meshless_model(one_by_one,
                                                               arch):
    from repro_torch.distributed.sharding import shard_tree
    c = case(arch)
    cfg, s = c["pcfg"], c["serve"]
    max_seq = PROMPT + DECODE
    prefill, decode, specs = PS.make_serve_steps(cfg, one_by_one, max_seq, 2)
    sp = PT.serving_params(PT.params_from_numpy(c["weights"], "cpu"), cfg)
    dsp = shard_tree(sp, specs["params"], one_by_one)
    kw = {k: torch.as_tensor(s[k]) for k in ("frames",) if k in s}
    want, wc = PT.serve_prefill(sp, s["tokens"], cfg, max_seq, **kw)
    got, gc = prefill(dsp, {"tokens": torch.as_tensor(s["tokens"]), **kw})
    assert torch.equal(got.full_tensor(), want)
    enc = PT.encode(sp, kw["frames"], cfg) if kw else None
    denc = None
    if kw:
        with PS._mesh_scope(one_by_one):
            denc = PT.encode(dsp, kw["frames"], cfg)
    for j in range(DECODE):
        tok = torch.as_tensor(s["decode"][:, j:j + 1])
        want, wc = PT.serve_decode(sp, wc, tok, cfg, enc_out=enc)
        got, gc = decode(dsp, gc, tok, denc)
        assert torch.equal(got.full_tensor(), want), j


def test_serve_requests_on_the_one_by_one_mesh_equals_no_mesh(one_by_one):
    from repro_torch.launch.serve import draw_prompts, serve_requests
    c = case("qwen3-4b")
    cfg = c["pcfg"]
    params = PT.params_from_numpy(c["weights"], "cpu")
    prompts = draw_prompts(0, 3, 12, cfg.vocab_size)
    kw = dict(batch=2, max_prompt=12, new_tokens=3)
    want, _ = serve_requests(cfg, params, prompts, **kw)
    got, times = serve_requests(cfg, params, prompts, mesh=one_by_one, **kw)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert times[0]["prefill"] is None and len(times) == 2


def test_launchers_take_no_mesh_in_a_world_of_one(one_by_one):
    from repro_torch.launch.mesh import launcher_mesh
    assert tdist.get_world_size() == 1
    assert launcher_mesh("cpu") is None
