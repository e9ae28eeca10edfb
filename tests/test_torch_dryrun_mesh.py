"""The multi-pod dry run (``launch/dryrun.py``) held against real steps on
the CPU, Qwen3-4B's SMOKE config (``test_torch_dryrun_one.py`` holds a
(1, 1) trace's FLOPs and bytes).  On a (2, 2) mesh of the fake group a
trace's collective counts by kind equal ``CommDebugMode``'s from the
real 4-rank
gloo steps (``testing.mesh.model_suite``, the CPU's route on both
sides: gloo's all-gather in place of an all-to-all; the prompt placed
over the data axes, as the dry run's prefill takes it)."""

import concurrent.futures

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun as D
from repro_torch.testing import mesh as tmesh

CFG = get_config("qwen3-4b", smoke=True)
BATCH, SEQ, PROMPT = 4, 32, 16


def _batch(b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _mesh(shape):
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(
        shape), mesh_dim_names=("data", "model"))


def _fake(shape, cells, **kw):
    with D.fake_group(int(np.prod(shape))):
        mesh = _mesh(shape)
        return {name: D.run_cell(CFG, spec, "x".join(map(str, shape)),
                                 out_dir=None, mesh=mesh, device="cpu", **kw)
                for name, spec in cells.items()}


@pytest.fixture(scope="module")
def two_by_two():
    """The real 4-rank gloo steps' ``CommDebugMode`` counts (rank 0's) and
    the fake (2, 2) traces of the same cells."""
    rng = np.random.default_rng(1)
    serve = {"tokens": rng.integers(0, CFG.vocab_size, (BATCH, PROMPT)),
             "decode": rng.integers(0, CFG.vocab_size, (BATCH, 1))}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the ranks run in their own processes while this one traces
        ranks = pool.submit(tmesh.spawn, tmesh.run_suites, 4, device="cpu",
                            jobs=[("model_suite", dict(
                                cfg=CFG, weights=3, shape=(2, 2),
                                batches=[_batch(BATCH, SEQ)],
                                train_kw=dict(num_microbatches=1),
                                serve=serve, keep_params=False,
                                place_inputs=True))])
        fake = _fake((2, 2), {
            "train_step_0": ShapeSpec("t", SEQ, BATCH, "train"),
            "prefill": ShapeSpec("p", PROMPT, BATCH, "prefill"),
            "decode": ShapeSpec("d", PROMPT + 1, BATCH, "decode")},
            kernels=False, train_kw=dict(num_microbatches=1))
        return ranks.result()[0][0]["comm"], fake


@pytest.mark.parametrize("phase", ["train_step_0", "prefill", "decode"])
def test_two_by_two_collectives_equal_the_real_ranks(two_by_two, phase):
    """The reference's kinds; the real train step's others are its whole
    batch's placement (``distribute_tensor``: a scatter over the data
    axis and a broadcast over the model axis an entry), which a dry run's
    batch, placed already, does not make."""
    real, fake = two_by_two
    want, other = {}, {}
    for name, n in real[phase].items():
        kind = D._collective_kind(name)
        into = want if kind in D.KINDS else other
        into[kind] = into.get(kind, 0) + n
    counts = fake[phase]["collectives"]["counts"]
    got = {k: n for k, n in counts.items() if n and k in D.KINDS}
    assert got == want
    assert sum(got.values()) > 0
    # the real train step's whole batch is placed in the step: a scatter
    # and a broadcast an entry
    entries = 2 if phase == "train_step_0" else 0
    for kind in ("scatter", "broadcast"):
        assert other.get(kind, 0) == counts.get(kind, 0) + entries, kind
