"""The port's planning core against the JAX package's, on the same tapes.

Tapes are recorded with the reference runtime and rebuilt op for op in the
port's IR (:func:`to_port`).  Sources: the paper's worked examples
(``tests/test_paper_figures.py``), the randomized and structured tapes of
``tests/test_scheduler_pipeline.py``, and non-sharded
``repro.testing.tapegen`` programs.  For every partition algorithm and the
paper cost models, and for the port's ``gpu`` model against the
reference's ``tpu`` model built with the same constants, the WSP edges,
the block lists and the partition costs must match EXACTLY.
"""

import numpy as np
import pytest

import repro.core.ir as rir
from repro.core import build_graph as ref_build_graph
from repro.core import build_graph_reference as ref_build_graph_reference
from repro.core import partition as ref_partition
from repro.core.cost import TPUCost
from repro.core.lazy import fresh_runtime as ref_fresh_runtime
from repro.testing.tapegen import TapeProgram

import repro_torch.core.ir as pir
from repro_torch.core import build_graph, build_graph_reference, partition
from repro_torch.core.cost import HBM_BW, KERNEL_LAUNCH_S, make_cost_model

PAPER_MODELS = ("bohrium", "max_contract", "max_locality", "robinson")
ALGORITHMS = ("singleton", "linear", "greedy", "unintrusive", "optimal")
NODE_BUDGET = 2000          # same budget on both sides keeps optimal exact


# ---------------------------------------------------------------------------
# Tape translation between the packages (structure-preserving)
# ---------------------------------------------------------------------------

def _translate(tape, src_view_cls, dst_base_cls, dst_view_cls, dst_op_cls):
    bases = {}

    def base(b):
        got = bases.get(b.uid)
        if got is None:
            got = bases[b.uid] = dst_base_cls(b.size, b.dtype, name=b.name)
        return got

    def view(v):
        return dst_view_cls(base(v.base), v.offset, v.shape, v.strides)

    out = []
    for op in tape:
        new = dst_op_cls(
            op.opcode, view(op.out) if op.out is not None else None,
            tuple(view(x) if isinstance(x, src_view_cls) else x
                  for x in op.inputs),
            axis=op.axis,
            new_bases=frozenset(base(b) for b in
                                sorted(op.new_bases, key=lambda b: b.uid)),
            del_bases=frozenset(base(b) for b in
                                sorted(op.del_bases, key=lambda b: b.uid)),
            sync_bases=frozenset(base(b) for b in
                                 sorted(op.sync_bases, key=lambda b: b.uid)),
            tag=op.tag)
        if hasattr(op, "salt"):
            new.salt = op.salt
        out.append(new)
    return out


def to_port(tape):
    """A reference tape rebuilt in the port's IR (fresh bases, same
    structure, ops created in program order)."""
    return _translate(tape, rir.View, pir.BaseArray, pir.View, pir.Op)


def to_reference(tape):
    """A port tape rebuilt in the reference's IR."""
    return _translate(tape, pir.View, rir.BaseArray, rir.View, rir.Op)


# ---------------------------------------------------------------------------
# Tape sources
# ---------------------------------------------------------------------------

def _paper_tapes():
    from test_paper_figures import record_fig2_program, record_fig20
    tapes = {}
    with ref_fresh_runtime() as rt:
        tapes["fig2"] = list(record_fig2_program(rt))
        rt.tape.clear()
    with ref_fresh_runtime() as rt:
        h = record_fig20(rt)
        tapes["fig20"] = list(rt.tape)
        rt.tape.clear()
        h._alive = False
    return tapes


def _pipeline_tapes():
    from test_scheduler_pipeline import ALL_TAPES
    return dict(ALL_TAPES)


def _tapegen_tapes(seeds=range(8)):
    return {f"tapegen{s}": TapeProgram(s, n_actions=16).record()
            for s in seeds}


TAPES = {**_paper_tapes(), **_pipeline_tapes(), **_tapegen_tapes()}
SMALL = {n for n, t in TAPES.items() if len(t) <= 30}


def test_translation_round_trips_structure():
    from repro.core.cache import block_signature as ref_sig
    for name, tape in TAPES.items():
        port = to_port(tape)
        assert [op.opcode for op in port] == [op.opcode for op in tape]
        assert ref_sig(to_reference(port)) == ref_sig(tape), name


@pytest.mark.parametrize("name", sorted(TAPES))
def test_wsp_edges_match(name):
    tape = TAPES[name]
    port = to_port(tape)
    for build, ref_build in ((build_graph, ref_build_graph),
                             (build_graph_reference,
                              ref_build_graph_reference)):
        g, r = build(port), ref_build(list(tape))
        assert g.dep_out == r.dep_out
        assert g.dep_in == r.dep_in
        assert g.fuse_forbidden == r.fuse_forbidden


def _algorithms(name, model):
    """Every algorithm on the short tapes; on the longer ones the
    branch-and-bound search is left out, and so is the unintrusive sweep
    under the dense-weight models (``robinson``, ``gpu``), whose all-pairs
    weight graphs make it slow without adding cases."""
    if name in SMALL:
        return ALGORITHMS
    if model in ("robinson", "gpu"):
        return ALGORITHMS[:3]
    return ALGORITHMS[:4]


@pytest.mark.parametrize("algo", ALGORITHMS)
@pytest.mark.parametrize("model", PAPER_MODELS)
def test_partitions_match_for_paper_models(model, algo):
    for name, tape in TAPES.items():
        port = to_port(tape)
        if algo in _algorithms(name, model):
            got = partition(port, algorithm=algo, cost_model=model,
                            node_budget=NODE_BUDGET)
            want = ref_partition(list(tape), algorithm=algo, cost_model=model,
                                 node_budget=NODE_BUDGET)
            assert got.op_blocks() == want.op_blocks(), (name, algo)
            assert got.cost == want.cost, (name, algo)


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_gpu_model_matches_tpu_model_with_the_same_constants(algo):
    """``gpu`` is the reference's ``tpu`` structure: with the H100 constants
    plugged into ``TPUCost`` both plan every tape identically (this also
    holds the port's codegen analysis to the reference's on every block
    the partitioner prices)."""
    for name, tape in TAPES.items():
        port = to_port(tape)
        if algo in _algorithms(name, "gpu"):
            got = partition(port, algorithm=algo, cost_model="gpu",
                            node_budget=NODE_BUDGET)
            want = ref_partition(
                list(tape), algorithm=algo, node_budget=NODE_BUDGET,
                cost_model=TPUCost(hbm_bw=HBM_BW, launch_s=KERNEL_LAUNCH_S))
            assert got.op_blocks() == want.op_blocks(), (name, algo)
            assert got.cost == want.cost, (name, algo)


def test_paper_figure_costs():
    """The port reproduces the reference's pinned figure costs."""
    port = to_port(TAPES["fig2"])
    costs = {a: partition(port, algorithm=a, cost_model="bohrium").cost
             for a in ("singleton", "greedy", "linear", "unintrusive",
                       "optimal")}
    assert costs == {"singleton": 94, "greedy": 38, "linear": 62,
                     "unintrusive": 74, "optimal": 38}


def test_gpu_model_is_monotone_on_real_merges():
    """Merge savings never go negative beyond float rounding (block costs
    are sums of ~1e-6 s terms; 1e-18 s is far below one launch)."""
    model = make_cost_model("gpu")
    from repro_torch.core.blocks import BlockInfo
    tape = to_port(TAPES["stencil"])
    infos = [BlockInfo.from_op(op) for op in tape]
    for a, b in zip(infos, infos[1:]):
        assert model.merge_saving(a, b) >= -1e-18
    assert np.isfinite(model.partition_cost(infos))
