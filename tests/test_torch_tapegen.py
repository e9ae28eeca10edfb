"""The port's seeded tapegen fuzzer (``repro_torch.testing.tapegen``), held
against the reference's (``repro.testing.tapegen``).

The reference's own cases, in the port (``tests/test_tapegen.py``):
generator determinism, grammar coverage, the graph differential (staged
builder == O(V²) oracle), the execution differential (fused torch and
triton stacks == unfused singleton floor, bitwise, on the CPU), exact-mode
dyadics and the CLI.  ``sharded=True`` needs the mesh, which is not ported:
it raises.

``xref``: the same seed through the JAX package (on the CPU) and through
the port (``device="cpu"``) records the same tape structure and gives
bitwise-equal outputs.
"""

import numpy as np
import pytest

from repro.core.cache import block_signature as ref_block_signature
from repro.testing import tapegen as ref_tapegen

from repro_torch.core import build_graph, build_graph_reference
from repro_torch.core.cache import block_signature
from repro_torch.core.ir import REDUCTIONS
from repro_torch.testing.tapegen import (TapeProgram, check_exec,
                                         check_graph, check_seed)

XREF_SEEDS = range(20)


def test_same_seed_same_tape():
    a = TapeProgram(7).record()
    b = TapeProgram(7).record()
    assert [op.opcode for op in a] == [op.opcode for op in b]
    assert [tuple(v.shape for v in op.in_views()) for op in a] == \
        [tuple(v.shape for v in op.in_views()) for op in b]


def test_different_seeds_differ():
    streams = {tuple(op.opcode for op in TapeProgram(s).record())
               for s in range(6)}
    assert len(streams) > 1


def test_grammar_coverage():
    """Across a modest seed range the generator exercises every op family:
    elementwise, reductions, strided/partial views, broadcasts, RMW."""
    ops, partial_writes, strided_reads, bcast = set(), 0, 0, 0
    for seed in range(12):
        for op in TapeProgram(seed, n_actions=30).record():
            ops.add(op.opcode)
            ov = op.out
            if ov is not None and not (ov.offset == 0
                                       and ov.size == ov.base.size):
                partial_writes += 1
            for v in op.in_views():
                if 0 in v.strides:
                    bcast += 1
                elif not v.is_contiguous() or v.offset != 0 \
                        or v.size != v.base.size:
                    strided_reads += 1
    assert ops & REDUCTIONS
    assert {"add", "mul", "where", "floor", "random", "gather"} <= ops
    assert partial_writes > 0 and strided_reads > 0 and bcast > 0


def test_sharded_programs_raise():
    """The reference's sharded grammar needs the mesh (not ported)."""
    with pytest.raises(NotImplementedError, match="A10b"):
        TapeProgram(0, sharded=True)


@pytest.mark.parametrize("seed", range(10))
def test_graph_differential(seed):
    check_graph(seed)


def test_graph_differential_inline_oracle():
    tape = TapeProgram(3, n_actions=30).record()
    a, b = build_graph(list(tape)), build_graph_reference(list(tape))
    assert (a.dep_out, a.dep_in, a.fuse_forbidden) == \
        (b.dep_out, b.dep_in, b.fuse_forbidden)


@pytest.mark.parametrize("seed", range(4))
def test_exec_differential_bitwise(seed):
    check_exec(seed, device="cpu")


def test_exec_differential_larger_size():
    check_exec(11, size=256, n_actions=24, device="cpu")


def test_exact_mode_values_are_low_granularity_dyadics():
    """Exact-mode outputs are bounded dyadic rationals: scaling by 2^20
    gives exact integers — the invariant that makes bitwise equality
    achievable."""
    for seed in (5, 9):
        outs = TapeProgram(seed, n_actions=30).run(algorithm="greedy",
                                                   backend="torch",
                                                   device="cpu")
        for a in outs:
            assert np.all(np.isfinite(a))
            scaled = a * float(2 ** 20)
            assert np.array_equal(scaled, np.round(scaled))


def test_cli_sweep_smoke(capsys):
    from repro_torch.testing.tapegen import main
    main(["--n", "2", "--checks", "graph,exec,loop", "--device", "cpu"])
    assert "differential-identical" in capsys.readouterr().out


def test_check_seed_names_unknown_checks():
    check_seed(1, ("graph",))
    with pytest.raises(ValueError, match="unknown check"):
        check_seed(1, ("dist",), device="cpu")


# ---------------------------------------------------------------------------
# xref: the same seed in both packages
# ---------------------------------------------------------------------------

def _struct(tape, sig):
    """A tape's structure, free of uids: each op's opcode, axis and view
    geometry (literals as floats), and the signature's base numbering."""
    def geo(v):
        if not hasattr(v, "base"):
            return float(v)
        return (v.offset, v.shape, v.strides, v.base.size, str(v.base.dtype))
    ops = [(op.opcode, op.axis, geo(op.out) if op.out is not None else None,
            tuple(geo(x) for x in op.inputs)) for op in tape]
    return ops, [bases for _, bases in sig(tape)]


@pytest.mark.parametrize("seed", XREF_SEEDS)
def test_xref_tape_program_bitwise(seed):
    """``TapeProgram(seed, exact=True)``: the same action sequence records
    the same tape structure in both packages, and the JAX package (XLA on
    the CPU) and the port's torch floor give the same bits."""
    ref_prog = ref_tapegen.TapeProgram(seed, exact=True)
    prog = TapeProgram(seed, exact=True)
    ref_tape, tape = ref_prog.record(), prog.record()
    assert _struct(ref_tape, ref_block_signature) == \
        _struct(tape, block_signature)
    ref = ref_prog.run()
    got = prog.run(device="cpu")
    ref_tapegen._assert_bitwise(ref, got, f"seed {seed} [port vs reference]")
