"""Buffer reuse in the port: which input buffers a block may overwrite, and
which output bases the fused-block kernel then stores in place.

* ``BlockPlan.donatable`` is the reference's (``repro.core.scheduler.
  plan_blocks``) on the same blocks: inputs whose base dies in the block
  and is not SYNC'd.
* The executor grants a donating backend the donatable inputs and those of
  a base the block rewrites, never one whose storage another buffer or a
  SYNC snapshot holds.
* The kernel's wrapper (its plain version here, on the CPU, with the same
  rule as the card) stores a rewritten base into its own storage only when
  granted and when every read of that base from memory is the identical
  view of each write or disjoint from it; a stencil that reads its base at
  shifted views takes a copy, and a buffer outside the grant never changes.
* Whole programs on the ``triton`` backend equal the port's floor: bitwise
  on the programs of correctly rounded ops, 1e-12 relative on the others.
"""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core.algorithms import partition as ref_partition
from repro.core.ir import BaseArray, Op, View
from repro.core.scheduler import plan_blocks as ref_plan_blocks

from repro_torch.core import lazy as bh
from repro_torch.core.executor import BlockExecutor, _storage, make_block_fn
from repro_torch.core.lazy import fresh_runtime
from repro_torch.core.scheduler import plan_blocks
from repro_torch.kernels.fused_block import codegen
from repro_torch.testing.programs import BENCHMARKS, quickstart
from test_codegen import SCALED
from test_torch_planning import to_port

#: programs of correctly rounded ops whose sums add exact integers
EXACT = {"game_of_life", "heat_equation", "sor", "water_ice", "shallow_water",
         "gauss_elimination", "lu_factorization", "stencil_27pt",
         "lattice_boltzmann", "monte_carlo_pi"}


def _base(n, dtype=np.float64):
    return BaseArray(n, np.dtype(dtype))


def _dying_base_tapes():
    """Hand-built tapes that delete a base inside a block: a consumed
    temporary, a rewritten base deleted after its write, and a DEL+SYNC
    pair (SYNC'd, so never donatable)."""
    n = 16
    a, b, c, t = (_base(n) for _ in range(4))
    va, vb, vc, vt = (View.contiguous(x, (n,)) for x in (a, b, c, t))
    return {
        "consumed": [Op("mul", vt, (va, 2.0), new_bases=frozenset({t})),
                     Op("add", vb, (vt, va), new_bases=frozenset({b})),
                     Op("del", None, del_bases=frozenset({a})),
                     Op("del", None, del_bases=frozenset({t}))],
        "rewritten": [Op("add", View(c, 2, (4,), (1,)),
                         (View(a, 0, (4,), (1,)), 1.0)),
                      Op("copy", vb, (vc,), new_bases=frozenset({b})),
                      Op("del", None, del_bases=frozenset({c}))],
        "synced": [Op("add", vb, (va, 1.0), new_bases=frozenset({b})),
                   Op("sync", None, sync_bases=frozenset({a})),
                   Op("del", None, del_bases=frozenset({a}))],
    }


def _tapes():
    from test_scheduler_pipeline import ALL_TAPES
    return {**dict(ALL_TAPES), **_dying_base_tapes()}


@pytest.mark.parametrize("name", sorted(_tapes()))
def test_donatable_positions_match_reference(name):
    tape = _tapes()[name]
    blocks = ref_partition(list(tape), algorithm="greedy",
                           cost_model="bohrium").op_blocks()
    want = ref_plan_blocks(list(tape), blocks)
    got = plan_blocks(to_port(tape), blocks)
    assert [p.donatable for p in got] == [p.donatable for p in want]
    # (base uids differ across the translation; positions line up)
    assert [len(p.inputs) for p in got] == [len(p.inputs) for p in want]
    if name in ("consumed", "rewritten"):
        assert any(p.donatable for p in got)


def test_grant_is_donatable_or_rewritten_inputs_held_once():
    """``_grant``: donatable positions and inputs of an output base, minus
    any whose storage another holder (a buffer of another base, a view of
    it, or a SYNC snapshot) shares."""
    x, y, z, w = (torch.zeros(8) for _ in range(4))
    alias = w[2:]                               # a floor output can be a view
    bufs = [x, y, z, w]
    plan = SimpleNamespace(inputs=(1, 2, 3, 4), outputs=(2, 4, 9),
                           donatable=(0,))
    refs = Counter(_storage(b) for b in (*bufs, alias))
    assert BlockExecutor._grant(plan, bufs, refs) == frozenset({0, 1})
    refs[_storage(y)] += 1                      # y also a SYNC snapshot
    assert BlockExecutor._grant(plan, bufs, refs) == frozenset({0})


def _rmw_block(m=12):
    """``g[1:-1, 1:-1] = (r + 1) * 0.5`` with ``r`` another base, and a
    second base ``h`` rewritten in a window: reads of g and h are identical
    to or disjoint from their writes."""
    g, r, h = _base(m * m), _base((m - 2) ** 2), _base(m * m)
    win = View(g, m + 1, (m - 2, m - 2), (m, 1))
    hwin = View(h, m + 1, (m - 2, m - 2), (m, 1))
    vr = View.contiguous(r, (m - 2, m - 2))
    return [Op("add", win, (vr, 1.0)), Op("mul", win, (win, 0.5)),
            Op("add", hwin, (hwin, win))]


def _stencil_block(m=12):
    """A stencil that reads ``g`` at shifted views and writes its interior
    in the same (hand-built) block."""
    g, inner = _base(m * m), _base((m - 2) ** 2)
    win = lambda i0, j0: View(g, i0 * m + j0, (m - 2, m - 2), (m, 1))  # noqa: E731
    vin = View.contiguous(inner, (m - 2, m - 2))
    return [Op("add", vin, (win(1, 0), win(1, 2)), new_bases=frozenset({inner})),
            Op("add", vin, (vin, win(0, 1))),
            Op("mul", vin, (vin, 0.25)),
            Op("copy", win(1, 1), (vin,)),
            Op("del", None, del_bases=frozenset({inner}))]


def _inputs(fn, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-9, 9, fn.plan.base_meta[u][0])
                             .astype(np.float64)) for u in fn.plan.inputs]


def test_window_writes_store_in_place_only_where_granted():
    ops = to_port(_rmw_block())
    fn, ins, outs = codegen.build_block_kernel(ops, device="cpu")
    floor, _, _ = make_block_fn(ops, device="cpu")
    assert set(fn.plan.in_place) == set(outs)
    bufs = _inputs(fn)
    keep = [b.clone() for b in bufs]
    want = floor(*bufs, ())
    copied = fn(*bufs, ())                      # no grant: new buffers
    for b, k in zip(bufs, keep):
        assert torch.equal(b, k)
    pos = {u: k for k, u in enumerate(ins)}
    g_pos, h_pos = (pos[u] for u in outs)
    got = fn(*bufs, (), reuse=frozenset({g_pos}))    # h stays outside
    assert got[0] is bufs[g_pos] and got[1] is not bufs[h_pos]
    assert torch.equal(bufs[h_pos], keep[h_pos])     # never changes
    for g, c, w in zip(got, copied, want):
        assert torch.equal(g, w) and torch.equal(c, w)


def test_stencil_reading_shifted_views_takes_the_copy():
    ops = to_port(_stencil_block())
    fn, ins, outs = codegen.build_block_kernel(ops, device="cpu")
    floor, _, _ = make_block_fn(ops, device="cpu")
    assert not fn.plan.in_place and outs[0] in ins
    bufs = _inputs(fn, 3)
    keep = bufs[0].clone()
    got = fn(*bufs, (), reuse=frozenset({0}))
    assert got[0] is not bufs[0] and torch.equal(bufs[0], keep)
    assert torch.equal(got[0], floor(*bufs, ())[0])


def test_runtime_writes_in_place_but_never_into_a_sync_snapshot():
    with fresh_runtime(backend="triton", device="cpu",
                       loop_fusion=False) as rt:
        g = bh.zeros((8, 8))
        g[0:1, :] = 100.0
        seen = g.numpy()                        # SYNC: snapshot of g's buffer
        snap = rt.executor.sync_store[g.view.base.uid]
        kept = snap.clone()
        h = bh.zeros((8, 8))
        h[0:1, :] = 1.0
        bh.flush()
        n0 = rt.executor.stats["donated_buffers"]
        g[2:4, 2:4] = 7.0                       # g's storage is the snapshot's
        h[2:4, 2:4] = 5.0                       # h's is held once: in place
        bh.flush()
        assert torch.equal(snap, kept)
        assert rt.executor.stats["donated_buffers"] == n0 + 1
        want_g = seen.copy()
        want_g[2:4, 2:4] = 7.0
        np.testing.assert_array_equal(g.numpy(), want_g)
        assert h.numpy()[3, 3] == 5.0 and h.numpy()[0, 5] == 1.0


CASES = list(SCALED) + [("quickstart", (1, 5000))]
PROGRAMS = dict(BENCHMARKS, quickstart=quickstart)


@pytest.mark.parametrize("name,args", CASES, ids=[c[0] for c in CASES])
def test_program_on_triton_equals_the_floor(name, args):
    out = {}
    for backend in ("torch", "triton"):
        with fresh_runtime(backend=backend, device="cpu",
                           loop_fusion=False) as rt:
            out[backend] = np.asarray(PROGRAMS[name](*args))
            donated = rt.executor.stats["donated_buffers"]
    if name in EXACT:
        np.testing.assert_array_equal(out["triton"], out["torch"])
    else:
        np.testing.assert_allclose(out["triton"], out["torch"], rtol=1e-12,
                                   atol=0)
    # every program but the quickstart rewrites a base in place
    assert (donated > 0) == (name != "quickstart"), donated
