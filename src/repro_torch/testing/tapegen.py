"""Seeded random lazy-program generators and differential fuzzer — the port
of ``repro/testing/tapegen.py``.

A :class:`TapeProgram` is a deterministic function of its seed: it draws
the identical ``random.Random(seed)`` action sequence as the reference's,
so one seed records the same tape structure in both packages (elementwise
chains, reductions, strided and partial views, RMW partial writes,
broadcasts, transposes, matmuls, DELs, quantized ``random`` draws and
gathers).  Replaying one program under different runtime configurations
is a *differential test*: every configuration must produce
bitwise-identical results.  In ``exact=True`` mode the programs stay
closed over low-granularity dyadic float64 data, so elementwise ops and
reductions are exact and the answer does not depend on partition,
tiling or summation order.  The reference's placement annotations
(``sharded=True``) need the mesh, which is not ported yet (ROADMAP A10b).

:class:`IterativeProgram` replays one seeded step recipe with a flush per
step — the shape cross-flush loop fusion (``core/loop.py``) defers and
drains — and :class:`LMProgram` draws the same shapes and numpy leaves as
the reference's LM-shaped programs.

Checks (each returns normally or raises ``AssertionError``):

* ``check_graph`` — staged base-indexed ``build_graph`` produces identical
  E_d/E_f to the O(V²) ``build_graph_reference`` oracle;
* ``check_exec``  — fused greedy torch and triton runs are bitwise
  identical to the unfused singleton torch floor;
* ``check_loop``  — loop-fused runs of an :class:`IterativeProgram` are
  bitwise identical to per-flush runs, on both stacks;
* ``check_lm``    — the ``lm`` stack against the torch floor under the
  same partition (below);
* ``check_serve`` — concurrent sessions and a micro-batching server
  against serial runs, bitwise (below).

The cross-package check (``xref``: the same seed through the JAX package
and through the port, bitwise) imports the JAX package, so it lives in the
port's tests, not here.

CLI sweep (on the CUDA card unless ``--device`` names another)::

    PYTHONPATH=src python -m repro_torch.testing.tapegen --n 200
    PYTHONPATH=src python -m repro_torch.testing.tapegen --n 40 --device cpu
    PYTHONPATH=src python -m repro_torch.testing.tapegen --only 1337   # repro
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

# value bound for products: keeps every intermediate integer exactly
# representable in float64 (see module docstring)
_MOD = 1021.0


class TapeProgram:
    """One seeded random lazy program.

    Parameters
    ----------
    seed      : the program identity; everything derives from it.
    n_actions : number of generator actions (tape length scales with it).
    size      : elements in the 1-D working shape (2-D uses ``(8, size//8)``;
                sizes below 64 are rounded up so both shapes exist).
    exact     : restrict to the dyadic/integer-valued opcode pool whose
                results are bitwise partition-invariant (see module doc).
    sharded   : the reference's placement annotations; the mesh is not
                ported yet (ROADMAP A10b), so ``True`` raises
                ``NotImplementedError``.
    n_shards  : logical shard count (kept for the reference's signature).
    """

    def __init__(self, seed: int, *, n_actions: int = 20, size: int = 64,
                 exact: bool = True, sharded: bool = False,
                 n_shards: int = 4):
        if sharded:
            raise NotImplementedError(
                "sharded programs need the mesh, which is not ported yet "
                "(ROADMAP A10b)")
        self.seed = int(seed)
        self.n_actions = int(n_actions)
        self.size = max(64, int(size) - int(size) % 8)
        self.exact = bool(exact)
        self.sharded = False
        self.n_shards = int(n_shards)

    # -- the generator --------------------------------------------------
    def _build(self, rt, materialize: bool) -> List[np.ndarray]:
        """Run the action sequence against runtime ``rt`` (already the
        active runtime).  With ``materialize`` the live arrays are read
        back (flushing the tape); without, the recorded tape is left in
        place for graph-level checks."""
        from ..core import lazy as bh
        rnd = random.Random(self.seed)
        n = self.size
        shapes = {"1d": (n,), "2d": (8, n // 8)}
        pool: List[Tuple[object, str, bool]] = []   # (arr, kind, whole_base)

        def quantize(a):
            # integer-valued in [0, 16): exact under float64 arithmetic
            return bh.floor(a * 16.0)

        def fresh(kind: str):
            shape = shapes[kind]
            w = rnd.randrange(3)
            if w == 0:
                a = bh.full(shape, float(rnd.randrange(-8, 9)))
            elif w == 1 and kind == "1d":
                a = bh.arange(n) * (0.5 if rnd.random() < 0.3 else 1.0)
            else:
                a = quantize(bh.random(shape))
            pool.append((a, kind, True))
            return a

        for kind in ("1d", "2d"):
            fresh(kind)
        def pick(kind: Optional[str] = None):
            cands = [e for e in pool if kind is None or e[1] == kind]
            return cands[rnd.randrange(len(cands))] if cands else None

        def clamp(a):
            # After an array-array product, both bound the magnitude AND
            # reset the dyadic granularity to whole integers: reductions
            # over the result are then exactly associative no matter how
            # deep the producing chains were (see module docstring).
            return bh.floor(a % _MOD) if self.exact \
                else bh.tanh(a * 0.125) * 8.0

        for _ in range(self.n_actions):
            act = rnd.randrange(15)
            ent = pick()
            if ent is None:
                fresh("1d")
                continue
            a, kind, _whole = ent
            if kind not in shapes and act not in (0, 2, 3, 11):
                continue    # odd-shaped leftovers only do shape-free actions
            shape = shapes.get(kind)
            if act == 0:                       # new leaf
                fresh(rnd.choice(("1d", "2d")))
            elif act == 1:                     # elementwise binop, same shape
                other = pick(kind)
                oc = rnd.choice(("add", "sub", "mul", "maximum", "minimum"))
                b = other[0]
                r = {"add": lambda: a + b, "sub": lambda: a - b,
                     "mul": lambda: clamp(a * b),
                     "maximum": lambda: bh.maximum(a, b),
                     "minimum": lambda: bh.minimum(a, b)}[oc]()
                pool.append((r, kind, True))
            elif act == 2:                     # scalar chain (dyadic consts)
                c = rnd.choice((0.5, 0.25, 2.0, 3.0, -1.5))
                r = a * c
                if self.exact and abs(c) >= 1.5:
                    r = r % _MOD               # upscaling: re-bound magnitude
                r = r + float(rnd.randrange(-4, 5))
                pool.append((r, kind, True))
            elif act == 3:                     # unary
                fns = [bh.absolute, bh.floor, bh.sign,
                       lambda x: -x, lambda x: x.copy()]
                if not self.exact:
                    fns += [lambda x: bh.sqrt(bh.absolute(x)), bh.sin,
                            bh.cos, bh.tanh,
                            lambda x: bh.log(bh.absolute(x) + 1.0),
                            lambda x: 1.0 / (bh.absolute(x) + 1.0)]
                pool.append((fns[rnd.randrange(len(fns))](a), kind, True))
            elif act == 4:                     # in-place update (same base)
                other = pick(kind)
                a += other[0] * rnd.choice((0.5, 1.0, 2.0))
            elif act == 5:                     # where on a comparison
                other = pick(kind)
                pool.append((bh.where(a > other[0], a, other[0]), kind, True))
            elif act == 6:                     # reduction
                oc = rnd.choice(("sum", "max", "min"))
                axis = rnd.choice((None, 0, 1)) if kind == "2d" \
                    else rnd.choice((None, 0))
                r = getattr(a, oc)(axis)
                if axis is None:               # scalar: broadcast back in
                    r = bh.zeros(shapes["1d"]) + r.broadcast_to(shapes["1d"])
                    pool.append((r, "1d", True))
                elif kind == "2d":
                    # feed the genuine row/col vector forward as a stride-0
                    # broadcast operand — vector-shaped reduction outputs
                    # are exactly where tiling bugs would hide
                    if axis == 0:              # row vector (n//8,)
                        r2 = r.broadcast_to(shapes["2d"])
                    else:                      # col vector (8,) -> column
                        r2 = r.broadcast_to((shapes["2d"][1], 8)).T
                    two = pick("2d")
                    if two is not None:
                        pool.append((two[0] + r2, "2d", True))
                else:
                    r = bh.zeros(shapes["1d"]) + r.broadcast_to(shapes["1d"])
                    pool.append((r, "1d", True))
            elif act == 7:                     # strided/partial view read
                if kind == "1d":
                    sl = rnd.choice((slice(0, None, 2), slice(1, None, 2),
                                     slice(1, -1), slice(None, n // 2)))
                    v = a[sl]
                    c = bh.zeros(shape)
                    c[0:v.shape[0]] = v        # partial write of the window
                else:
                    v = a[1:-1, :]
                    c = bh.zeros(shape)
                    c[1:-1, :] = v
                pool.append((c, kind, True))
            elif act == 8:                     # RMW partial write
                other = pick(kind)
                if kind == "1d":
                    a[n // 4: 3 * n // 4] = other[0][n // 4: 3 * n // 4] + 1.0
                else:
                    a[2:6, :] = other[0][2:6, :] * 0.5
            elif act == 9:                     # broadcast 1d row into 2d
                row = pick("1d")
                if row is not None:
                    r2 = row[0][0: n // 8].broadcast_to(shapes["2d"])
                    two = pick("2d")
                    if two is not None:
                        pool.append((two[0] + r2, "2d", True))
            elif act == 10 and kind == "2d":   # transpose read (gather path)
                sq = a[:, 0:8]
                pool.append((sq.T.copy().reshape(64), "none", True))
            elif act == 11:                    # explicit DEL
                if len(pool) > 2:
                    i = pool.index(ent)
                    pool.pop(i)
                    a.delete()
            elif act == 12 and kind == "2d" and rnd.random() < 0.5:
                m = a[:, 0:8]                  # opaque op: small matmul
                r = bh.matmul(m.T.copy(), m.copy())
                pool.append((r.reshape(64) % _MOD, "none", True))
            elif act == 14:                    # gather / take (indexed read)
                # table = a 1-D program array; indices = another program
                # array floored into [0, n) — selecting integer-valued
                # dyadics is exact, so gathers stay bitwise
                # partition-invariant like every other action
                tbl = pick("1d")
                if tbl is not None:
                    idx = bh.floor(bh.absolute(a) % float(n))
                    pool.append((bh.take(tbl[0], idx), kind, True))
            # other act values on mismatched kinds: no-op (keeps the action
            # stream aligned across replays regardless of branch outcomes)

        outs: List[np.ndarray] = []
        if materialize:
            for a, _, _ in pool:
                outs.append(a.numpy())
        for a, _, _ in pool:
            a._alive = False                   # no DELs after harvest
        return outs

    # -- public entry points --------------------------------------------
    def run(self, **runtime_kw) -> List[np.ndarray]:
        """Execute under a fresh runtime built from ``runtime_kw`` (on the
        CUDA card unless it names a ``device``) and return every live
        array materialized, in creation order."""
        from ..core.lazy import fresh_runtime
        with fresh_runtime(**runtime_kw) as rt:
            return self._build(rt, materialize=True)

    def run_current(self) -> List[np.ndarray]:
        """Execute against the *currently active* runtime (callers own the
        ``fresh_runtime`` context).  Repeated calls in one runtime replay a
        structurally-identical tape — merge-cache and executable-cache hits
        — which is how the calibration loop gets warm, timeable dispatches."""
        from ..core.lazy import get_runtime
        return self._build(get_runtime(), materialize=True)

    def record(self) -> List:
        """Record the program without executing; returns the tape.  Nothing
        runs, so the recording runtime sits on the CPU."""
        from ..core.lazy import fresh_runtime
        with fresh_runtime(device="cpu") as rt:
            self._build(rt, materialize=False)
            tape = list(rt.tape)
            rt.tape.clear()
        return tape


class IterativeProgram:
    """A seeded *iterative* lazy program: one randomly-drawn step body
    replayed ``steps`` times with carried state and a flush per step — the
    workload shape cross-flush loop fusion (DESIGN.md §16) detects and
    defers.

    The step recipe is drawn ONCE from the seed and replayed verbatim, so
    every step traces a structurally identical tape.  The recipe mixes the
    carry shapes the recurrence detector must prove safe: in-place partial
    writes (same base every step), fresh-chain carries (new base each step,
    old base deleted), loop-invariant reads, contracted temporaries,
    reductions fed back through RMW partial writes, and per-step quantized
    ``random`` draws (fresh trace-time salts each step — the loop path must
    reproduce them bit for bit from its stacked salt matrix).  Only the
    final state materializes; intermediate steps must never be observable.
    """

    def __init__(self, seed: int, *, steps: int = 9, n_ops: int = 6,
                 size: int = 64):
        self.seed = int(seed)
        self.steps = int(steps)
        self.n_ops = int(n_ops)
        self.size = max(64, int(size) - int(size) % 8)

    def run(self, **runtime_kw) -> List[np.ndarray]:
        """Run the program under a fresh runtime built from ``runtime_kw``
        (on the CUDA card unless it names a ``device``); returns the final
        ``g``, ``a`` and ``k``."""
        from ..core.lazy import fresh_runtime
        with fresh_runtime(**runtime_kw):
            return self.run_current()

    def run_current(self) -> List[np.ndarray]:
        """:meth:`run` against the *currently active* runtime (callers own
        the ``fresh_runtime`` context and can read its stats after)."""
        from ..core import lazy as bh
        rnd = random.Random(self.seed ^ 0x17E5A71)
        n = self.size
        shapes = {"1d": (n,), "2d": (8, n // 8)}
        # the step recipe: drawn once, replayed identically every step
        recipe = [(rnd.randrange(6), rnd.choice((0.5, 0.25, 2.0, 3.0, -1.5)))
                  for _ in range(self.n_ops)]
        g = bh.floor(bh.random(shapes["2d"]) * 16.0)
        a = bh.floor(bh.random(shapes["1d"]) * 16.0)
        k = bh.full(shapes["1d"], float(rnd.randrange(1, 7)))  # invariant
        bh.flush()
        for _step in range(self.steps):
            for act, c in recipe:
                if act == 0:           # in-place stencil update (RMW)
                    inner = (g[1:-1, :] + g[:-2, :] + g[2:, :]) * 0.25
                    g[1:-1, :] = bh.floor(inner)
                    inner.delete()
                elif act == 1:         # fresh-chain carry on `a`
                    b = bh.floor((a * c) % _MOD) + k
                    a.delete()
                    a = b
                elif act == 2:         # per-step RNG draw
                    r = bh.floor(bh.random(shapes["1d"]) * 16.0)
                    b = a + r
                    a.delete()
                    r.delete()
                    a = b
                elif act == 3:         # reduction fed back through RMW
                    s = g.sum(0)
                    a[0: n // 8] = bh.floor((s + a[0: n // 8]) % _MOD)
                    s.delete()
                elif act == 4:         # in-place whole-array update
                    a += k * c
                elif act == 5:         # where-mix into `g`, full write
                    m = a[0: n // 8].broadcast_to(shapes["2d"])
                    t = bh.where(g > m, g, m)
                    g[:, :] = t
                    t.delete()
            bh.flush()
        outs = [g.numpy(), a.numpy(), k.numpy()]
        for arr in (g, a, k):
            arr._alive = False         # no DELs after harvest
        return outs


#: grammar -> the hand-written kernel claimant that must claim >= 1 block
#: (moe is gather-dominated: no claimant, the comparison is the point)
_LM_CLAIMANTS = {"rmsnorm": "rmsnorm", "attention": "flash_attention",
                 "scan": "mamba_scan"}
#: grammars whose every row sum is exact (integer-valued leaves), so the
#: kernels' summation order cannot change a bit
EXACT_GRAMMARS = ("rmsnorm", "moe")


class LMProgram:
    """A seeded LM-shaped lazy program.

    Four grammars, chosen by ``seed % 4``, each tracing the op shapes the
    LM kernel claimants pattern-match — sized by the seed so the sweep
    covers many domains:

    * ``rmsnorm``    — residual add, sum-of-squares variance, the
      ``div→add(eps)→rsqrt→mul→mul`` scale chain (``rmsnorm`` claimant);
    * ``attention``  — scaled masked scores, ``where(-inf)``, the
      max / shifted-exp / sum / normalize softmax chain
      (``flash_attention`` claimant, two claimed reduction blocks);
    * ``moe``        — top-k expert routing: host-computed argsort
      indices, ``take`` gathers out of an expert table, gate-weighted
      combine (gathers stay on the torch floor — no claimant);
    * ``scan``       — a selective-scan step ``exp(dtA)*h + gate*u``
      with a trailing contraction (``mamba_scan`` claimant).

    Leaves are integer-valued float32 (``floor(u * 16) - 8``), so sums of
    squares and masked maxima are exact.
    """

    GRAMMARS = ("rmsnorm", "attention", "moe", "scan")

    def __init__(self, seed: int, *, size: int = 64):
        self.seed = int(seed)
        self.grammar = self.GRAMMARS[self.seed % 4]
        rnd = random.Random(self.seed ^ 0x1A57F00D)
        self.b = rnd.choice((1, 2))                   # batch
        self.s = rnd.choice((4, 8, 16))               # sequence
        self.d = max(8, min(128, int(size)))          # feature
        self.h = rnd.choice((1, 2, 4))                # heads
        self.n_exp = rnd.choice((4, 8))               # experts

    def _q16(self, rng, shape) -> np.ndarray:
        return (np.floor(rng.random(shape, dtype=np.float32) * 16.0)
                - 8.0).astype(np.float32)

    @property
    def row(self) -> int:
        """Length of the rows this program's reductions sum."""
        return self.s if self.grammar == "attention" else self.d

    def _trace(self, rt) -> List[np.ndarray]:
        from ..core import lazy as bh
        rng = np.random.default_rng(self.seed)
        b, s, d, h = self.b, self.s, self.d, self.h
        if self.grammar == "rmsnorm":
            x = rt.adopt(self._q16(rng, (b, s, d)))
            r = rt.adopt(self._q16(rng, (b, s, d)))
            g1 = rt.adopt(self._q16(rng, (1, 1, d)) / 16.0 + 1.0)
            y = x + r
            var = (y * y).sum(axis=-1)
            var_b = var.reshape(b, s, 1).broadcast_to((b, s, d))
            inv = bh.rsqrt(var_b / float(d) + 1e-6)
            out = y * inv * g1.broadcast_to((b, s, d))
            return [out.numpy()]
        if self.grammar == "attention":
            sc = rt.adopt(self._q16(rng, (b, h, s, s)))
            mask = rt.adopt(
                np.tril(np.ones((s, s), bool)).reshape(1, 1, s, s))
            neg = rt.adopt(np.full((1, 1, 1, 1), -1e30, np.float32))
            scm = bh.where(mask.broadcast_to(sc.shape), sc * 0.125, neg)
            m = scm.max(axis=-1)
            e = bh.exp(scm - m.reshape(b, h, s, 1).broadcast_to(scm.shape))
            z = e.sum(axis=-1)
            p = e / z.reshape(b, h, s, 1).broadcast_to(e.shape)
            return [p.numpy()]
        if self.grammar == "moe":
            t, k = b * s, 2
            logits = self._q16(rng, (t, self.n_exp)) \
                + rng.random((t, self.n_exp), dtype=np.float32) * 0.5
            topk = np.argsort(-logits, axis=1)[:, :k]     # host-side top-k
            picked = np.take_along_axis(logits, topk, axis=1)
            ex = np.exp(picked - picked.max(1, keepdims=True))
            gates = (ex / ex.sum(1, keepdims=True)).astype(np.float32)
            table = rt.adopt(self._q16(rng, (self.n_exp, d)))
            x = rt.adopt(self._q16(rng, (t, d)))
            out = None
            for j in range(k):
                idx = rt.adopt(topk[:, j].astype(np.int32))
                gate = rt.adopt(np.ascontiguousarray(gates[:, j:j + 1]))
                expert = bh.take(table, idx, axis=0)      # (t, d) gather
                term = x * expert * gate.broadcast_to((t, d))
                out = term if out is None else out + term
            return [out.numpy()]
        # scan: one selective-scan step + contraction
        dt_a = rt.adopt(-(self._q16(rng, (b, s, d)) / 16.0 + 0.5))
        hid = rt.adopt(self._q16(rng, (b, s, d)))
        upd = rt.adopt(self._q16(rng, (b, s, d)))
        gate = rt.adopt(self._q16(rng, (b, s, d)) / 16.0)
        h_new = bh.exp(dt_a) * hid + gate * upd
        y = (h_new * gate).sum(axis=-1)
        out = h_new + y.reshape(b, s, 1).broadcast_to((b, s, d))
        return [h_new.numpy(), out.numpy()]

    def run(self, **runtime_kw) -> List[np.ndarray]:
        from ..core.lazy import fresh_runtime
        with fresh_runtime(**runtime_kw) as rt:
            return self._trace(rt)


def _assert_bitwise(ref: Sequence[np.ndarray], got: Sequence[np.ndarray],
                    label: str) -> None:
    assert len(ref) == len(got), f"{label}: {len(ref)} vs {len(got)} outputs"
    for i, (r, g) in enumerate(zip(ref, got)):
        assert r.dtype == g.dtype and r.shape == g.shape, \
            f"{label}: output {i} meta {r.dtype}{r.shape} vs {g.dtype}{g.shape}"
        if r.tobytes() != g.tobytes():
            bad = int(np.flatnonzero(r.reshape(-1) != g.reshape(-1))[0])
            raise AssertionError(
                f"{label}: output {i} differs at flat index {bad}: "
                f"{r.reshape(-1)[bad]!r} vs {g.reshape(-1)[bad]!r}")


def check_graph(seed: int, *, n_actions: int = 20, size: int = 64) -> None:
    """Staged graph builder == O(V²) reference oracle, edge for edge."""
    from ..core import build_graph, build_graph_reference
    tape = TapeProgram(seed, n_actions=n_actions, size=size).record()
    a = build_graph(list(tape))
    b = build_graph_reference(list(tape))
    assert a.dep_out == b.dep_out, f"seed {seed}: E_d (out) differs"
    assert a.dep_in == b.dep_in, f"seed {seed}: E_d (in) differs"
    assert a.fuse_forbidden == b.fuse_forbidden, f"seed {seed}: E_f differs"


def check_exec(seed: int, *, n_actions: int = 20, size: int = 64,
               device=None) -> None:
    """Fused (greedy; torch and triton backend stacks) == unfused singleton
    torch floor, bitwise, on ``device`` (the CUDA card unless given; on the
    CPU the triton stack runs its kernels' plain versions)."""
    prog = TapeProgram(seed, n_actions=n_actions, size=size, exact=True)
    ref = prog.run(algorithm="singleton", backend="torch", device=device)
    for algorithm, backend in (("greedy", "torch"), ("greedy", "triton")):
        got = prog.run(algorithm=algorithm, backend=backend, device=device)
        _assert_bitwise(ref, got,
                        f"seed {seed} [{algorithm}/{backend} vs singleton]")


def check_loop(seed: int, *, n_actions: int = 6, size: int = 64,
               steps: int = 9, device=None) -> None:
    """Loop-fused steady-state execution == per-flush execution, bitwise.

    A small threshold/unroll (2/4) forces the interesting transitions in
    one program: per-flush warmup, deferral, a capacity drain mid-run AND a
    tail drain at the final materialization.  Checked on both the torch
    and the triton backend stacks (the loop body composes whatever
    per-block backends the lower stage picked), on ``device`` (the CUDA
    card unless given, where a drain replays a CUDA graph)."""
    prog = IterativeProgram(seed, steps=steps, n_ops=n_actions, size=size)
    for backend in ("torch", "triton"):
        ref = prog.run(loop_fusion=False, backend=backend, device=device)
        got = prog.run(loop_fusion=True, loop_threshold=2, loop_unroll=4,
                       backend=backend, device=device)
        _assert_bitwise(ref, got,
                        f"seed {seed} [{backend} loop-fused vs per-flush]")


def check_lm(seed: int, *, size: int = 64, device="cpu") -> None:
    """The ``lm`` stack against the torch floor, under the SAME partition.

    Both runs use greedy/bohrium, so the two stacks lower the identical
    block sequence.  On the CPU the claimants run the row-replay kernel's
    plain version, made of the floor's own ops, so the results must be bit
    for bit equal.  On a card they run the kernel: bitwise on the grammars
    whose row sums are exact (:data:`EXACT_GRAMMARS`); elsewhere a Triton
    tree sum and the floor's ``sum(-1)`` round in other orders, so the
    results are held to ``row * eps32 * max|ref|`` (the summation error
    bound for a row of that length).  For the grammars with a matching
    claimant the check also asserts the claim happened — a silently
    declining matcher would otherwise turn this into floor vs floor."""
    from ..core.lazy import fresh_runtime
    prog = LMProgram(seed, size=size)
    kw = dict(algorithm="greedy", cost_model="bohrium", device=device,
              loop_fusion=False)
    ref = prog.run(backend="torch", **kw)
    with fresh_runtime(backend="lm", **kw) as rt:
        got = prog._trace(rt)
        blocks = dict(rt.executor.stats.get("backend_blocks", {}))
    label = f"seed {seed} [lm/{prog.grammar} vs torch on {device}]"
    if str(device) == "cpu" or prog.grammar in EXACT_GRAMMARS:
        _assert_bitwise(ref, got, label)
    else:
        eps = float(np.finfo(np.float32).eps)
        for r, g in zip(ref, got):
            tol = prog.row * eps * max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=label)
    claimant = _LM_CLAIMANTS.get(prog.grammar)
    if claimant is not None:
        assert blocks.get(claimant, 0) >= 1, (
            f"seed {seed}: grammar {prog.grammar!r} never exercised the "
            f"{claimant!r} claimant (backend_blocks={blocks})")


def serve_recipe(seed: int, *, tenants: int = 4, requests: int = 2,
                 size: int = 64) -> Tuple[List[int], List[np.ndarray],
                                          List[int]]:
    """The seeded draws of ``check_serve`` (the reference's, in its order):
    one :class:`TapeProgram` seed per tenant (phase 1), one data array per
    tenant and one request seed per round (phase 2)."""
    rnd = random.Random(seed ^ 0x5EABE17)
    prog_seeds = [rnd.randrange(1_000_000) for _ in range(tenants)]
    rnd.shuffle(prog_seeds)
    npr = np.random.default_rng(seed)
    datas = [np.floor(npr.random(size) * 16.0) for _ in range(tenants)]
    rseeds = [rnd.randrange(1_000_000) for _ in range(requests)]
    return prog_seeds, datas, rseeds


def serve_request(bh, rseed: int, data: np.ndarray, n_actions: int):
    """``check_serve``'s request function for lazy module ``bh`` (the
    port's, or the JAX package's for the cross-package check): a seeded
    chain over the tenant's data that returns its lazy result."""
    def fn():
        r = random.Random(rseed)
        a = bh.asarray(data)
        x = a
        for _ in range(n_actions):
            act = r.randrange(5)
            if act == 0:
                x = bh.floor((x * r.choice((0.5, 2.0, 3.0))) % _MOD)
            elif act == 1:
                x = x + float(r.randrange(-4, 5))
            elif act == 2:
                x = bh.maximum(x, a)
            elif act == 3:
                x = x + bh.floor(bh.random(x.shape) * 8.0)
            else:
                x = bh.where(x > a, x, a)
        return x
    return fn


#: seconds a check_serve thread may take before the check fails
JOIN_TIMEOUT_S = 120.0


def _run_threads(n: int, target, label: str) -> None:
    """Run ``target(i)`` on ``n`` threads and join each with a timeout: a
    worker's exception or a join that times out fails the check."""
    import threading
    errors: List = []

    def wrap(i: int) -> None:
        try:
            target(i)
        except BaseException as e:      # noqa: BLE001 — re-raised below
            errors.append((i, e))

    threads = [threading.Thread(target=wrap, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_TIMEOUT_S)
    hung = [i for i, t in enumerate(threads) if t.is_alive()]
    if hung:
        raise AssertionError(f"{label}: threads {hung} still running after "
                             f"{JOIN_TIMEOUT_S}s")
    if errors:
        raise AssertionError(f"{label} failed: {errors[0]!r}") \
            from errors[0][1]


def check_serve(seed: int, *, tenants: int = 4, requests: int = 2,
                n_actions: int = 8, size: int = 64, device="cpu") -> dict:
    """Concurrent serving == serial execution, bitwise (DESIGN.md §18).

    Phase 1 — **concurrent sessions**: a seeded shuffle assigns ``tenants``
    distinct :class:`TapeProgram`\\ s to per-tenant sessions of ONE shared
    runtime; all tenants run at once from their own threads (barrier
    start, interleaved flushes against the shared merge and executable
    caches) and every tenant's outputs must match its own serial
    fresh-runtime run bit for bit.

    Phase 2 — **micro-batching**: every tenant submits the same seeded
    request recipe (same structure, private data, per-session RNG salts)
    through a batching :class:`~repro_torch.core.serve.Server`
    concurrently; the reference is a batching-off server driven serially.
    The batched dispatch must be bitwise identical to the per-session
    flush path — ``random`` draws included, which read each request's key
    words.  Runs on ``device``; returns both phases' outputs
    (``"sessions"``: per tenant, ``"served"``: per (tenant, round))."""
    import threading

    from ..core import lazy as bh
    from ..core.lazy import Runtime
    from ..core.serve import Server

    prog_seeds, datas, rseeds = serve_recipe(seed, tenants=tenants,
                                             requests=requests, size=size)

    # -- phase 1: N threads x N structurally-distinct programs ----------
    progs = [TapeProgram(s, n_actions=n_actions, size=size, exact=True)
             for s in prog_seeds]
    refs = [p.run(device=device) for p in progs]
    rt = Runtime(loop_fusion=False, device=device)
    sessions = [rt.session() for _ in range(tenants)]
    results: List = [None] * tenants
    barrier = threading.Barrier(tenants)

    def worker(i: int) -> None:
        barrier.wait()
        with sessions[i].activate():
            results[i] = progs[i].run_current()

    _run_threads(tenants, worker, f"seed {seed}: concurrent session")
    for i in range(tenants):
        _assert_bitwise(refs[i], results[i],
                        f"seed {seed} [tenant {i} concurrent vs serial]")

    # -- phase 2: batched server vs serial batching-off server ----------
    ref_srv = Server(batching=False, device=device)
    refs2 = {(i, r): ref_srv.submit(i, serve_request(bh, rs, datas[i],
                                                     n_actions))
             for r, rs in enumerate(rseeds) for i in range(tenants)}
    srv = Server(window_s=0.25, max_batch=tenants, device=device)
    out2: dict = {}
    barrier2 = threading.Barrier(tenants)

    def serve_worker(i: int) -> None:
        for r, rs in enumerate(rseeds):
            barrier2.wait()
            out2[(i, r)] = srv.submit(i, serve_request(bh, rs, datas[i],
                                                       n_actions))

    _run_threads(tenants, serve_worker, f"seed {seed}: batched serve")
    for k in refs2:
        _assert_bitwise([refs2[k]], [out2[k]],
                        f"seed {seed} [tenant/request {k} batched vs serial]")
    batched = srv.metrics.counter("serve.batched_requests").get()
    assert batched > 0, \
        f"seed {seed}: no request ever coalesced (window too small?)"
    return {"sessions": results, "served": out2}


CHECKS = {"graph": check_graph, "exec": check_exec, "loop": check_loop,
          "lm": check_lm, "serve": check_serve}


def check_seed(seed: int, checks: Sequence[str] = ("graph", "exec"),
               device=None, **kw) -> None:
    """Run the named differential checks for one seed (raises on failure);
    the ones that execute run on ``device`` (the CUDA card unless given)."""
    for name in checks:
        if name == "graph":
            check_graph(seed, n_actions=kw.get("n_actions", 20),
                        size=kw.get("size", 64))
        elif name == "exec":
            check_exec(seed, n_actions=kw.get("n_actions", 20),
                       size=kw.get("size", 64), device=device)
        elif name == "loop":
            check_loop(seed, n_actions=max(3, kw.get("n_actions", 20) // 3),
                       size=kw.get("size", 64), device=device)
        elif name == "lm":
            check_lm(seed, size=kw.get("size", 64),
                     device="cuda" if device is None else device)
        elif name == "serve":
            check_serve(seed, n_actions=max(4, kw.get("n_actions", 20) // 2),
                        size=kw.get("size", 64),
                        device="cuda" if device is None else device)
        else:
            raise ValueError(f"unknown check {name!r}; have {sorted(CHECKS)}")


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    import sys
    import time
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=200,
                    help="number of consecutive seeds to sweep")
    ap.add_argument("--start", type=int, default=0, help="first seed")
    ap.add_argument("--only", type=int, default=None,
                    help="run a single seed (failure repro)")
    ap.add_argument("--actions", type=int, default=20,
                    help="generator actions per program")
    ap.add_argument("--size", type=int, default=64,
                    help="1-D working-shape elements")
    ap.add_argument("--checks", default="graph,exec,loop",
                    help=f"comma list from {sorted(CHECKS)}")
    ap.add_argument("--device", default=None,
                    help="where the checks run (default: the CUDA card)")
    args = ap.parse_args(argv)
    checks = [c for c in args.checks.split(",") if c]
    seeds = ([args.only] if args.only is not None
             else list(range(args.start, args.start + args.n)))
    dev = f" --device {args.device}" if args.device else ""
    t0 = time.time()
    for i, seed in enumerate(seeds):
        try:
            check_seed(seed, checks, device=args.device,
                       n_actions=args.actions, size=args.size)
        except Exception:
            print(f"\nFAIL seed={seed}  (checks: {','.join(checks)})",
                  file=sys.stderr)
            print("repro: PYTHONPATH=src python -m repro_torch.testing.tapegen "
                  f"--only {seed} --actions {args.actions} "
                  f"--size {args.size} --checks {','.join(checks)}{dev}",
                  file=sys.stderr, flush=True)
            raise
        if (i + 1) % 25 == 0:
            print(f"  …{i + 1}/{len(seeds)} seeds ok "
                  f"({time.time() - t0:.0f}s)", flush=True)
    print(f"tapegen: {len(seeds)} seeds x [{','.join(checks)}] "
          f"differential-identical ({time.time() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
