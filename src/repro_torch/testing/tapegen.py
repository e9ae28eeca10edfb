"""Seeded LM-shaped lazy programs and their differential check — the port of
``LMProgram`` and ``check_lm`` from ``repro/testing/tapegen.py``.

:class:`LMProgram` draws the same shapes and the same numpy leaves as the
reference for the same seed (``random.Random(seed ^ 0x1A57F00D)`` for the
shapes, ``np.random.default_rng(seed)`` for the leaves), and records the
same op sequence against ``repro_torch.core.lazy``.  So one seed is one
program in both packages, and the port's tests compare the two.

:func:`check_lm` runs a program under the ``lm`` stack and under the torch
floor and compares them.  The rest of the reference's tapegen (the
``TapeProgram`` grammar and its graph/exec/loop/serve/dist checks) is
still to be ported (ROADMAP A3).
"""

from __future__ import annotations

import random
from typing import List, Sequence

import numpy as np

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
    kw = dict(algorithm="greedy", cost_model="bohrium", device=device)
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
