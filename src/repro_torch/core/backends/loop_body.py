"""The loop body of cross-flush loop fusion (DESIGN.md §16), on PyTorch: the
port of ``repro/core/backends/loop_body.py``.

A steady-state iterative program re-flushes a structurally identical tape
every timestep.  Once the recurrence detector (``core/loop.py``) proves the
structure repeats with a consistent carried-state mapping, the whole flush
— every fused block, on whatever backend the lower stage picked for it —
is composed into ONE iteration, and a drain runs that iteration ``n``
times: carried bases become loop state and per-iteration planning and
Python dispatch disappear.

The composition reuses the per-block backend builders verbatim, so a
loop-fused run performs the same operations in the same order as the
per-flush run and its results are bit for bit the per-flush run's.  A
builder that fails raises: a block a kernel cannot take was declined at
claim time with its slug, as on the per-flush path, so nothing here swaps
in another backend.

**On a CUDA device the iteration is one CUDA graph**, captured at the first
drain and replayed once an iteration; its addresses are fixed, so the body
owns *static* buffers:

* one per state slot (a tape-level output, canonical order).  The graph
  reads the carried inputs from them and ends with a ``copy_`` back into a
  slot whose block did not write in place — the fused-block kernel writes
  a read-modify-write base into its own storage, so a stencil's write-back
  needs none;
* one per loop invariant, read only.

**Random draws.**  A captured launch keeps its arguments, so the per-flush
kernel's key words (launch arguments) would redraw the first iteration's
numbers at every replay.  The body instead holds a device key table,
``(unroll, n_rand, 2)`` ``uint32``: a drain fills the rows of its
iterations with one host-to-device copy and resets a device counter
beside it, each draw reads its two words at the counter's row (the
kernel's loop form, the floor's ``prng.uniform_from``), and the
iteration's last step advances the counter.  The CPU runs the iteration
eagerly ``n`` times through the same table and counter, so the CPU tests
cover what the card's graph does.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np
import torch

from .. import prng


@dataclass(frozen=True)
class _Work:
    """One work block of the body: its built function, its plan, whether
    its backend takes a ``reuse`` grant, where its draws start in a key
    row, how many it makes, and the bases it deletes."""

    fn: object
    plan: object
    donates: bool
    off: int
    n_rand: int
    dels: Tuple[int, ...]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class LoopBody:
    """One steady-state iteration over static buffers (module docstring).

    :meth:`allocate` makes the static state and invariant buffers,
    :meth:`bind` seeds them for a drain, :meth:`run` runs the drain's
    iterations.  ``captures`` and ``replays``
    count the CUDA graph's captures (one, at the first drain) and
    replays."""

    def __init__(self, work: List[_Work], input_sources: Tuple,
                 tape_inputs: Tuple[int, ...], tape_outputs: Tuple[int, ...],
                 device: torch.device, unroll: int, n_rand: int):
        self.work = work
        self.input_sources = input_sources
        self.tape_inputs = tape_inputs
        self.tape_outputs = tape_outputs
        self.device = torch.device(device)
        self.unroll = unroll
        self.n_rand = n_rand
        inv = [j for j, s in enumerate(input_sources) if s[0] == "inv"]
        self._inv_index = {j: k for k, j in enumerate(inv)}
        self.keys = prng.KeyTable(
            torch.zeros((unroll, n_rand, 2), dtype=torch.uint32,
                        device=self.device),
            torch.zeros(1, dtype=torch.int32, device=self.device))
        self._host_keys = None       # pinned staging of the key table
        self._keys_copied = None     # event after the last key copy
        self.slots: List[torch.Tensor] = []
        self.inv: List[torch.Tensor] = []
        self.graph = None
        self._copy_backs = 0         # copies an iteration ends with
        self.captures = self.replays = 0

    # -- a drain --------------------------------------------------------
    def allocate(self, state: Sequence[torch.Tensor],
                 invariants: Sequence[torch.Tensor]) -> None:
        """Make the static buffers, like the first drain's buffers."""
        if not self.slots:
            self.slots = [torch.empty_like(b) for b in state]
            self.inv = [torch.empty_like(b) for b in invariants]

    def bind(self, state: Sequence[torch.Tensor],
             invariants: Sequence[torch.Tensor]) -> int:
        """Seed the static buffers (:meth:`allocate` first): a state buffer
        is copied in unless it already is its slot, an invariant unless it
        already is its static buffer.  Returns the copies."""
        copies = 0
        slot_of = {_storage(b): q for q, b in enumerate(self.slots)}
        # a state that shares another slot's storage is read before any
        # slot is written
        src = []
        for q, b in enumerate(state):
            if b.data_ptr() == self.slots[q].data_ptr():
                src.append(None)
            elif slot_of.get(_storage(b), q) != q:
                src.append(b.clone())
                copies += 1
            else:
                src.append(b)
        for q, b in enumerate(src):
            if b is not None:
                self.slots[q].copy_(b)
                copies += 1
        for k, b in enumerate(invariants):
            if b.data_ptr() != self.inv[k].data_ptr():
                self.inv[k].copy_(b)
        return copies

    def run(self, salts: Sequence[Sequence[int]], seed: int) -> int:
        """Run one iteration per row of ``salts`` (each row the salts of
        the iteration's draws, body order) on the bound buffers; returns
        the copies into state buffers the iterations made."""
        n = len(salts)
        if n > self.unroll:
            raise ValueError(f"{n} iterations exceed the unroll {self.unroll}")
        self._load_keys(salts, seed)
        if self.device.type != "cuda":
            self.keys.ctr.zero_()
            return sum(self._step(self.slots) for _ in range(n))
        if self.graph is None:
            self._capture()          # its warm-up advances the counter
        self.keys.ctr.zero_()
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        return n * self._copy_backs

    def _load_keys(self, salts, seed: int) -> None:
        """Write the drain's key words into the table's first rows: one
        host-to-device copy, from pinned memory on a card (whose previous
        copy must have landed before the staging is rewritten)."""
        if not self.n_rand or not salts:
            return
        rows = np.array([[prng.key_words(seed, s) for s in row]
                         for row in salts], dtype=np.uint32)
        table = self.keys.table[:len(rows)]
        if self.device.type != "cuda":
            table.copy_(torch.from_numpy(rows))
            return
        if self._host_keys is None:
            self._host_keys = torch.empty(self.keys.table.shape,
                                          dtype=torch.uint32,
                                          pin_memory=True)
        if self._keys_copied is not None:
            self._keys_copied.synchronize()
        host = self._host_keys[:len(rows)]
        host.copy_(torch.from_numpy(rows))
        table.copy_(host, non_blocking=True)
        self._keys_copied = torch.cuda.Event()
        self._keys_copied.record()

    def _capture(self) -> None:
        """Capture one iteration over the static buffers, after one eager
        warm-up iteration (it builds and compiles what the iteration
        launches) over scratch copies of the state, so the warm-up leaves
        the state as it was.  A capture that fails raises."""
        from ..cuda_graph import capture
        scratch = [b.clone() for b in self.slots]
        self.graph, self._copy_backs = capture(
            self.device, lambda: self._step(scratch),
            lambda: self._step(self.slots))
        self.captures += 1

    # -- one iteration --------------------------------------------------
    def _step(self, slots: Sequence[torch.Tensor]) -> int:
        """One iteration with the carried inputs read from ``slots``: every
        work block in schedule order, then each carried output copied into
        its slot where it does not lie there, then the key counter
        advanced.  Returns the copies made."""
        env: Dict[int, torch.Tensor] = {}
        for u, (kind, idx) in zip(self.tape_inputs, self.input_sources):
            env[u] = (slots[idx] if kind == "carry"
                      else self.inv[self._inv_index[idx]])
        for w in self.work:
            ins = [env[u] for u in w.plan.inputs]
            kw = {"reuse": _grant(w.plan, ins, env)} if w.donates else {}
            keys = self.keys.at(w.off) if w.n_rand else ()
            for u, b in zip(w.plan.outputs, w.fn(*ins, keys, **kw)):
                env[u] = b
            for u in w.dels:
                env.pop(u, None)
        pend = [(q, env[u]) for q, u in enumerate(self.tape_outputs)
                if env[u].data_ptr() != slots[q].data_ptr()]
        # a value lying in a slot another copy overwrites is read first
        written = {_storage(slots[q]) for q, _ in pend}
        held = [b.clone() if _storage(b) in written else b for _, b in pend]
        for (q, _), b in zip(pend, held):
            slots[q].copy_(b)
        self.keys.ctr.add_(1)
        return len(pend) + sum(1 for (_, a), b in zip(pend, held)
                               if a is not b)


def _grant(plan, ins: Sequence[torch.Tensor],
           env: Dict[int, torch.Tensor]) -> FrozenSet[int]:
    """``BlockExecutor._grant`` inside the body: the donatable inputs and
    those of a base the block rewrites, whose storage no other live value
    of the iteration holds."""
    refs = Counter(_storage(b) for b in env.values())
    outs = set(plan.outputs)
    return frozenset(k for k, u in enumerate(plan.inputs)
                     if (k in plan.donatable or u in outs)
                     and refs[_storage(ins[k])] == 1)


def build_loop_fn(tape: Sequence, plans: Sequence, input_sources: Tuple,
                  tape_inputs: Tuple[int, ...],
                  tape_outputs: Tuple[int, ...], ctx,
                  unroll: int) -> LoopBody:
    """Compose a planned flush into a steady-state :class:`LoopBody`.

    ``input_sources[j]`` says where input position ``j`` of each iteration
    comes from: ``("carry", q)`` reads state slot ``q`` (the previous
    iteration's output ``q``), ``("inv", k)`` the invariant of input
    position ``k``.  Blocks build on the backend their
    ``BlockPlan.lowering`` decision names, through the same builders as
    the per-flush path; a builder that fails raises.  ``unroll`` is the
    most iterations one drain runs."""
    from . import get_backend
    work: List[_Work] = []
    off = 0
    for p in plans:
        if not p.has_work:
            continue
        ops = [tape[i] for i in p.op_indices]
        be = get_backend(p.lowering.backend if p.lowering is not None
                         else "torch")
        n_rand = sum(1 for op in ops
                     if not op.is_system() and op.opcode == "random")
        dels = tuple(b.uid for op in ops for b in op.del_bases)
        work.append(_Work(be.build(ops, p, ctx), p, be.donates, off, n_rand,
                          dels))
        off += n_rand
    return LoopBody(work, tuple(input_sources), tuple(tape_inputs),
                    tuple(tape_outputs), ctx.device, unroll, off)
