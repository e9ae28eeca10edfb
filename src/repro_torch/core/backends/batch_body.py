"""Batched flush execution for cross-request micro-batching (DESIGN.md
§18) — the port of ``repro/core/backends/batch_body.py``.

When B concurrent serving requests trace structurally identical tapes
inside one coalescing window, the server runs them as ONE dispatch: the
planned flush body — every fused block, composed exactly as the per-flush
dispatch engine runs it — is mapped by ``torch.func.vmap`` over a leading
request axis (the reference's ``jax.vmap``), so B requests cost one
executable-cache probe and one pass of PyTorch calls over ``(B, size)``
tensors instead of B flushes.

The blocks are the floor's (``executor.make_block_fn``) in their
``batched`` form: a window write is one out-of-place ``index_put`` (vmap
refuses the in-place assignment into a base the block allocates) and a
strided read an index gather, with the same values.  Each request's
``random`` draws read its own row of a ``(B, n_rand, 2)`` key-word tensor
(``prng.key_words`` of its salts, computed on the host), so a batched
request draws exactly what its solo flush draws.  The server batches only
plans whose every work block lowers to the floor (its rule, after the
reference's ``server.py``); a block lowered anywhere else is refused here,
and a floor builder that fails raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def build_batch_fn(tape: Sequence, plans: Sequence,
                   tape_inputs: Tuple[int, ...],
                   tape_outputs: Tuple[int, ...], ctx):
    """Compose a planned flush into one batched multi-request call.

    Returns ``(fn, n_rand)`` where ``fn(inputs, words) -> outputs`` maps a
    tuple of ``(B, size)`` stacked tape-input buffers and a ``(B, n_rand,
    2)`` int64 key-word tensor to a tuple of ``(B, size)`` stacked
    tape-output buffers (canonical ``tape_io`` order on all three).
    ``words`` always carries the batch axis — even with ``n_rand == 0`` —
    so vmap has a mapped operand on tapes with no inputs."""
    import torch

    from ..executor import make_block_fn

    work = []
    off = 0
    for p in plans:
        if not p.has_work:
            continue
        name = p.lowering.backend if p.lowering is not None else "torch"
        if name != "torch":
            raise ValueError(f"a batched flush runs on the torch floor; "
                             f"this plan lowers a block to {name!r}")
        ops = [tape[i] for i in p.op_indices]
        fn, ins, outs = make_block_fn(ops, seed=ctx.seed, device=ctx.device,
                                      batched=True)
        assert tuple(ins) == p.inputs and tuple(outs) == p.outputs
        n_rand = sum(1 for op in ops if op.opcode == "random")
        work.append((fn, p.inputs, p.outputs, off, n_rand))
        off += n_rand

    def flush_fn(inputs, words_row):
        env = dict(zip(tape_inputs, inputs))
        for fn, ins, outs, o, n in work:
            vals = fn(*[env[u] for u in ins], words_row[o:o + n])
            env.update(zip(outs, vals))
        return tuple(env[u] for u in tape_outputs)

    batched = torch.func.vmap(flush_fn, in_dims=(0, 0))

    def run(inputs, words):
        # an output no request's data reaches comes back from vmap as one
        # row expanded B times: give every request its own elements
        return tuple(o if o.stride(0) else o.contiguous()
                     for o in batched(tuple(inputs), words))

    return run, off
