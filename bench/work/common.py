"""The work that a served batch needs, counted from a configuration's
published widths and the cell's shapes, not from what the port happens to
do: so a sparser or leaner implementation raises the shares read against
it, and no honest one pushes them past 100%.

Model FLOPs are counted per token handed to the model, pads included
(the port's semantics attend and route them): two a multiply-add of every
active weight (attention's or Mamba's projections, the MLP, the router,
the top-k experts of each MoE layer, never the others), attention's
causal score and value products (``4 · head_dim`` a query-key pair a
query head), and the unembedding once a row a step (a prefill needs the
last position's logits only).  Elementwise work (norms, the scan, the
conv, softmaxes) is left out of the FLOPs.

Decode bytes are what one step has to move: every non-expert weight once
(the embedding's rows of this step's tokens only), each expert that this
step's tokens are routed to once, the KV cache up to each row's length
read and one position written, and each Mamba layer's conv and SSM state
read and written.  The routed experts of a step are the distinct experts
its tokens chose, per MoE layer, as the reference routes them (the port
routes inside a CUDA graph and exposes no count of its own): the harness
hands them in (:meth:`Work.routed_experts`).  Weights are bf16 (2 bytes),
the SSM state float32.

A configuration's file ``work/<config>.py`` gives :class:`Work` its layer
kinds and widths from its published keys."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

BF16 = 2
F32 = 4


@dataclass(frozen=True)
class Work:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    kinds: Tuple[Tuple[str, str], ...]      # (mixer, ffn) per layer
    d_ff: int = 0
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    mamba: Optional[dict] = None            # d_state, d_conv, expand, dt_rank

    # -- weights -----------------------------------------------------------
    def mixer_weights(self, mixer: str) -> int:
        d = self.d_model
        if mixer == "attention":
            return d * self.head_dim * (2 * self.n_heads + 2 * self.n_kv_heads)
        m = self.mamba
        di = m["expand"] * d
        return (d * 2 * di + di * (m["dt_rank"] + 2 * m["d_state"])
                + m["dt_rank"] * di + di * d)

    def expert_weights(self) -> int:
        return 3 * self.d_model * self.d_expert

    def active_weights(self) -> int:
        """Weights a token multiplies, the unembedding left out."""
        n = 0
        for mixer, ffn in self.kinds:
            n += self.mixer_weights(mixer)
            n += (self.d_model * self.n_experts
                  + self.top_k * self.expert_weights()) if ffn == "moe" \
                else 3 * self.d_model * self.d_ff
        return n

    def n_attention(self) -> int:
        return sum(m == "attention" for m, _ in self.kinds)

    # -- FLOPs -------------------------------------------------------------
    def attention_flops(self, queries: int, keys_before: int) -> int:
        """Score and value products of ``queries`` consecutive queries
        after ``keys_before`` earlier positions, causal, all layers, one
        row: each query attends itself and every earlier position."""
        pairs = queries * keys_before + queries * (queries + 1) // 2
        return 4 * self.head_dim * self.n_heads * pairs * self.n_attention()

    def prefill_flops(self, batch: int, seq: int) -> int:
        return batch * (2 * seq * self.active_weights()
                        + self.attention_flops(seq, 0)
                        + 2 * self.d_model * self.vocab_size)

    def decode_flops(self, batch: int, position: int) -> int:
        """One decode step whose token sits at ``position`` (0-based) in
        every row."""
        return batch * (2 * self.active_weights()
                        + self.attention_flops(1, position)
                        + 2 * self.d_model * self.vocab_size)

    # -- decode bytes -------------------------------------------------------
    def routed_experts(self, routes) -> np.ndarray:
        """``(steps, MoE layers)`` distinct experts a step: ``routes`` holds
        each MoE layer's ``(rows, steps, k)`` chosen experts (a tensor or
        an array), every row of the batch."""
        out = np.zeros((np.shape(routes[0])[1] if routes else 0,
                        len(routes)), dtype=np.int64)
        for l, idx in enumerate(routes):
            idx = np.asarray(idx.cpu() if hasattr(idx, "cpu") else idx)
            hit = np.zeros((idx.shape[1], self.n_experts), dtype=bool)
            for r in range(idx.shape[0]):
                hit[np.arange(idx.shape[1])[:, None], idx[r]] = True
            out[:, l] = hit.sum(-1)
        return out

    def decode_bytes(self, batch: int, position: int,
                     routed: Sequence[float] = ()) -> float:
        """The bytes of one decode step whose token sits at ``position`` in
        every row; ``routed``: the distinct routed experts of each MoE
        layer, in layer order."""
        if len(routed) != sum(f == "moe" for _, f in self.kinds):
            raise ValueError("decode bytes need each MoE layer's routed "
                             "experts")
        d = self.d_model
        n = 0.0
        moe = iter(routed)
        for mixer, ffn in self.kinds:
            n += BF16 * (self.mixer_weights(mixer) + 2 * d)   # + two norm gains
            if mixer == "attention":
                # k and v: every earlier position read, this one written
                n += BF16 * 2 * batch * (position + 1) * self.n_kv_heads \
                    * self.head_dim
            else:
                m = self.mamba
                di = m["expand"] * d
                # conv taps and bias, dt bias; A and D in float32
                n += BF16 * di * (m["d_conv"] + 2) + F32 * di * (m["d_state"]
                                                               + 1)
                n += 2 * batch * di * (BF16 * (m["d_conv"] - 1)
                                       + F32 * m["d_state"])
            if ffn == "moe":
                n += BF16 * (d * self.n_experts + next(moe)
                             * self.expert_weights())
            else:
                n += BF16 * 3 * d * self.d_ff
        n += BF16 * (batch * d + d + d * self.vocab_size)  # rows, norm, head
        return n

    # -- kernels -----------------------------------------------------------
    def b3_prefill(self, batch: int, seq: int) -> Tuple[int, int]:
        """``(flops, bytes)`` of one causal B3 call over a prompt: the
        causal pairs' score and value products, q, k and v read and o
        written once, bf16."""
        pairs = batch * self.n_heads * seq * (seq + 1) // 2
        nbytes = BF16 * batch * seq * self.head_dim * (
            2 * self.n_heads + 2 * self.n_kv_heads)
        return 4 * self.head_dim * pairs, nbytes
