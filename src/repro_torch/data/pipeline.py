"""Deterministic synthetic LM data pipeline: the port's copy of
``repro/data/pipeline.py`` (pure numpy, so ``batch_at`` gives the JAX
package's batches bit for bit).

Step-indexed (stateless) generation: batch(step) is a pure function of
(seed, step), so restart-after-failure resumes bit-identically from the
checkpointed step — the data side of fault tolerance.  Tokens follow a
Zipf-ish distribution with document boundaries, packed to full sequences.
On a real cluster each host generates only its shard (host_id striding);
here the host count is 1 but the code path is the sharded one.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from ..models.config import ModelConfig


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 1234, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b = self.batch // self.n_hosts
        v = self.cfg.vocab_size
        # zipf-ish unigram over a 4k-head vocabulary slice + uniform tail
        head = min(4096, v)
        ranks = np.arange(1, head + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(head, size=(b, self.seq), p=probs).astype(np.int32)
        tail_mask = rng.random((b, self.seq)) < 0.05
        toks = np.where(tail_mask, rng.integers(0, v, (b, self.seq)), toks)
        # document boundaries every ~512 tokens: next-token prediction does
        # not cross them (label = -1 is masked in the loss)
        labels = np.roll(toks, -1, axis=1).astype(np.int32)
        doc_ends = (np.arange(self.seq) % 512) == 511
        labels[:, doc_ends] = -1
        labels[:, -1] = -1
        out = {"tokens": toks, "labels": labels}
        if self.cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (b, self.cfg.encoder_seq, self.cfg.d_model)).astype(np.float32)
        if self.cfg.family == "vlm":
            out["patch_embeds"] = rng.standard_normal(
                (b, self.cfg.n_patches, self.cfg.d_model)).astype(np.float32)
        return out

    def iter(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_specs(cfg: ModelConfig, batch: int, seq: int):
    """The batch's shapes and dtypes as ``meta`` tensors (the reference's
    ``jax.ShapeDtypeStruct``s): int32 tokens and labels, frames and patch
    embeddings in the compute dtype."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {"tokens": spec((batch, seq), torch.int32),
           "labels": spec((batch, seq), torch.int32)}
    if cfg.family == "encdec":
        out["frames"] = spec((batch, cfg.encoder_seq, cfg.d_model),
                             cfg.compute_dtype)
    if cfg.family == "vlm":
        out["patch_embeds"] = spec((batch, cfg.n_patches, cfg.d_model),
                                   cfg.compute_dtype)
    return out
