"""How ``correct`` is decided.  The sample: requests of the window's first
batch, drawn from the seed with the batch's longest prompt always in it;
while that batch runs, the window keeps the logits the timed steps
produced for those rows (the prefill's last position and every decode
step's).  Once the window has closed, each sampled request runs through
the configuration's plain float32 reference (``reference/<config>.py``)
over its padded prompt and its served tokens, and at each position that
produced a served token two numbers are read:

- ``rms``: the root mean square over the vocabulary of the program's
  logits less the reference's.  Each sampled request's positions are cut
  into blocks of about ``block`` consecutive positions (the cell's
  ``cells/<cell>.json``), and the run's ``logit_rms_worst_block`` is the
  largest of the blocks' lower quartiles: a fault that covers three
  quarters of one block, in one request or in the later decode steps,
  moves it, where a median pooled over every position would outvote any
  fault on fewer than half of them; the lower quartile stays steady where
  a bf16 near-tie flips an expert or the top token at some positions of
  a block, which the float8 control's error, spread over every position,
  does not depend on.
- ``excess``: the gap by which the served token's reference logit lies
  below the reference's best, less the program's logit error at those two
  tokens.  A greedy pick from the program's own logits can never lie
  further below (its logit is the program's largest), so for a sound run
  every ``excess`` is at most 0: an exact comparison, limit 0.  A token
  altered after the logits reads about the logits' spread.

The control (``FP8``) takes the program's place: its logits are the
reference's in float8 and its token the one float8 puts first."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from bench.traffic.generator import SAMPLE, rng


def sample_rows(prompts: List[np.ndarray], k: int, seed: int) -> List[int]:
    """``k`` rows of a batch: the longest prompt's, and the rest drawn from
    ``seed``."""
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    rest = [i for i in range(len(prompts)) if i != longest]
    picked = rng(seed, SAMPLE).choice(len(rest), size=min(k - 1, len(rest)),
                                      replace=False)
    return [longest] + sorted(rest[i] for i in picked)


def reference_logits(reference, cfg: dict, weights: dict, reqs: List[dict],
                     at=None, **kw) -> torch.Tensor:
    """The reference's ``(len(reqs), new_tokens, vocab)`` logits at each
    position that produced a served token of each request (``row``: its
    padded prompt, ``tokens``: its served tokens), all in one batch; at
    the positions ``at`` of those sequences instead, where given."""
    s, n = len(reqs[0]["row"]), len(reqs[0]["tokens"])
    seq = torch.as_tensor(np.stack([np.concatenate([r["row"],
                                                    r["tokens"][:-1]])
                                    for r in reqs]),
                          device=weights["embed"].device)
    at = list(range(s - 1, s + n - 1)) if at is None else at
    return reference.logits_at(cfg, weights, seq, s, at, **kw)


def readings(ref: torch.Tensor, prog: torch.Tensor,
             served: torch.Tensor) -> dict:
    """Per position of ``(requests, positions, vocab)`` logits, each an
    array of ``(requests, positions)`` in float64: ``rms`` of ``prog -
    ref``, ``excess`` of the served token's gap (see the module doc) and
    the ``gap`` itself."""
    shape, v = ref.shape[:-1], ref.shape[-1]
    ref, prog = ref.reshape(-1, v).double(), prog.reshape(-1, v).double()
    served = served.reshape(-1).long().to(ref.device)[:, None]
    best = ref.argmax(-1, keepdim=True)
    diff = prog - ref
    gap = (ref.gather(1, best) - ref.gather(1, served))[:, 0]
    slack = (diff.gather(1, best).abs() + diff.gather(1, served).abs())[:, 0]
    return {"rms": diff.pow(2).mean(-1).sqrt().reshape(shape).cpu().numpy(),
            "excess": (gap - slack).reshape(shape).cpu().numpy(),
            "gap": gap.reshape(shape).cpu().numpy()}


def block_quartiles(rms: np.ndarray, block: int) -> np.ndarray:
    """The lower quartile of each block of a request's consecutive
    positions (``rms``: ``(requests, positions)``): each request cut into
    ``round(positions / block)`` near-equal blocks, one at the least."""
    cuts = max(1, round(rms.shape[1] / block))
    return np.array([np.quantile(part, 0.25) for row in rms
                     for part in np.array_split(row, cuts)])


def worst_block(rms: np.ndarray, block: int) -> float:
    """``logit_rms_worst_block``: the largest of :func:`block_quartiles`."""
    return float(block_quartiles(rms, block).max())
