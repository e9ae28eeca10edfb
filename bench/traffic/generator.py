"""The one traffic generator: a closed loop of ``batch`` clients, each
waiting for its reply, so a batch of requests starts when the last one
ends.  A traffic mix is a data file beside this one
(``traffic/<name>.json``) holding its parameters:

- ``batch``: the clients, one request each a batch;
- ``max_prompt``: every prompt is left-padded (token 0) to this length;
- ``new_tokens``: greedy tokens served per request (a prefill, then
  ``new_tokens - 1`` decode steps);
- ``prompt``: the prompt-length distribution, ``{"dist": "lognormal",
  "median", "sigma", "min", "max"}`` or ``{"dist": "uniform", "min",
  "max"}`` (both ends included), clipped to ``[min, max]``;
- ``check_requests``: how many served requests the output check samples;
- ``source`` and ``fit``, read by no code: the public statistics the mix
  stands for, and how far its lengths follow them.

Token ids are drawn uniformly over the vocabulary from ``--seed``, as the
port's ``launch/serve.py:draw_prompts`` draws them (``rng.integers(0,
vocab, n)``; a frozen copy, so the benchmark does not move when the
program's launcher does).  Every seed gives the same batch shape, so the
same work, whatever lengths it draws."""

from __future__ import annotations

import numpy as np

#: independent streams of one seed
WINDOW, WARM_UP, SAMPLE = 0, 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of ``stream`` for ``seed`` (any integer)."""
    return np.random.default_rng([seed % 2 ** 63, stream])


class Traffic:
    """The requests of one run, batch by batch, drawn from ``seed``."""

    def __init__(self, mix: dict, seed: int, vocab_size: int,
                 stream: int = WINDOW):
        self.mix, self.vocab = mix, vocab_size
        self.batch = int(mix["batch"])
        self.max_prompt = int(mix["max_prompt"])
        self.new_tokens = int(mix["new_tokens"])
        p = mix["prompt"]
        if not 1 <= p["min"] <= p["max"] <= self.max_prompt:
            raise ValueError(f"prompt lengths {p['min']}..{p['max']} do not "
                             f"fit max_prompt {self.max_prompt}")
        self._rng = rng(seed, stream)

    def _length(self) -> int:
        p = self.mix["prompt"]
        if p["dist"] == "lognormal":
            n = self._rng.lognormal(np.log(p["median"]), p["sigma"])
        elif p["dist"] == "uniform":
            n = self._rng.integers(p["min"], p["max"] + 1)
        else:
            raise ValueError(f"unknown prompt distribution {p['dist']!r}")
        return int(np.clip(round(float(n)), p["min"], p["max"]))

    def next_batch(self):
        """``(prompts, tokens)``: ``batch`` prompts (int32 arrays) and the
        ``(batch, max_prompt)`` int32 array of them left-padded with 0."""
        prompts = []
        for _ in range(self.batch):
            n = self._length()
            prompts.append(self._rng.integers(0, self.vocab, n)
                           .astype(np.int32))
        toks = np.zeros((self.batch, self.max_prompt), np.int32)
        for i, p in enumerate(prompts):
            toks[i, self.max_prompt - len(p):] = p
        return prompts, toks
