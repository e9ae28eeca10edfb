"""Batched serving launcher on one card: prefill a batch of ragged requests,
decode greedily, report per-phase timings — the port of
``repro/launch/serve.py`` without its mesh (the model runs whole on one
device).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        --requests 8 --new-tokens 16

Requests arrive with ragged prompt lengths drawn from ``--seed``, are
left-padded into a fixed batch of ``--max-prompt`` tokens, prefilled
through the direct model's ``serve_prefill`` and decoded greedily through
``serve_decode``.  As in the reference, ``--smoke`` cannot be turned off,
so ``main`` serves the reduced config with random weights; a full-size run
calls :func:`serve_requests` with its own config and weights.  An arch
whose config the direct model refuses raises, naming what it lacks.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..core.device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import (init_params, serve_decode, serve_prefill,
                                  validate_config)


def draw_prompts(seed: int, requests: int, max_prompt: int,
                 vocab_size: int) -> list:
    """``requests`` prompts of ragged lengths in ``[8, max_prompt)``, as the
    reference's launcher draws them from ``seed``."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(8, max_prompt, requests)
    return [rng.integers(0, vocab_size, n).astype(np.int32) for n in lengths]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, -1].argmax(-1)[:, None].to(torch.int32)


def serve_requests(cfg: ModelConfig, params, prompts, *, batch: int,
                   max_prompt: int, new_tokens: int):
    """Serve ``prompts`` (1-D int arrays, each at most ``max_prompt`` long)
    in batches of ``batch`` on the device ``params`` lie on: left-pad each
    batch to ``max_prompt``, prefill, then ``new_tokens - 1`` greedy decode
    steps.  Returns ``(tokens, times)``: each request's ``new_tokens``
    generated tokens (an int32 array), and per batch its size, the prefill
    seconds and each decode step's seconds (host clock to a synchronize)."""
    validate_config(cfg)
    device = params["embed"].device
    max_seq = max_prompt + new_tokens
    tokens, times = [], []
    for start in range(0, len(prompts), batch):
        group = prompts[start:start + batch]
        toks = np.zeros((batch, max_prompt), np.int32)
        for i, p in enumerate(group):
            toks[i, max_prompt - len(p):] = p           # left-pad
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = serve_prefill(params, toks, cfg, max_seq)
        tok = _greedy(logits)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        outs, steps = [tok], []
        for _ in range(new_tokens - 1):
            t0 = time.perf_counter()
            logits, cache = serve_decode(params, cache, tok, cfg)
            tok = _greedy(logits)
            _sync(device)
            steps.append(time.perf_counter() - t0)
            outs.append(tok)
        gen = torch.cat(outs, dim=1).cpu().numpy()
        tokens.extend(gen[:len(group)])
        times.append({"batch": len(group), "prefill_s": prefill_s,
                      "decode_s": steps})
    return tokens, times


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the device to serve on (the CUDA card unless "
                         "given; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    validate_config(cfg)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    prompts = draw_prompts(args.seed, args.requests, args.max_prompt,
                           cfg.vocab_size)
    t0 = time.perf_counter()
    tokens, times = serve_requests(cfg, params, prompts, batch=args.batch,
                                   max_prompt=args.max_prompt,
                                   new_tokens=args.new_tokens)
    for t in times:
        decode_s = sum(t["decode_s"])
        rate = args.new_tokens * t["batch"] / (t["prefill_s"] + decode_s)
        print(f"[serve] batch of {t['batch']}: prefill "
              f"{1e3 * t['prefill_s']:.0f} ms, {args.new_tokens} tokens in "
              f"{1e3 * (t['prefill_s'] + decode_s):.0f} ms ({rate:.1f} tok/s)")
    if not all(np.all((g >= 0) & (g < cfg.vocab_size)) for g in tokens):
        raise RuntimeError("generated a token outside the vocabulary")
    dt = time.perf_counter() - t0
    print(f"[serve] {args.requests} requests, "
          f"{args.requests * args.new_tokens} tokens, {dt:.1f}s total")


if __name__ == "__main__":
    main()
