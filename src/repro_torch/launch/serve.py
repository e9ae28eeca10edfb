"""Batched serving launcher: prefill a batch of ragged requests, decode
greedily, report per-phase timings — the port of ``repro/launch/serve.py``,
on one card or, when a process group of more than one rank is up (as
under ``torchrun``), on the host mesh of its ranks.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        --requests 8 --new-tokens 16

Requests arrive with ragged prompt lengths drawn from ``--seed``, are
left-padded into a fixed batch of ``--max-prompt`` tokens, prefilled by a
:class:`PrefillStep` and decoded greedily by a :class:`DecodeStep`: the
port's counterparts of the reference's ``jax.jit(prefill)`` and
``jax.jit(decode)``, which on the card replay the direct model's
``serve_prefill`` / ``serve_decode`` and the greedy pick as one CUDA graph
per shape and on the CPU run them eagerly.  The weights are cast once to
the compute dtype (``serving_params``).  An encoder-decoder model's frames
are encoded once a batch and every decode step cross-attends to them (the
reference launcher decodes without them: ROADMAP C23); a VLM's patch
embeddings prefix each prompt.  Both default to zeros, as the reference
launcher feeds them.  As in the reference, ``--smoke`` cannot be turned
off, so ``main`` serves the reduced config with random weights; a
full-size run calls :func:`serve_requests` with its own config and
weights.  Every config of ``configs/`` is served: attention, MoE, Mamba
(the SSM state carried from the prefill into every decode step) and RWKV6
layers.

On a mesh (``serve_requests(..., mesh=)``) the steps are
``launch.steps.make_serve_steps``' prefill and decode, run eagerly (a
DTensor's collectives are not captured in a CUDA graph), with the weights
placed by ``RULES_SERVE`` and the caches by ``cache_specs``; every rank
serves the same requests.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..core.cuda_graph import capture
from ..core.device import resolve_device
from ..core.obs import trace
from ..distributed.sharding import shard_tree
from ..launch.mesh import launcher_mesh
from ..models.config import ModelConfig
from ..models.layers import MOE_GROUP_TOKENS
from ..models.transformer import (encode, init_params, serve_decode,
                                  serve_prefill, serving_params,
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


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


class _GraphStep:
    """What :class:`PrefillStep` and :class:`DecodeStep` share: with
    ``graph`` (the default on a CUDA device) a step is captured once per
    input shape into a ``torch.cuda.CUDAGraph`` over static input buffers
    (the tokens, and an encoder output or patch embeddings where the model
    takes them; ``core.cuda_graph.capture``: one eager warm-up on a side
    stream, then the capture), and every call copies its inputs into the
    buffers and replays; without ``graph`` (the CPU, or a caller that
    asks) a step runs eagerly.  ``graph=True`` off a CUDA device raises.
    A capture that fails raises: there is no eager fallback.  ``captures``
    counts captures and ``replays`` replays: a replay launches the
    captured kernels again without running their Python wrappers, so their
    launch counters see the warm-up and the capture only.

    With a tracer installed (``core.obs.trace``) a call is the host span
    ``serve.prefill`` or ``serve.decode`` over ``serve.inputs`` (the
    inputs' copies to the card and into the static buffers),
    ``serve.capture`` (a shape's first call), ``serve.cache_load`` (a
    :class:`DecodeStep` copying in caches not its own) and
    ``serve.replay``; and the model's device spans and counters go to a
    ``trace.DeviceRecord``: the capture's, which every replay of it adds
    a run to, or a fresh one an eager call.  ``record`` is the last
    call's record (None without a tracer).  A shape captured with no
    tracer installed has no record and its graph no span or counter."""

    def __init__(self, params, cfg: ModelConfig, *, graph=None):
        self.params, self.cfg = params, cfg
        self.device = params["embed"].device
        self.graph = self.device.type == "cuda" if graph is None else graph
        if self.graph and self.device.type != "cuda":
            raise ValueError(f"{type(self).__name__}: a CUDA graph needs a "
                             f"CUDA device, the params lie on {self.device}")
        self._static = {}
        self.replays = self.captures = 0
        self.record = None

    def _on_device(self, x, dtype):
        if x is None:
            return None
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(device=self.device, dtype=dtype)

    def _run_eager(self, fn, *args):
        """``fn(*args)``, an eager call, inside a fresh record."""
        rec = trace.new_record(self.device)
        with trace.recording(rec):
            out = fn(*args)
        if rec is not None:
            rec.runs = 1
        self.record = rec
        return out

    def _replay(self, key, inputs, make, load=None):
        """Replay the graph of ``key``, capturing it at its first call:
        ``make(*static inputs)`` returns ``(warm_up, body, state)`` for
        ``capture`` and the static buffers ``load(state)`` refills before
        each replay; ``inputs`` (``(value, dtype)`` pairs, value None for
        an input the model does not take) go to the card, into their
        static buffers.  Returns ``(state, what body returned)``."""
        with trace.span("serve.inputs"):
            inputs = tuple(self._on_device(x, dtype) for x, dtype in inputs)
            key = (key,) + tuple(None if x is None else tuple(x.shape)
                                 for x in inputs)
            entry = self._static.get(key)
            if entry is not None:
                for dst, src in zip(entry[1], inputs):
                    if dst is not None:
                        dst.copy_(src)
        if entry is None:
            with trace.span("serve.capture"):
                # the clones are the static buffers, already holding this
                # call's inputs
                statics = tuple(None if x is None else x.clone()
                                for x in inputs)
                warm_up, body, state = make(*statics)
                rec = trace.new_record(self.device)

                def recorded():
                    with trace.recording(rec):
                        return body()

                graph, out = capture(self.device, warm_up, recorded)
            self.captures += 1
            entry = self._static[key] = (graph, statics, state, out, rec)
        graph, statics, state, out, rec = entry
        if load is not None:
            load(state)
        with trace.span("serve.replay"):
            graph.replay()
        self.replays += 1
        if rec is not None:
            rec.runs += 1
        self.record = rec
        return state, out


class PrefillStep(_GraphStep):
    """The prompt's prefill and the greedy pick of the first token, for a
    ``(B, S)`` batch of prompt tokens: ``step(tokens, max_seq, *,
    enc_out=None, patch_embeds=None) -> (last position logits, next token,
    caches)``, the caches stacked and ``max_seq`` deep.  ``enc_out`` is
    the encoder's output of the batch's frames (an encoder-decoder model),
    ``patch_embeds`` the batch's ``(B, n_patches, d)`` patch embeddings (a
    VLM).

    As a graph (:class:`_GraphStep`) it is captured once per (batch, prompt
    length, ``max_seq``, input shapes) over a static ``(B, S)`` int32
    token buffer and static copies of the other inputs, the caches
    allocated from the graph's pool; the inputs' copies to the card stay
    outside the graph.  The returned logits and caches are the static
    buffers, overwritten by the next call of that shape: a
    :class:`DecodeStep` copies them into its own caches at its first step;
    the token is a copy.  Eager, logits and caches are bitwise those of a
    replay."""

    def _eager(self, tokens, max_seq, enc_out=None, patch_embeds=None):
        logits, caches = serve_prefill(self.params, tokens, self.cfg,
                                       max_seq, enc_out=enc_out,
                                       patch_embeds=patch_embeds)
        with trace.device_span("model.pick"):
            nxt = _greedy(logits)
        return logits, nxt, caches

    def __call__(self, tokens, max_seq: int, *, enc_out=None,
                 patch_embeds=None):
        with trace.span("serve.prefill"):
            if not self.graph:
                return self._run_eager(self._eager, tokens, max_seq,
                                       enc_out, patch_embeds)
            cd = self.cfg.compute_dtype
            inputs = ((tokens, torch.int32), (enc_out, cd),
                      (patch_embeds, cd))

            def make(*statics):
                def run():
                    return self._eager(statics[0], max_seq, *statics[1:])
                return run, run, None

            _, (logits, nxt, caches) = self._replay(max_seq, inputs, make)
            return logits, nxt.clone(), caches


class DecodeStep(_GraphStep):
    """One greedy decode step, ``serve_decode`` and the argmax, for a batch
    of ``(B, 1)`` tokens: ``step(caches, token, *, enc_out=None) ->
    (logits, next token, caches)``, cross-attending to ``enc_out`` (an
    encoder-decoder model's encoder output).

    As a graph (:class:`_GraphStep`) it is captured once per batch, cache
    and ``enc_out`` shape over a static ``(B, 1)`` token, a static
    ``enc_out`` and static stacked caches, with the caches updated in place
    (``serve_decode(..., in_place=True)``: B6 writes each RWKV layer's
    state, B5 each Mamba layer's SSM state and each attention layer its
    token's key and value straight into the static cache, which the
    decode-attention kernel then reads where it lies).  Every call copies
    its token
    and ``enc_out`` into the static ones, and its caches too unless they
    are the static ones the last call returned, and replays.  The returned
    logits and caches are the static buffers, overwritten by the next
    call; the token is a copy."""

    def _eager(self, caches, token, enc_out=None, in_place=False):
        logits, caches = serve_decode(self.params, caches, token, self.cfg,
                                      enc_out=enc_out, in_place=in_place)
        with trace.device_span("model.pick"):
            nxt = _greedy(logits)
        return logits, nxt, caches

    def __call__(self, caches, token, *, enc_out=None):
        with trace.span("serve.decode"):
            if not self.graph:
                return self._run_eager(self._eager, caches, token, enc_out)
            inputs = ((token, torch.int32),
                      (enc_out, self.cfg.compute_dtype))
            leaves = list(_leaves(caches))
            key = tuple((tuple(z.shape), z.dtype) for z in leaves)

            def make(s_tok, s_enc):
                s_caches = _clone(caches)
                return (lambda: self._eager(s_caches, s_tok, s_enc),
                        lambda: self._eager(s_caches, s_tok, s_enc,
                                            in_place=True),
                        s_caches)

            def load(s_caches):
                if caches is not s_caches:
                    nbytes = sum(z.numel() * z.element_size()
                                 for z in leaves)
                    with trace.span("serve.cache_load", bytes=nbytes):
                        for dst, src in zip(_leaves(s_caches), leaves):
                            dst.copy_(src)
                    trace.count("serve.cache_load_bytes", nbytes)

            s_caches, (logits, nxt, _) = self._replay(key, inputs, make,
                                                      load)
            return logits, nxt.clone(), s_caches


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _batch_rows(x, start: int, batch: int, shape, dtype, device):
    """Rows ``start:start + batch`` of the per-request array ``x`` as a
    ``(batch,) + shape`` tensor on ``device``, zero past its end; all zeros
    when ``x`` is None (the reference launcher's stand-in input)."""
    out = torch.zeros((batch,) + tuple(shape), dtype=dtype, device=device)
    if x is not None:
        rows = x[start:start + batch]
        if not isinstance(rows, torch.Tensor):
            rows = torch.as_tensor(np.asarray(rows))
        out[:rows.shape[0]] = rows.to(device=device, dtype=dtype)
    return out


class _MeshSteps:
    """:class:`PrefillStep` and :class:`DecodeStep`'s calls on a mesh:
    ``make_serve_steps``' eager prefill and decode over the weights placed
    by its specs, the greedy pick from the whole logits."""

    def __init__(self, params, cfg: ModelConfig, mesh, max_seq: int,
                 batch: int):
        from .steps import make_serve_steps
        self._prefill, self._decode, specs = make_serve_steps(
            cfg, mesh, max_seq, batch)
        self.params = shard_tree(params, specs["params"], mesh)
        self.mesh, self.cfg = mesh, cfg

    def encode(self, frames):
        from .steps import _mesh_scope
        with _mesh_scope(self.mesh):
            return encode(self.params, frames, self.cfg)

    def prefill(self, toks, max_seq, *, enc_out=None, patch_embeds=None):
        inputs = {"tokens": torch.as_tensor(toks), "enc_out": enc_out,
                  "patch_embeds": patch_embeds}
        logits, caches = self._prefill(self.params, inputs)
        return logits, _greedy(logits.full_tensor()), caches

    def step(self, caches, token, *, enc_out=None):
        logits, caches = self._decode(self.params, caches, token, enc_out)
        return logits, _greedy(logits.full_tensor()), caches


def serve_requests(cfg: ModelConfig, params, prompts, *, batch: int,
                   max_prompt: int, new_tokens: int, graph=None,
                   frames=None, patch_embeds=None, mesh=None):
    """Serve ``prompts`` (1-D int arrays, each at most ``max_prompt`` long)
    in batches of ``batch`` on the device ``params`` lie on: left-pad each
    batch to ``max_prompt``, prefill, then ``new_tokens - 1`` greedy decode
    steps.  An encoder-decoder model takes ``frames``, one ``(encoder_seq,
    d_model)`` entry per request: each batch's are encoded once and every
    decode step cross-attends to them.  A VLM takes ``patch_embeds``, one
    ``(n_patches, d_model)`` entry per request, prefixed to the prompt
    (``max_seq`` counts them).  Either defaults to zeros, as in the
    reference launcher.  Returns ``(tokens, times)``: each request's
    ``new_tokens`` generated tokens (an int32 array), and per batch its
    size, the prefill seconds (the encoder's run included), each decode
    step's seconds (host clock to a synchronize), the :class:`PrefillStep`
    that prefilled it and the :class:`DecodeStep` that decoded it (their
    ``captures`` and ``replays``).  ``graph`` is both steps': None runs
    each as a CUDA graph on the card and eagerly on the CPU.  The weights
    are cast once (:func:`serving_params`), which leaves every logit
    bitwise.  A MoE model routes the padded prompt in groups of
    ``min(S, 512)`` tokens, so ``max_prompt`` must be at most 512 or a
    multiple of it.  With ``mesh`` (every rank calls it with the same
    arguments) the steps run eagerly on the mesh (:class:`_MeshSteps`);
    the times' ``prefill`` and ``step`` are then None."""
    validate_config(cfg)
    if cfg.moe is not None and max_prompt > MOE_GROUP_TOKENS \
            and max_prompt % MOE_GROUP_TOKENS:
        raise ValueError(f"serve_requests: a MoE model routes groups of "
                         f"{MOE_GROUP_TOKENS} tokens; max_prompt "
                         f"{max_prompt} is above it and not a multiple")
    params = serving_params(params, cfg)
    device = params["embed"].device
    cd = cfg.compute_dtype
    vlm = cfg.family == "vlm"
    max_seq = max_prompt + new_tokens + (cfg.n_patches if vlm else 0)
    if mesh is None:
        prefill = PrefillStep(params, cfg, graph=graph)
        step = DecodeStep(params, cfg, graph=graph)

        def run_encoder(fr):
            return encode(params, fr, cfg)
    else:
        on_mesh = _MeshSteps(params, cfg, mesh, max_seq, batch)
        prefill, step, run_encoder = (on_mesh.prefill, on_mesh.step,
                                      on_mesh.encode)
    tokens, times = [], []
    for start in range(0, len(prompts), batch):
        with trace.context(batch=start // batch):
            group = prompts[start:start + batch]
            toks = np.zeros((batch, max_prompt), np.int32)
            for i, p in enumerate(group):
                toks[i, max_prompt - len(p):] = p           # left-pad
            fr = pe = None
            if cfg.family == "encdec":
                fr = _batch_rows(frames, start, batch,
                                 (cfg.encoder_seq, cfg.d_model), cd, device)
            if vlm:
                pe = _batch_rows(patch_embeds, start, batch,
                                 (cfg.n_patches, cfg.d_model), cd, device)
            _sync(device)
            t0 = time.perf_counter()
            enc_out = None if fr is None else run_encoder(fr)
            _, tok, cache = prefill(toks, max_seq, enc_out=enc_out,
                                    patch_embeds=pe)
            _sync(device)
            prefill_s = time.perf_counter() - t0
            outs, steps = [tok], []
            for _ in range(new_tokens - 1):
                t0 = time.perf_counter()
                _, tok, cache = step(cache, tok, enc_out=enc_out)
                _sync(device)
                steps.append(time.perf_counter() - t0)
                outs.append(tok)
            gen = torch.cat(outs, dim=1).cpu().numpy()
            tokens.extend(gen[:len(group)])
            times.append({"batch": len(group), "prefill_s": prefill_s,
                          "decode_s": steps,
                          "prefill": prefill if mesh is None else None,
                          "step": step if mesh is None else None})
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
    mesh = launcher_mesh(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    prompts = draw_prompts(args.seed, args.requests, args.max_prompt,
                           cfg.vocab_size)
    t0 = time.perf_counter()
    tokens, times = serve_requests(cfg, params, prompts, batch=args.batch,
                                   max_prompt=args.max_prompt,
                                   new_tokens=args.new_tokens, mesh=mesh)
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
