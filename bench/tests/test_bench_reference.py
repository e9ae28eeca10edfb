"""The plain reference holds the port's direct model at the SMOKE sizes on
the CPU, prefill and decode, both in float32 (the semantics, not the
rounding, are compared); and each cell's configuration file gives the
reference and the port the same widths and layer pattern."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness, weights

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name", ["tiny-olmoe", "tiny-jamba"])
def test_reference_holds_direct_model(tiny_root32, name):
    from repro_torch.models.transformer import serve_decode, serve_prefill
    lay = harness.Layout(tiny_root32)
    config = lay.config(name)
    cfg = harness.port_config(config["port"])
    params = weights.draw(cfg, 11, torch.device("cpu"))
    ref = lay.module("reference", name)
    rng = np.random.default_rng(3)
    s, steps = 48, 4
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, s)),
                           dtype=torch.int32)
    got = []
    logits, caches = serve_prefill(params, toks, cfg, s + steps)
    got.append(logits[:, -1])
    served = [logits[:, -1].argmax(-1)]
    for _ in range(steps):
        logits, caches = serve_decode(params, caches, served[-1][:, None], cfg)
        got.append(logits[:, -1])
        served.append(logits[:, -1].argmax(-1))
    got = torch.stack(got, dim=1)                       # (B, steps + 1, V)
    lw = weights.layers(params, cfg)
    seq = torch.cat([toks.long(), torch.stack(served[:-1], dim=1)], dim=1)
    want = ref.logits_at(config, lw, seq, s, list(range(s - 1, s + steps)))
    err = (got - want).abs().max() / want.abs().max()
    assert err < 1e-4, err


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_cell_config_widths_agree(name):
    config = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                        .read_text())
    cfg = harness.port_config(config["port"])
    sp = harness.Layout(ROOT).module("reference", name).spec(config)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.vocab_size, cfg.moe.n_experts, cfg.moe.top_k,
            cfg.moe.d_expert) == (sp.d_model, sp.n_heads, sp.n_kv_heads,
                                  sp.head_dim, sp.vocab_size, sp.n_experts,
                                  sp.top_k, sp.d_expert)
    kinds = tuple(("attention" if m == "attn" else m, f)
                  for m, f in cfg.layer_pattern())
    assert kinds == sp.kinds
    if cfg.mamba is not None:
        assert sp.mamba == {"d_state": cfg.mamba.d_state,
                            "d_conv": cfg.mamba.d_conv,
                            "expand": cfg.mamba.expand,
                            "dt_rank": cfg.mamba.dt_rank}
    if any(f == "mlp" for _, f in sp.kinds):
        assert sp.d_ff == cfg.d_ff
