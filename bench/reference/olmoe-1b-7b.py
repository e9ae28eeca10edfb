"""OLMoE-1B-7B (arXiv:2409.02060; allenai/OLMoE-1B-7B-0924's config.json)
in plain float32 PyTorch: 16 decoder layers, each multi-head attention
with RoPE, then a MoE layer of 64 SwiGLU experts, top 8.

It follows the port's semantics where they depart from the published
model (the configuration file's ``departures``): no QK-norm, renormalised
top-k gates, capacity-limited routing in groups of the prompt, RMSNorm
eps 1e-6, no padding mask."""

from bench.reference import common


def spec(cfg: dict) -> common.Spec:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return common.Spec(
        d_model=d, n_heads=h, n_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // h, vocab_size=cfg["vocab_size"],
        kinds=(("attention", "moe"),) * cfg["num_hidden_layers"],
        n_experts=cfg["num_experts"], top_k=cfg["num_experts_per_tok"],
        d_expert=cfg["intermediate_size"], rope_theta=cfg["rope_theta"])


def logits_at(cfg, weights, tokens, prompt_len, at, prec=common.FLOAT32,
              routes=None):
    return common.logits_at(spec(cfg), weights, tokens, prompt_len, at, prec,
                            routes)
