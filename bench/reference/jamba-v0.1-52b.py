"""Jamba-v0.1 (arXiv:2403.19887; ai21labs/Jamba-v0.1's config.json) in
plain float32 PyTorch: layer ``l`` mixes by attention (grouped-query, 32
heads over 8 KV heads) where ``l % attn_layer_period ==
attn_layer_offset`` and by Mamba (d_state 16, d_conv 4, expand 2, dt_rank
256) elsewhere, then a MoE layer (16 SwiGLU experts, top 2) where ``l %
expert_layer_period == expert_layer_offset`` and a SwiGLU MLP elsewhere.

It follows the port's semantics where they depart from the published
model (the configuration file's ``departures``): RoPE on attention
(``rope_theta`` assumed 10000), no RMSNorm on dt, B and C, renormalised
top-k gates, capacity-limited routing in groups of the prompt, no padding
mask."""

from bench.reference import common


def spec(cfg: dict) -> common.Spec:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kinds = tuple(
        ("attention" if l % cfg["attn_layer_period"] == cfg["attn_layer_offset"]
         else "mamba",
         "moe" if l % cfg["expert_layer_period"] == cfg["expert_layer_offset"]
         else "mlp")
        for l in range(cfg["num_hidden_layers"]))
    return common.Spec(
        d_model=d, n_heads=h, n_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // h, vocab_size=cfg["vocab_size"], kinds=kinds,
        d_ff=cfg["intermediate_size"], n_experts=cfg["num_experts"],
        top_k=cfg["num_experts_per_tok"], d_expert=cfg["intermediate_size"],
        rope_theta=cfg["assumed"]["rope_theta"],
        mamba={"d_state": cfg["mamba_d_state"], "d_conv": cfg["mamba_d_conv"],
               "expand": cfg["mamba_expand"],
               "dt_rank": cfg["mamba_dt_rank"]})


def logits_at(cfg, weights, tokens, prompt_len, at, prec=common.FLOAT32,
              routes=None):
    return common.logits_at(spec(cfg), weights, tokens, prompt_len, at, prec,
                            routes)
