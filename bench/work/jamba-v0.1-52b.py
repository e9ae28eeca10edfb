"""Jamba-v0.1's work counts (``work/common.py``): attention where ``l %
attn_layer_period == attn_layer_offset``, Mamba elsewhere; MoE where ``l %
expert_layer_period == expert_layer_offset``, a SwiGLU MLP elsewhere."""

from bench.work.common import Work


def work(cfg: dict) -> Work:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kinds = tuple(
        ("attention" if l % cfg["attn_layer_period"] == cfg["attn_layer_offset"]
         else "mamba",
         "moe" if l % cfg["expert_layer_period"] == cfg["expert_layer_offset"]
         else "mlp")
        for l in range(cfg["num_hidden_layers"]))
    return Work(d_model=d, n_heads=h, n_kv_heads=cfg["num_key_value_heads"],
                head_dim=d // h, vocab_size=cfg["vocab_size"], kinds=kinds,
                d_ff=cfg["intermediate_size"], n_experts=cfg["num_experts"],
                top_k=cfg["num_experts_per_tok"],
                d_expert=cfg["intermediate_size"],
                mamba={"d_state": cfg["mamba_d_state"],
                       "d_conv": cfg["mamba_d_conv"],
                       "expand": cfg["mamba_expand"],
                       "dt_rank": cfg["mamba_dt_rank"]})
