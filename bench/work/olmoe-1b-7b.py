"""OLMoE-1B-7B's work counts (``work/common.py``): 16 attention layers,
each followed by a MoE layer of 64 experts, top 8."""

from bench.work.common import Work


def work(cfg: dict) -> Work:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return Work(d_model=d, n_heads=h, n_kv_heads=cfg["num_key_value_heads"],
                head_dim=d // h, vocab_size=cfg["vocab_size"],
                kinds=(("attention", "moe"),) * cfg["num_hidden_layers"],
                n_experts=cfg["num_experts"],
                top_k=cfg["num_experts_per_tok"],
                d_expert=cfg["intermediate_size"])
