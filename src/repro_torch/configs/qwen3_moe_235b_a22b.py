"""qwen3-moe-235b-a22b [moe]: 94L, d_model=4096, 64H (GQA kv=4, head 128),
expert d_ff=1536, vocab=151936, MoE 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
    moe_period=1,
    subquadratic=False,
    # 235B on 16 GB/chip: bf16 master weights + int8 Adam moments (f32
    # masters alone would be 3.7 GB/device and their update transients
    # blow the 16 GB budget — see EXPERIMENTS.md §Dry-run memory ledger)
    param_dtype="bfloat16",
    # bf16 first moment + Adafactor-style factored second moment: the int8
    # quantizer's abs/reduce breaks elementwise fusion (a 12×1.2 GB f32
    # transient pile-up in the update) and a dense v is 1.8 GB/device the
    # 16 GB budget can't spare — see EXPERIMENTS.md §Dry-run memory ledger.
    opt_state_dtype="factored",
    num_microbatches=16,       # memory-bound: per-device micro batch 1
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=64, vocab_size=128,
                      moe=MoEConfig(n_experts=4, top_k=2, d_expert=64),
                      remat=False)
