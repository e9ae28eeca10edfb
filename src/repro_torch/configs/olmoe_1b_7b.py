"""olmoe-1b-7b [moe]: 16L, d_model=2048, 16H (kv=16), expert d_ff=1024,
vocab=50304, MoE 64 experts top-8.  [arXiv:2409.02060; hf]"""

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
    moe_period=1,
    subquadratic=False,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                      d_ff=64, vocab_size=128,
                      moe=MoEConfig(n_experts=4, top_k=2, d_expert=64),
                      remat=False)
