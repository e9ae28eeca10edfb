"""starcoder2-3b [dense]: 30L, d_model=3072, 24H (GQA kv=2), d_ff=12288,
vocab=49152 — GQA + RoPE.  [arXiv:2402.19173; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    act="gelu",
    subquadratic=False,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=128, remat=False)
