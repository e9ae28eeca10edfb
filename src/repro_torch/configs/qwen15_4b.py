"""qwen1.5-4b [dense]: 40L, d_model=2560, 20H (kv=20), d_ff=6912,
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    subquadratic=False,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                      d_ff=128, vocab_size=128, remat=False)
