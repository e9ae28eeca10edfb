"""rwkv6-3b [ssm]: 32L, d_model=2560, attention-free (Finch: data-dependent
decay), d_ff=8960, vocab=65536.  [arXiv:2404.05892; hf]"""

from ..models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                 # d_model / rwkv.head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64),
    subquadratic=True,          # O(1) state: long_500k runs
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                      d_ff=128, vocab_size=128,
                      rwkv=RWKVConfig(head_dim=32), remat=False)
