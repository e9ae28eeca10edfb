"""gemma2-9b [dense]: 42L, d_model=3584, 16H (GQA kv=8, head 256),
d_ff=14336, vocab=256000 — local(4096)+global alternating, logit softcaps,
(1+g) norms, tied embeddings.  [arXiv:2408.00118; hf]

long_500k RUNS for this arch: half the layers are sliding-window (bounded
KV), the global layers sequence-shard their 500k cache (DESIGN.md §5)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    act="gelu",
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_period=2,
    norm_plus_one=True,
    tie_embeddings=True,
    subquadratic=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=128,
                      sliding_window=8, remat=False)
