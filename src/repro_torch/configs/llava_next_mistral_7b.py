"""llava-next-mistral-7b [vlm]: 32L, d_model=4096, 32H (GQA kv=8),
d_ff=14336, vocab=32000 — transformer backbone only; the anyres vision
tower is a STUB (``input_specs`` provides (B, n_patches, 4096) patch
embeddings).  [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1e6,
    n_patches=2880,             # anyres: 5 tiles x 576 patches
    subquadratic=False,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=128, n_patches=8, remat=False)
