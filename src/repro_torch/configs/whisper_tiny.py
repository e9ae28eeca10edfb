"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384, 6H (kv=6),
d_ff=1536, vocab=51865 — encoder-decoder, conv frontend STUB
(``input_specs`` provides precomputed (B, 1500, 384) frame embeddings).
[arXiv:2212.04356; unverified]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    n_encoder_layers=4,
    encoder_seq=1500,
    subquadratic=False,          # full attention: long_500k skipped
    # 6 heads don't shard on a 16-way model axis ⇒ per-device attention
    # scores scale with the microbatch; keep microbatches at 16 (the model
    # is tiny — FSDP regather traffic is negligible)
    num_microbatches=16,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                      d_ff=128, vocab_size=128, n_encoder_layers=2,
                      encoder_seq=16, remat=False)
