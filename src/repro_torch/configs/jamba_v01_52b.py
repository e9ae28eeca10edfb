"""jamba-v0.1-52b [hybrid]: 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=65536, MoE 16 experts top-2 — Mamba+attention 1:7 interleave (attn at
layer 4 of each 8-layer block), MoE every other layer.
[arXiv:2403.19887; hf]"""

from ..models.config import ModelConfig, MambaConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336),
    moe_period=2,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    attn_period=8,
    attn_offset=4,
    subquadratic=True,          # SSM state O(1); 4 attn layers seq-sharded
    num_microbatches=16,        # memory-bound (SSM bwd chunks + MoE)
    # the 235B memory recipe (bf16 masters + factored second moment) —
    # fp32 masters + dense moments put this 52B cell at 23.6 GB/device
    param_dtype="bfloat16",
    opt_state_dtype="factored",
)

SMOKE = CONFIG.scaled(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=128,
                      moe=MoEConfig(n_experts=4, top_k=2, d_expert=128),
                      mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
                      remat=False)
