"""The work counts against hand counts at small shapes: causal pairs
counted once, only the routed experts, the unembedding once a row."""

import numpy as np
import pytest

from bench.peaks import least_seconds
from bench.work.common import Work

# 2 layers: attention + MoE (4 experts, top 2), Mamba + MLP
W = Work(d_model=8, n_heads=2, n_kv_heads=1, head_dim=4, vocab_size=10,
         kinds=(("attention", "moe"), ("mamba", "mlp")), d_ff=6,
         n_experts=4, top_k=2, d_expert=3,
         mamba={"d_state": 2, "d_conv": 4, "expand": 2, "dt_rank": 1})

ATTN = 8 * 4 * (2 * 2 + 2 * 1)                   # wq, wo 8x8; wk, wv 8x4
MAMBA = 8 * 32 + 16 * (1 + 4) + 1 * 16 + 16 * 8  # in, x, dt, out projections
MOE_ACTIVE = 8 * 4 + 2 * 3 * 8 * 3               # router + 2 experts
MLP = 3 * 8 * 6


def test_active_weights_count_top_k_experts_only():
    assert W.active_weights() == ATTN + MAMBA + MOE_ACTIVE + MLP


def test_prefill_flops_count_causal_pairs_once():
    s = 5
    pairs = s * (s + 1) // 2                     # 15, not 25
    want = 3 * (2 * s * (ATTN + MAMBA + MOE_ACTIVE + MLP)
                + 4 * 4 * 2 * pairs + 2 * 8 * 10)
    assert W.prefill_flops(3, s) == want


def test_decode_flops_attend_every_earlier_position():
    want = 2 * (2 * (ATTN + MAMBA + MOE_ACTIVE + MLP) + 4 * 4 * 2 * 8
                + 2 * 8 * 10)
    assert W.decode_flops(2, 7) == want          # position 7: 8 keys


@pytest.mark.parametrize("batch", [1, 2, 64])
def test_routed_experts(batch):
    """Row r routes to experts r and r + 1 (mod 4) at step 0 and to 0 and
    1 at step 1: distinct experts counted once a step."""
    rows = np.arange(batch)
    step0 = np.stack([rows % 4, (rows + 1) % 4], axis=-1)
    step1 = np.tile([0, 1], (batch, 1))
    routes = [np.stack([step0, step1], axis=1)]      # (rows, steps, k)
    got = W.routed_experts(routes)
    assert got.shape == (2, 1)
    assert got[:, 0].tolist() == [min(4, batch + 1), 2]


def test_decode_bytes_by_hand():
    b, pos, routed = 2, 5, 3
    attn = 2 * (ATTN + 16) + 2 * 2 * b * (pos + 1) * 1 * 4
    moe = 2 * (8 * 4 + routed * 3 * 8 * 3)
    mamba = 2 * (MAMBA + 16) + 2 * 16 * 6 + 4 * 16 * 3 \
        + 2 * b * 16 * (2 * 3 + 4 * 2)
    mlp = 2 * MLP
    head = 2 * (b * 8 + 8 + 8 * 10)
    assert W.decode_bytes(b, pos, [routed]) == pytest.approx(
        attn + moe + mamba + mlp + head)
    with pytest.raises(ValueError):
        W.decode_bytes(b, pos)


def test_kernel_work():
    flops, nbytes = W.b3_prefill(3, 4)
    assert flops == 4 * 4 * 3 * 2 * 10 and nbytes == 2 * 3 * 4 * 4 * 6


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(flops=989e12) == pytest.approx(1.0)
    assert least_seconds(flops=1.0, nbytes=3.35e12) == pytest.approx(1.0)
    assert least_seconds(nbytes=1.0, exps=1e12) > 1e12 / (
        33.5e12 / 7 + 132 * 16 * 1.98e9) * 0.99
