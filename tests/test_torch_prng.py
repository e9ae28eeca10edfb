"""``repro_torch.core.prng`` draws the JAX package's random bits exactly:
``jax.random.uniform(fold_in(PRNGKey(seed), salt), shape, dtype)`` under
the partitionable threefry that jax 0.9 uses, for float64 and float32."""

import jax
import numpy as np
import pytest
import torch

import repro.core.lazy  # noqa: F401  (the reference's 64-bit mode, as it runs)
from repro_torch.core import prng


def test_reference_runs_partitionable_threefry():
    # the port implements this bit layout; a reference on the other
    # setting would draw other bits
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", [(), (7,), (1000,), (33, 17)])
@pytest.mark.parametrize("seed,salt", [(0, 0), (0, 17), (5, 1),
                                       (123456789, 2 ** 31 - 2), (2 ** 40 + 3, 9)])
def test_uniform_is_bitwise_jax(dtype, shape, seed, salt):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), salt)
    want = np.asarray(jax.random.uniform(key, shape, dtype=dtype))
    got = prng.uniform(seed, salt, shape, dtype, torch.device("cpu")).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8))


def test_key_schedule_matches_jax():
    key = jax.random.fold_in(jax.random.PRNGKey(42), 7)
    assert tuple(int(x) for x in jax.random.key_data(key)) == \
        prng.fold_in(prng.prng_key(42), 7)


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view({8: np.int64, 4: np.int32, 2: np.int16}[x.dtype.itemsize])


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16])
@pytest.mark.parametrize("seed,salt", [(0, 3), (2 ** 32 + 5, 2 ** 31 - 2),
                                       (2 ** 40 + 3, 2 ** 31 + 7), (77, 0)])
def test_uniform_at_is_jax_at_any_flat_index(dtype, seed, salt):
    """``uniform_at`` — the kernel's per-element steps — gives the bits
    ``jax.random.uniform`` draws at the same flat positions: random index
    subsets in any order and index shape, a run from an odd offset, and
    the ragged tail of a 2-D draw."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), salt)
    shape = (37, 29)
    want = np.asarray(jax.random.uniform(key, shape, dtype=dtype)).reshape(-1)
    rng = np.random.default_rng(seed % 997 + salt % 991)
    for idx in (rng.choice(want.size, size=(5, 40), replace=False),
                np.arange(101, 101 + 300),
                np.arange(want.size - 1, want.size - 30, -1)):
        got = prng.uniform_at(seed, salt, torch.from_numpy(idx),
                              dtype).numpy()
        assert got.dtype == want.dtype and got.shape == idx.shape
        np.testing.assert_array_equal(_bits(got), _bits(want[idx]))


def test_key_words_are_the_folded_key_and_uniform_counts_its_calls():
    key = jax.random.fold_in(jax.random.PRNGKey(2 ** 33 + 1), 2 ** 31 - 2)
    assert prng.key_words(2 ** 33 + 1, 2 ** 31 - 2) == \
        tuple(int(x) for x in jax.random.key_data(key))
    before = prng.CALLS["uniform"]
    prng.uniform(1, 2, (5,), np.float32, torch.device("cpu"))
    prng.uniform_at(1, 2, torch.arange(5), np.float32)
    assert prng.CALLS["uniform"] == before + 1
