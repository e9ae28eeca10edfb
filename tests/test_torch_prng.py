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
