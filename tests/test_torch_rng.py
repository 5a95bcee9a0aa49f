"""Counter-hash RNG of the PyTorch port vs the JAX package: bit-equal.

Tolerance: none.  The uniforms are integer hashes scaled by 2^-24, so the
port must give the very same float32 bits for every (seed, sample, depth,
slot), including sample indices past 2^31, which JAX's int32 sample index
reaches by wrapping (``iteration * n_pixels + pixel``).
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import rng as jrng
from pathtracer_tpu.ops.bounce_pallas import hash_uniforms_planes as j_planes
from pathtracer_tpu_torch.ops import rng as trng


def _as_int32(u32: np.ndarray) -> np.ndarray:
    return u32.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, 2**31 + 5, 2**32 - 1])
def test_key_to_seed_matches(seed):
    assert trng.prng_key(seed) == tuple(int(v) for v in np.asarray(jax.random.PRNGKey(seed)))
    assert trng.key_to_seed(trng.prng_key(seed)) == int(jrng.key_to_seed(jax.random.PRNGKey(seed)))


def test_prng_key_range():
    with pytest.raises(ValueError):
        trng.prng_key(2**32)


@pytest.mark.parametrize("case", range(6))
def test_hash_uniforms_bit_equal(case):
    rs = np.random.default_rng(case)
    seed = int(rs.integers(0, 2**32))
    depth = [0, 1, 7, int(rs.integers(0, 64)), jrng.CAMERA_STREAM, 2**31 - 2][case]
    samples = rs.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.int64)
    samples[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]
    n = 11 if case % 2 else 4
    want = np.asarray(
        jrng.hash_uniforms(jnp.uint32(seed), jnp.asarray(_as_int32(samples)), depth, n)
    )
    got = trng.hash_uniforms(seed, torch.from_numpy(samples), depth, n).numpy()
    assert got.dtype == np.float32 and got.shape == (4096, n)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_hash_uniforms_planes_bit_equal():
    rs = np.random.default_rng(11)
    samples = rs.integers(0, 2**32, 1024, dtype=np.uint64).astype(np.int64)
    seed = int(rs.integers(0, 2**32))
    for depth in (0, 5):
        want = j_planes(
            jnp.uint32(seed), jnp.asarray(_as_int32(samples)),
            jnp.full((1024,), depth, jnp.int32), 11,
        )
        got = trng.hash_uniforms_planes(seed, torch.from_numpy(samples), depth, 11)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w).view(np.uint32))


def test_sample_index_wrap_past_2_31():
    """Cornell at 800x800 crosses 2^31 samples near iteration 3356: the
    port's exact int64 index, reduced mod 2^32, hashes like JAX's wrapped
    int32 index."""
    n_pixels = 800 * 800
    iteration = 3360
    pixel = np.arange(0, n_pixels, 997, dtype=np.int64)
    exact = iteration * n_pixels + pixel
    assert exact.max() >= 2**31
    wrapped = (jnp.int32(iteration) * jnp.int32(n_pixels) + jnp.asarray(pixel, jnp.int32))
    want = np.asarray(jrng.hash_uniforms(jnp.uint32(99), wrapped, jrng.CAMERA_STREAM, 4))
    got = trng.hash_uniforms(99, torch.from_numpy(exact), trng.CAMERA_STREAM, 4).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
