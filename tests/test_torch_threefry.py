"""Threefry-2x32 of the PyTorch port vs ``jax.random``: bit-equal.

Tolerance: none.  ``ops/threefry.py`` computes the same integer hash and
the same float conversion as the installed ``jax`` (partitionable
threefry), so ``PRNGKey``, ``fold_in`` and ``uniform`` give the very same
uint32 words and float32 bits.  Fold-in data covers int32 indices that
wrapped past 2^31, which JAX's ``iteration * n_pixels + pixel`` reaches;
the port folds in their uint32 bits.  ``bounce_uniforms`` and
``camera_uniforms`` with ``fast_rng=False`` equal
``pathtracer_tpu.render.common``'s on the same lanes.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops.rng import key_to_seed as jax_key_to_seed
from pathtracer_tpu.render import common as jcommon
from pathtracer_tpu_torch.ops import rng, threefry
from pathtracer_tpu_torch.ops.camera import camera_uniforms
from pathtracer_tpu_torch.render.common import bounce_uniforms

SEEDS = [0, 1, 2**31 - 1, 2**32 - 1]
LANES = 4096


def _data(seed: int) -> np.ndarray:
    """``LANES`` uint32 fold-in values: edges, then seeded draws (half of
    them past 2^31)."""
    rs = np.random.default_rng(seed % 1000)
    d = rs.integers(0, 2**32, LANES, dtype=np.uint64).astype(np.int64)
    d[:6] = [0, 1, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1]
    return d


def _as_int32(u32: np.ndarray) -> np.ndarray:
    return u32.astype(np.uint32).view(np.int32)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    assert rng.prng_key(seed) == tuple(int(v) for v in np.asarray(jkey))
    data = _data(seed)
    want = np.asarray(jax.vmap(lambda d: jax.random.fold_in(jkey, d))(
        jnp.asarray(_as_int32(data))))
    key = torch.tensor(rng.prng_key(seed), dtype=torch.int64)
    got = threefry.fold_in(key, torch.from_numpy(data)).numpy()
    assert got.shape == (LANES, 2)
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # a scalar key and an int give JAX's fold_in of one value
    one = threefry.fold_in(key, 2**31 + 7)
    np.testing.assert_array_equal(one.numpy(), np.asarray(jax.random.fold_in(jkey, 2**31 + 7)))


@pytest.mark.parametrize("shape", [(), (4,), (11,)], ids=["scalar", "4", "11"])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape):
    """``uniform`` over ``LANES`` keys (each a fold-in of the seed's key),
    one ``[N, *shape]`` call."""
    jkey = jax.random.PRNGKey(seed)
    data = _data(seed + 1)
    jkeys = jax.vmap(lambda d: jax.random.fold_in(jkey, d))(jnp.asarray(_as_int32(data)))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(jkeys))
    keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    got = threefry.uniform(keys, shape).numpy()
    assert got.dtype == np.float32 and got.shape == (LANES, *shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_keyed_seed_carries_the_key():
    for seed in SEEDS:
        ks = rng.KeyedSeed(rng.prng_key(seed))
        assert int(ks) == int(jax_key_to_seed(jax.random.PRNGKey(seed)))
        assert ks.key == rng.prng_key(seed) and int(ks) & rng.MASK32 == int(ks)
    with pytest.raises(ValueError, match="two words"):
        rng.KeyedSeed((1, 2, 3))
    with pytest.raises(TypeError, match="KeyedSeed"):
        bounce_uniforms(5, torch.arange(4), 0, fast_rng=False)


@pytest.mark.parametrize("seed", [1, 2**32 - 1])
def test_slow_uniforms_match_jax(seed):
    """``bounce_uniforms`` / ``camera_uniforms`` with ``fast_rng=False``:
    JAX's vmapped ``fold_in(fold_in(key, s), d + 1)`` -> ``uniform(11)`` and
    ``fold_in(key, s)`` -> ``uniform(4)``, bit for bit, with a per-lane
    depth too."""
    jkey = jax.random.PRNGKey(seed)
    samples = _data(seed + 2)
    js = jnp.asarray(_as_int32(samples))
    ts = torch.from_numpy(samples)
    ks = rng.KeyedSeed(rng.prng_key(seed))
    for depth in (0, 3):
        want = jcommon.bounce_uniforms(jkey, js, depth, fast_rng=False)
        np.testing.assert_array_equal(_bits(bounce_uniforms(ks, ts, depth, fast_rng=False)),
                                      _bits(want))
    depths = np.arange(LANES, dtype=np.int32) % 9
    want = jcommon.bounce_uniforms(jkey, js, jnp.asarray(depths), fast_rng=False)
    got = bounce_uniforms(ks, ts, torch.from_numpy(depths), fast_rng=False)
    assert got.shape == (LANES, 11)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    want = jcommon.camera_uniforms(jkey, js, fast_rng=False)
    got = camera_uniforms(ks, ts, fast_rng=False)
    assert got.shape == (LANES, 4)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the fast path is the counter hash as before, whatever the seed's type
    np.testing.assert_array_equal(_bits(camera_uniforms(ks, ts)),
                                  _bits(jcommon.camera_uniforms(jkey, js)))
