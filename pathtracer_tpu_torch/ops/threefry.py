"""Threefry-2x32 keys and uniforms, bit-exact with ``jax.random``.

Port of what ``jax.random.fold_in`` and ``jax.random.uniform`` compute for
a threefry key (``jax/_src/prng.py``: ``_threefry2x32_lowering``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``;
``jax/_src/random.py:_uniform``), with ``jax_threefry_partitionable`` on,
vectorised over lanes: a key array is ``[..., 2]`` int64 holding the two
uint32 words, one key per lane.  The JAX package draws from these where
``cfg.fast_rng`` is off (``pathtracer_tpu/render/common.py:37-58``) and for
the motion-blur shutter time (``pathtracer_tpu/render/motion.py:50-52``).

* ``fold_in(key, d)`` is the threefry hash of the counter ``(0, d)`` under
  ``key``: ``threefry_seed`` of a 32-bit value puts it in the low word.
* ``uniform(key, shape)`` hashes the counters ``(0, i)`` for the flat index
  ``i`` of each entry and xors the two output words (the partitionable
  random bits); its float is the top 23 bits as a mantissa under the
  exponent of 1.0, minus 1: multiples of 2^-23 in [0, 1), where the counter
  hash of ``ops/rng.py`` scales 24 bits.

uint32 values are carried as int64 masked to 32 bits, as ``ops/rng.py``
does; threefry adds, rotates and xors, so no product needs splitting.  One
call runs every lane and every slot of a draw: each of its ~170 integer ops
is one launch over the whole ``[N, k]`` block.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # Threefry's key-schedule constant


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter ``(x0, x1)`` under the key
    ``(k0, k1)``: ints or int64 tensors of uint32 values that broadcast.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` per lane: ``keys`` ``[..., 2]``, ``data`` an
    int or an int64 tensor of uint32 bit patterns broadcasting against
    ``keys[..., 0]`` (``ops/rng.sample_bits`` gives a wrapped int32
    index's); returns the new keys ``[..., 2]``."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK32
    else:
        data = int(data) & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def uniform(keys: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)) per lane:
    ``keys`` ``[..., 2]`` -> ``[..., *shape]``."""
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None], 0, count)
    mantissa = ((y0 ^ y1) >> 9) | 0x3F800000  # the float bits of 1.0 + u
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0  # JAX's max(0, .) is moot
    return floats.reshape((*keys.shape[:-1], *shape))
