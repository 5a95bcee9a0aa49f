"""Counter-hash RNG, bit-exact with the JAX package.

Port of ``pathtracer_tpu/ops/rng.py:49-94`` (``key_to_seed``,
``hash_uniforms``, ``CAMERA_STREAM``) and of the in-kernel plane version
``pathtracer_tpu/ops/bounce_pallas.py:105-133`` (``hash_uniforms_planes``).
The uniforms are a pure function of (seed, sample index, depth, slot): the
murmur3 fmix32 finalizer over that counter lattice, top 24 bits scaled to
[0, 1).  No ``torch.Generator`` is involved, so the same seed gives the same
samples as the JAX package and as the CUDA kernel (``csrc/trace.cu``).

Under ``cfg.fast_rng=False`` the uniforms are threefry's instead
(``ops/threefry.py``, re-exported here), keyed by ``fold_in`` of the
render's key with the sample index (and ``depth + 1`` for a bounce).  The
routes carry the seed as a :class:`KeyedSeed`: the counter hash's int
seed, which every kernel takes, with the key's two words beside it.

Torch has no complete uint32 arithmetic, so values are carried as int64
masked to 32 bits.  A product of two 32-bit values can exceed 2^63, so
:func:`_u32mul` splits one factor into 16-bit halves.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops.threefry import fold_in, uniform  # noqa: F401

MASK32 = 0xFFFFFFFF
CAMERA_STREAM = 0x10000  # depth slot reserved for camera/lens draws


def prng_key(seed: int) -> tuple[int, int]:
    """The uint32 pair of ``jax.random.PRNGKey(seed)``: ``(0, seed mod 2^32)``."""
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} outside the 32-bit range")
    return (0, seed & MASK32)


def _u32mul(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) (tensor or int)."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _avalanche(x):
    """murmur3 fmix32 on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _u32mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _u32mul(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def key_to_seed(base_key) -> int:
    """Collapse a key (sequence of uint32 words) to the uint32 seed."""
    words = [int(w) & MASK32 for w in base_key]
    return _avalanche(_u32mul(words[0], 0x9E3779B9) ^ words[-1])


class KeyedSeed(int):
    """:func:`key_to_seed` of a threefry key: an ``int``, the seed every
    route and kernel takes, that carries the key's two uint32 words in
    ``key`` for the routes that draw threefry uniforms (``fast_rng=False``)
    and for the motion-blur shutter time."""

    key: tuple

    def __new__(cls, base_key):
        words = tuple(int(w) & MASK32 for w in base_key)
        if len(words) != 2:
            raise ValueError(f"a threefry key has two words, got {len(words)}")
        self = super().__new__(cls, key_to_seed(words))
        self.key = words
        return self


def sample_keys(seed, sample_idx: torch.Tensor) -> torch.Tensor:
    """``fold_in(key, sample)`` per lane, ``[N, 2]``: the threefry keys of
    the global sample indices (their uint32 bits), from the key ``seed``
    carries (a :class:`KeyedSeed`)."""
    key = getattr(seed, "key", None)
    if key is None:
        raise TypeError("fast_rng=False draws threefry uniforms from the render's key: pass "
                        "the seed as ops.rng.KeyedSeed(key), not a bare int")
    keys = torch.tensor(key, dtype=torch.int64, device=sample_idx.device)
    return fold_in(keys, sample_bits(sample_idx))


def sample_bits(sample_idx: torch.Tensor) -> torch.Tensor:
    """Sample indices of any integer dtype -> their uint32 bit pattern in
    int64.  JAX computes ``iteration * n_pixels + pixel`` in int32 and so
    wraps past 2^31; reducing the exact int64 index mod 2^32 gives the
    same bits."""
    return sample_idx.to(torch.int64) & MASK32


def _base(seed: int, sample_idx: torch.Tensor, depth) -> torch.Tensor:
    s = sample_bits(sample_idx)
    if isinstance(depth, torch.Tensor):
        d1 = (depth.to(torch.int64) + 1) & MASK32
    else:
        d1 = (int(depth) + 1) & MASK32
    return _avalanche((int(seed) & MASK32) ^ _u32mul(s, 0x85EBCA6B) ^ _u32mul(d1, 0xC2B2AE35))


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    # 24-bit mantissa -> exact float32 uniforms in [0, 1)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash_uniforms_planes(seed: int, sample_idx: torch.Tensor, depth, n: int) -> list:
    """``n`` uniform tensors shaped like ``sample_idx`` (one per slot)."""
    base = _base(seed, sample_idx, depth)
    return [
        _to_unit(_avalanche(base ^ ((k * 0x27D4EB2F) & MASK32))) for k in range(n)
    ]


def hash_uniforms(seed: int, sample_idx: torch.Tensor, depth, n: int) -> torch.Tensor:
    """``[N, n]`` float32 uniforms == ``pathtracer_tpu.ops.rng.hash_uniforms``."""
    return torch.stack(hash_uniforms_planes(seed, sample_idx, depth, n), dim=-1)
