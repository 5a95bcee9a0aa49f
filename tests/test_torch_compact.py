"""The port's stream compaction (``ops/compact.py``) against the JAX
package's, on the cases of ``tests/test_compact.py``, with the same numpy
inputs handed to both.  Every result is exact: compaction moves values
and counts lanes, it computes nothing."""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import jax.numpy as jnp
import numpy as np
import torch

from pathtracer_tpu.ops import compact as jax_compact
from pathtracer_tpu_torch.ops.compact import compact, compaction_indices, partition, sort_by_key_u8


def test_compaction_indices():
    keep = np.array([True, False, True, True, False])
    dest, count = compaction_indices(torch.from_numpy(keep))
    jdest, jcount = jax_compact.compaction_indices(jnp.asarray(keep))
    assert int(count) == int(jcount) == 3
    np.testing.assert_array_equal(dest.numpy()[keep], [0, 1, 2])
    np.testing.assert_array_equal(dest.numpy()[keep], np.asarray(jdest)[keep])


def test_compact_preserves_multiset_and_order():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(257, 3)).astype(np.float32)
    keep = rng.random(257) < 0.4
    out, count = compact(torch.from_numpy(keep), torch.from_numpy(vals))
    jout, jcount = jax_compact.compact(jnp.asarray(keep), jnp.asarray(vals))
    out = out.numpy()
    assert int(count) == int(jcount) == keep.sum()
    np.testing.assert_array_equal(out[: int(count)], vals[keep])
    assert (out[int(count):] == 0).all()
    np.testing.assert_array_equal(out, np.asarray(jout))


def test_compact_pytree():
    keep = torch.tensor([False, True, True])
    tree = {"a": torch.arange(3), "b": torch.arange(6).reshape(3, 2)}
    out, count = compact(keep, tree)
    assert int(count) == 2
    np.testing.assert_array_equal(out["a"][:2].numpy(), [1, 2])
    np.testing.assert_array_equal(out["b"][:2].numpy(), [[2, 3], [4, 5]])
    (a, b), _ = compact(keep, (tree["a"], tree["b"]))
    assert torch.equal(a, out["a"]) and torch.equal(b, out["b"])


def test_compact_fill():
    keep = torch.tensor([True, False, False, True])
    out, count = compact(keep, torch.arange(4), fill=-1)
    assert int(count) == 2
    np.testing.assert_array_equal(out.numpy(), [0, 3, -1, -1])


def test_partition_is_permutation():
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 1000, size=501)
    keep = rng.random(501) < 0.7
    out, count = partition(torch.from_numpy(keep), torch.from_numpy(vals))
    jout, jcount = jax_compact.partition(jnp.asarray(keep), jnp.asarray(vals))
    out = out.numpy()
    assert int(count) == int(jcount)
    assert sorted(out.tolist()) == sorted(vals.tolist())  # multiset preserved
    np.testing.assert_array_equal(out[: int(count)], vals[keep])
    np.testing.assert_array_equal(out[int(count):], vals[~keep])
    np.testing.assert_array_equal(out, np.asarray(jout))


def test_compact_grad_transparent():
    """d(sum of kept)/d(values) is the keep mask."""
    keep = torch.tensor([True, False, True, False])
    v = torch.ones(4, requires_grad=True)
    out, _ = compact(keep, v)
    out.sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), [1, 0, 1, 0])


def test_sort_by_key():
    key = np.array([2, 0, 1, 0, 2], np.uint8)
    out, order = sort_by_key_u8(torch.from_numpy(key), torch.arange(5))
    jout, jorder = jax_compact.sort_by_key_u8(jnp.asarray(key), jnp.arange(5))
    np.testing.assert_array_equal(out.numpy(), [1, 3, 2, 0, 4])  # stable
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
