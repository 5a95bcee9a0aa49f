"""Stream compaction: scan-based partition of kept and dropped lanes.

Port of ``pathtracer_tpu/ops/compact.py:30-81`` in plain PyTorch, as the
JAX package wrote it in plain XLA (it holds no TPU kernel).  The rank of a
kept lane among kept lanes is one inclusive ``cumsum``; the wavefront
engines (``render/wavefront.py``) use that rank to find the lanes they
refill.  Shapes stay static and no function here waits for the device:
``compact`` returns a buffer of the full size and the count as a 0-d
tensor; slots past the count hold ``fill``.  Indices are detached, so under
autograd compaction is a plain gather/scatter.

``values`` is a tensor or a dict, list or tuple of tensors with leading
axis ``N``.
"""

from __future__ import annotations

import torch


def _tree_map(fn, values):
    if isinstance(values, dict):
        return {k: _tree_map(fn, v) for k, v in values.items()}
    if isinstance(values, (list, tuple)):
        return type(values)(_tree_map(fn, v) for v in values)
    return fn(values)


def compaction_indices(keep: torch.Tensor):
    """For boolean ``keep [N]``: ``(dest [N], count)``, ``dest[i]`` the
    output slot of lane ``i`` (meaningful where ``keep``)."""
    incl = torch.cumsum(keep.to(torch.int64), dim=0)
    return incl - 1, incl[-1]


def compact(keep: torch.Tensor, values, fill=0):
    """Move the ``keep`` lanes of ``values`` to slots ``0..count-1`` in
    their order; returns ``(compacted, count)``."""
    dest, count = compaction_indices(keep)
    n = keep.shape[0]
    # dropped lanes go to one spare slot past the end, cut off afterwards
    slot = torch.where(keep, dest, n).detach()

    def one(arr):
        out = torch.full((n + 1,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                         device=arr.device)
        return out.index_put((slot,), arr)[:n]

    return _tree_map(one, values), count


def partition(keep: torch.Tensor, values):
    """Kept lanes first, dropped lanes after, each in their order; returns
    ``(partitioned, count)``."""
    dest_keep, count = compaction_indices(keep)
    dest_drop = torch.cumsum((~keep).to(torch.int64), dim=0) - 1 + count
    slot = torch.where(keep, dest_keep, dest_drop).detach()
    return _tree_map(lambda arr: torch.zeros_like(arr).index_put((slot,), arr), values), count


def sort_by_key_u8(key_u8: torch.Tensor, values):
    """Stable sort of lanes by a small integer key; returns ``(sorted,
    order)``.  A general queue primitive: the shading engines do not sort
    by material."""
    order = torch.argsort(key_u8.to(torch.int64), stable=True).detach()
    return _tree_map(lambda arr: arr[order], values), order
