"""Checkpoint and resume of progressive renders.

Port of ``pathtracer_tpu/utils/checkpoint.py:1-41``.  A render's whole
state is the HDR sum accumulator, the samples per pixel done, the frame
and the seed; every sample is keyed by (seed, global sample index), so a
resumed render draws the samples an uninterrupted one would.  The file is
the JAX package's ``.npz``: ``accum`` float32 ``[N, 3]`` in pixel order,
``spp_done``, ``frame`` and ``seed`` int64 scalars, so a checkpoint of
either package resumes in the other.  It is written to a temporary file
beside ``path`` (``<path>.tmp.npz``, the name ``np.savez`` gives JAX's
``<path>.tmp``) and moved over ``path`` with ``os.replace``, so a reader
never sees half a file.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save(path: str, accum, spp_done: int, frame: int, seed: int) -> None:
    """Write the state; ``accum`` is a tensor on any device (or an array)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if isinstance(accum, torch.Tensor):
        accum = accum.detach().cpu().numpy()
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        accum=np.asarray(accum, np.float32),
        spp_done=np.int64(spp_done),
        frame=np.int64(frame),
        seed=np.int64(seed),
    )
    os.replace(tmp, path)


def load(path: str):
    """The state as numpy data and ints, or None when ``path`` is missing;
    the caller moves ``accum`` to its device."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {
            "accum": z["accum"],
            "spp_done": int(z["spp_done"]),
            "frame": int(z["frame"]),
            "seed": int(z["seed"]),
        }
