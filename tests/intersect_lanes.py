"""Lanes that stress the nearest-hit and winner sweeps (kernels 6 and 7):
rays aimed at the corners and edges where a scene's cubes meet, so that two
or three geoms give the same t and the first in index order must win;
direction components of exactly 0 (either sign) and below, at and above
``safe_recip``'s 1e-12; and geom tables of 1 and ``MAX_GEOMS`` rows with
repeated rows (exact ties) and mesh slots.  Made with numpy from a seed,
shared by ``test_torch_kernel_host.py`` (the lanes built for the host) and
``test_torch_kernels_cuda.py`` (the kernels on the card); imports no JAX.
"""

import numpy as np
import torch

from pathtracer_tpu_torch.ops.intersect import GEOM_COLS

# the kinds of lanes, in the order stress_rays lays them out
RAY_KINDS = ("corners", "edges", "zero components", "tiny components", "random")
# components put in place of a direction's: signed zeros and values below,
# at and above safe_recip's threshold
TINY = (0.0, -0.0, 1e-13, -1e-13, 9e-13, -9e-13, 1e-12, -1e-12, 1.1e-12, -1.1e-12)


def forward_affines(gtab: torch.Tensor) -> np.ndarray:
    """``[G, 3, 4]`` float64 object-to-world transforms of the table's rows
    (each row holds the world-to-object rows 0..2)."""
    inv = np.zeros((gtab.shape[0], 4, 4))
    inv[:, :3, :] = gtab[:, :12].double().reshape(-1, 3, 4).numpy()
    inv[:, 3, 3] = 1.0
    return np.linalg.inv(inv)[:, :3, :]


def cube_points(gtab: torch.Tensor):
    """World-space corners ``[C, 3]`` and edge midpoints ``[E, 3]`` of the
    table's cubes (type 1), float64."""
    signs = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)])
    edges = []
    for axis in range(3):
        for a in (-0.5, 0.5):
            for b in (-0.5, 0.5):
                p = [a, b]
                p.insert(axis, 0.0)
                edges.append(p)
    cubes = forward_affines(gtab)[gtab[:, 12].numpy() == 1.0]

    def to_world(pts):
        world = np.einsum("gij,pj->gpi", cubes[:, :, :3], pts) + cubes[:, None, :, 3]
        return world.reshape(-1, 3)

    return to_world(signs), to_world(np.array(edges))


def stress_rays(gtab: torch.Tensor, n: int, seed: int):
    """``(origin, direction)``, ``[n, 3]`` float32 CPU tensors: the kinds of
    :data:`RAY_KINDS` in five near-equal runs.  Origins lie inside the box
    of the table's cube corners (shrunk to 80%), and corner and edge rays
    point exactly at a corner or an edge midpoint."""
    rng = np.random.default_rng(seed)
    corners, edges = cube_points(gtab)
    pts = corners if len(corners) else np.zeros((1, 3))
    lo, hi = pts.min(0), pts.max(0)
    mid, half = (lo + hi) / 2, np.maximum((hi - lo) / 2, 0.5)
    origin = mid + rng.uniform(-0.8, 0.8, (n, 3)) * half
    direction = rng.standard_normal((n, 3))
    cut = np.linspace(0, n, len(RAY_KINDS) + 1).astype(int)
    for kind, a, b in zip(RAY_KINDS, cut[:-1], cut[1:]):
        if kind in ("corners", "edges"):
            targets = (corners if kind == "corners" else edges)
            if len(targets):
                direction[a:b] = targets[rng.integers(0, len(targets), b - a)] - origin[a:b]
        elif kind == "zero components":
            zero = rng.random((b - a, 3)) < 0.5
            zero[np.arange(b - a), rng.integers(0, 3, b - a)] = False  # one axis stays
            direction[a:b] = np.where(zero, np.where(rng.random((b - a, 3)) < 0.5, 0.0, -0.0),
                                      direction[a:b])
    direction = direction / np.linalg.norm(direction, axis=-1, keepdims=True)
    a, b = cut[RAY_KINDS.index("tiny components")], cut[RAY_KINDS.index("tiny components") + 1]
    axis = rng.integers(0, 3, b - a)
    direction[np.arange(a, b), axis] = np.array(TINY)[rng.integers(0, len(TINY), b - a)]
    return (torch.from_numpy(origin.astype(np.float32)),
            torch.from_numpy(direction.astype(np.float32)))


def random_table(g: int, seed: int) -> torch.Tensor:
    """A ``[g, GEOM_COLS]`` float32 geom table: random spheres, cubes and
    mesh slots (types 0, 1, 2) scaled 0.3-3 and rotated about the origin
    within 4, material ids 0-9; every fifth row repeats an earlier one, so
    that two geoms give the same t on every ray."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((g, GEOM_COLS))
    for i in range(g):
        if i and i % 5 == 0:
            rows[i] = rows[rng.integers(0, i)]
            continue
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        fwd = q * rng.uniform(0.3, 3.0, 3)
        inv = np.linalg.inv(fwd)
        shift = rng.uniform(-4.0, 4.0, 3)
        rows[i, :12] = np.concatenate([inv, (-inv @ shift)[:, None]], axis=1).reshape(-1)
        rows[i, 12] = rng.choice([0.0, 1.0, 2.0], p=[0.45, 0.45, 0.1])
        rows[i, 13] = rng.integers(0, 10)
    return torch.from_numpy(rows.astype(np.float32))


# the geom tables of the stress cases: Cornell's 9 rows; Cornell's rows
# after copies of three of them (every lane that hits one of those ties
# with its later copy); one of Cornell's walls; MAX_GEOMS random rows
TABLES = ("cornell", "cornell repeated rows", "one geom", "max geoms")


def stress_table(name: str) -> torch.Tensor:
    """The ``[G, GEOM_COLS]`` float32 CPU table of the stress case ``name``
    (:data:`TABLES`)."""
    import os

    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.trace import MAX_GEOMS
    from pathtracer_tpu_torch.scene.parser import load_scene

    if name == "max geoms":
        return random_table(MAX_GEOMS, 5)
    root = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.txt")
    gtab = pack_tables(load_scene(root).scene_for_frame(0, device="cpu"))[0]
    if name == "cornell repeated rows":
        return torch.cat([gtab[[4, 1, 7]], gtab]).contiguous()
    if name == "one geom":
        return gtab[1:2].contiguous()
    return gtab
