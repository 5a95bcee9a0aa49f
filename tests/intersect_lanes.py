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


# ---- kernel 8 and the padded world-box cull of tools/occlusion_cull.py:
# tables and lanes that probe its boxes


def transform_table(g: int, seed: int) -> torch.Tensor:
    """A ``[g, GEOM_COLS]`` float32 table of spheres and cubes under random
    rotations and non-uniform scales from 0.01 to 10 (log-uniform; every
    third row a wall of Cornell's 0.01 x 10 x 10 in a random orientation),
    translations within 5, and every fifth row near-singular: its third
    axis sheared to within 1e-3 of its first."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((g, GEOM_COLS))
    for i in range(g):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if i % 3 == 2:
            scale = rng.permutation([0.01, 10.0, 10.0])
        else:
            scale = np.exp(rng.uniform(np.log(0.01), np.log(10.0), 3))
        fwd = q * scale
        if i % 5 == 4:
            fwd[:, 2] = fwd[:, 0] + 1e-3 * np.linalg.norm(fwd[:, 0]) * q[:, 2]
        inv = np.linalg.inv(fwd)
        shift = rng.uniform(-5.0, 5.0, 3)
        rows[i, :12] = np.concatenate([inv, (-inv @ shift)[:, None]], axis=1).reshape(-1)
        rows[i, 12] = rng.choice([0.0, 1.0])
        rows[i, 13] = i % 10
    return torch.from_numpy(rows.astype(np.float32))


def grazing_rays(gtab: torch.Tensor, n: int, seed: int):
    """``(origin, direction)`` float32 ``[n, 3]`` that graze the tables'
    spheres and cubes where their world boxes are tight: each ray passes
    through a primitive's extreme point along a world axis (a sphere's one
    point, a cube's corner, edge or face) with the direction's component on
    that axis 0, +-1e-7, +-1e-5 or free, its origin 0.5 to 3 before the
    point; every other ray passes instead through a point on the face of
    the padded box (``tools/occlusion_cull.cull_boxes``), along it or across."""
    from pathtracer_tpu_torch.tools.occlusion_cull import cull_boxes

    rng = np.random.default_rng(seed)
    fwd = forward_affines(gtab)
    boxes = cull_boxes(gtab)[0].double().numpy()
    types = gtab[:, 12].numpy()
    geoms = np.flatnonzero((types == 0.0) | (types == 1.0))
    origin, direction = np.zeros((n, 3)), np.zeros((n, 3))
    for k in range(n):
        g, j, sgn = geoms[rng.integers(len(geoms))], rng.integers(3), rng.choice([-1.0, 1.0])
        f, c = fwd[g][:, :3], fwd[g][:, 3]
        if k % 2 and np.isfinite(boxes[g]).all():  # a point on a face of the padded box
            p = rng.uniform(boxes[g, :3], boxes[g, 3:])
            p[j] = boxes[g, 3 + j] if sgn > 0 else boxes[g, j]
        elif types[g] == 0.0:
            p = f @ (sgn * 0.5 * f[j] / np.linalg.norm(f[j])) + c
        else:
            p = f @ (sgn * 0.5 * np.sign(f[j])) + c
        d = rng.standard_normal(3)
        kind = rng.integers(4)
        if kind < 3:
            d[j] = 0.0
            d /= np.linalg.norm(d)
            d[j] = rng.choice([-1.0, 1.0]) * (0.0, 1e-7, 1e-5)[kind]
        direction[k] = d / np.linalg.norm(d)
        origin[k] = p - rng.uniform(0.5, 3.0) * direction[k]
    return (torch.from_numpy(origin.astype(np.float32)),
            torch.from_numpy(direction.astype(np.float32)))


def cornell_shadow_rays(n: int, seed: int):
    """``(gtab, origin, direction)``: shadow rays on Cornell as
    ``render/common.shade_bounce`` makes them: rays from points in the box
    to their nearest hits (``nearest_hit_plain``), each hit's shadow ray
    from hit + RAY_BIAS n_shade towards a light sample
    (``ops/lights.sample_lights``, seeded uniforms), ``wi`` normalised; the
    lanes that miss or hit the light keep theirs, as the route launches
    kernel 8 on every lane."""
    from pathtracer_tpu_torch.ops.bsdf import RAY_BIAS
    from pathtracer_tpu_torch.ops.intersect import nearest_hit_plain
    from pathtracer_tpu_torch.ops.lights import sample_lights
    from pathtracer_tpu_torch.scene.structs import Rays

    gtab = stress_table("cornell")
    import os

    from pathtracer_tpu_torch.scene.parser import load_scene

    root = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.txt")
    scene = load_scene(root).scene_for_frame(0, device="cpu")
    rng = np.random.default_rng(seed)
    o = rng.uniform([-4.9, 0.1, -4.9], [4.9, 9.9, 11.0], (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d))
    hit = nearest_hit_plain(rays, gtab)
    u = torch.from_numpy(rng.random((n, 4)).astype(np.float32))
    ls = sample_lights(scene.geoms, scene.materials, u)
    n_shade = hit.normal * torch.sign(-torch.sum(hit.normal * rays.direction, -1, keepdim=True))
    x = hit.position + RAY_BIAS * n_shade
    to_light = ls.position - x
    dist = torch.sqrt(torch.clamp(torch.sum(to_light * to_light, -1), min=1e-12))
    return gtab, x.contiguous(), (to_light / dist[:, None]).contiguous()


# the lane sets that probe kernel 8 and the box cull: the stress lanes on the
# four tables; random rotations and scales 0.01-10 with walls and sheared
# rows, on stress lanes and on grazing rays; Cornell's grazing rays;
# Cornell's shadow rays
PROBE_CASES = ("stress cornell", "stress cornell repeated rows", "stress one geom",
               "stress max geoms", "transforms", "transforms grazing", "cornell grazing",
               "cornell shadow rays")


def probe_case(name: str, n: int):
    """``(gtab, origin, direction)``, float32 CPU tensors, of the lane set
    ``name`` (:data:`PROBE_CASES`)."""
    if name.startswith("stress "):
        gtab = stress_table(name[len("stress "):])
        return (gtab, *stress_rays(gtab, n, 31))
    if name.startswith("transforms"):
        gtab = transform_table(40, 11)
        return (gtab, *(grazing_rays if "grazing" in name else stress_rays)(gtab, n, 13))
    if name == "cornell grazing":
        gtab = stress_table("cornell")
        return (gtab, *grazing_rays(gtab, n, 14))
    return cornell_shadow_rays(n, 15)
