"""One bounce of the PyTorch port vs the JAX kernel body.

``pathtracer_tpu_torch.ops.bounce.bounce_physics`` against
``pathtracer_tpu.ops.bounce_pallas.bounce_physics`` called eagerly on CPU
arrays (op by op, as the Pallas kernel's body), on the same planes and
the same packed tables, for cornell and the JAX tests' ``MINI_SCENE``, NEE
on and off, at depth 0 (camera rays) and at depth 3 (the rays the first
bounce sent on, with mixed 0/1/2 emit states and random throughput).

Tolerances: booleans and the emit-state code exact; floats to 1e-5
relative / 1e-6 absolute.  The arithmetic is the same in the same order,
but XLA's CPU ``rsqrt`` is not the correctly rounded ``1/sqrt`` that torch
computes (they differ in the last ulp on many inputs), and
sin/cos/log/exp come from different libraries, so normals and directions
may differ in the last bits.  A discrete flip (a comparison that lands on
the other side) would show as a lane outside the tolerance; their count is
reported and expected to be 0.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import bounce_pallas as jb
from pathtracer_tpu.ops.camera import generate_camera_rays as jax_rays
from pathtracer_tpu.ops.intersect_pallas import _pack_gdata
from pathtracer_tpu.ops.rng import hash_uniforms as jax_hash_uniforms
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse
from pathtracer_tpu_torch.ops import bounce as tb
from pathtracer_tpu_torch.ops.intersect import T_MIN
from tests.test_bounce_grad import MINI_SCENE
from tests.test_torch_scene import port_scene_from_jax

N = 1024
SEED = 99


def _jax_scene(name):
    if name == "mini":
        return jax_parse(MINI_SCENE, name="mini").scene_for_frame(0)
    path = os.path.join(os.path.dirname(__file__), "..", "scenes", f"{name}.txt")
    return jax_load_scene(path).scene_for_frame(0)


def _jax_values(table):
    return [[jnp.float32(v) for v in row] for row in np.asarray(table).tolist()]


def _planes(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(a.shape[1]))


def _run_both(jscene, tables, o, d, thr, prev, depth, nee):
    gv, mv, lv, sv = tables["jax"]
    u = np.asarray(jax_hash_uniforms(jnp.uint32(SEED), jnp.arange(N, dtype=jnp.int32), depth, 11))
    jout = jb.bounce_physics(
        tuple(jnp.asarray(o[:, k]) for k in range(3)),
        tuple(jnp.asarray(d[:, k]) for k in range(3)),
        tuple(jnp.asarray(thr[:, k]) for k in range(3)),
        (jnp.zeros(N, jnp.float32),) * 3, jnp.zeros(N, jnp.float32),
        gv, mv, lv, sv,
        [jnp.asarray(u[:, k]) for k in range(11)],
        jnp.full((N,), depth, jnp.int32), jnp.asarray(prev),
        nee=nee, t_min=T_MIN, features=frozenset(),
    )
    gt, mt, lt, st = tables["port"]
    tout = tb.bounce_physics(
        _planes(o), _planes(d), _planes(thr),
        (torch.zeros(N),) * 3, torch.zeros(N), gt, mt, lt, st,
        list(_planes(u)), depth, torch.from_numpy(prev), nee=nee, t_min=T_MIN,
    )
    return jout, tout


def _compare(jout, tout):
    flips = 0
    for k in ("contrib", "next_o", "next_d", "thr_mult"):
        want = np.stack([np.asarray(x) for x in jout[k]], -1)
        got = torch.stack(list(tout[k]), -1).numpy()
        bad = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
        flips += int(bad.any(-1).sum())
    for k in ("terminate", "wspec"):
        flips += int((np.asarray(jout[k]) != tout[k].numpy()).sum())
    np.testing.assert_array_equal(np.asarray(jout["rru"]), tout["rru"].numpy())
    return flips


@pytest.mark.parametrize("name", ["cornell", "mini"])
def test_bounce_physics_matches_jax(name):
    jscene = _jax_scene(name)
    tscene = port_scene_from_jax(jscene)
    port_tables = tb.pack_tables(tscene)
    jax_tables = (
        _pack_gdata(jscene.geoms),
        jb.pack_material_table(jscene.materials),
        jb.pack_light_table(jscene.geoms, jscene.materials),
        jb.pack_scalars(jscene),
    )
    for want, got in zip(jax_tables, port_tables):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tables = dict(
        jax=(*[_jax_values(t) for t in jax_tables[:3]],
             [jnp.float32(v) for v in np.asarray(jax_tables[3])]),
        port=port_tables,
    )

    rs = np.random.default_rng(0)
    u4 = rs.random((N, 4), dtype=np.float32)
    pix = jnp.arange(N, dtype=jnp.int32) % (jscene.camera.width * jscene.camera.height)
    rays = jax_rays(jscene.camera, pix, None, jitter=True, per_ray_uniforms=jnp.asarray(u4))
    o, d = np.asarray(rays.origin), np.asarray(rays.direction)
    ones = np.ones((N, 3), np.float32)

    flips = {}
    for nee in (True, False):
        jout, tout = _run_both(jscene, tables, o, d, ones, np.zeros(N, np.float32), 0, nee)
        flips[(0, nee)] = _compare(jout, tout)
        # depth 3: the rays the first bounce sent on, mixed emit states
        o2 = np.stack([np.asarray(x) for x in jout["next_o"]], -1)
        d2 = np.stack([np.asarray(x) for x in jout["next_d"]], -1)
        prev = rs.integers(0, 3, N).astype(np.float32)
        thr = rs.uniform(0.1, 1.0, (N, 3)).astype(np.float32)
        jout, tout = _run_both(jscene, tables, o2, d2, thr, prev, 3, nee)
        flips[(3, nee)] = _compare(jout, tout)
        if nee:
            assert (prev == 1).any() and (prev == 2).any()
            assert float(torch.stack(list(tout["contrib"])).sum()) > 0
    assert all(v == 0 for v in flips.values()), f"lanes outside tolerance: {flips}"


def test_unsupported_features_raise():
    scene = port_scene_from_jax(_jax_scene("mini"))
    tables = tb.pack_tables(scene)
    z = (torch.zeros(4),) * 3
    for feat in ("texture", "bump", "volumetric", "microfacet", "ward", "hg"):
        with pytest.raises(NotImplementedError, match=feat):
            tb.bounce_physics(
                z, z, z, z, torch.zeros(4), *tables, [torch.zeros(4)] * 11, 0,
                torch.zeros(4), nee=True, t_min=T_MIN, features=frozenset({feat}),
            )

