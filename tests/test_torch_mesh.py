"""Triangle meshes of the PyTorch port against the JAX package, on the CPU:
the host-side data (OBJ loading, displacement, the LBVH build, the scenes'
meshes, the in-kernel tables) and the plain versions of kernels 9 and 10.

Inputs are made with numpy from a seed, or loaded from the repo's scene
files, and handed to both packages.  Tolerances, with their reasons:

* OBJ arrays, displaced triangles, LBVH chunks / boxes / scan order, the
  scenes' mesh arrays and the in-kernel tables' triangles, boxes, corner
  normals and order: equal, element for element (both packages run the
  same float32 numpy, or the same float32 operations in the same order).
* The in-kernel tables' face-normal column ``cross(e1, e2)``: within 1e-6
  of the column's largest magnitude.  The port's equals numpy's float32
  cross; XLA on the CPU contracts its multiply-subtracts (measured up to
  1.9e-9 absolute, 9e-8 of the largest).
* Kernels 9 and 10's plain versions against JAX's interpret-mode kernels:
  miss pattern and winner index equal, ``t`` within ``rtol = 1e-3``, the
  bar of ``tests/test_mesh_pallas.py`` (XLA:CPU's contraction moves a few
  ulps, grazing hits amplify them through ``1 / det``).
* The LBVH traversal (meshes above 8192 triangles) against JAX's: miss
  pattern and winner row equal, ``t`` within 1e-5 relative.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops.accel import build_mesh_accel as jax_build_accel
from pathtracer_tpu.ops.accel import mesh_t_and_normal_accel as jax_traverse
from pathtracer_tpu.ops.bounce_pallas import pack_mesh_tables as jax_pack_mesh_tables
from pathtracer_tpu.ops.mesh_pallas import mesh_min_pallas, mesh_nearest_pallas
from pathtracer_tpu.scene.displace import displace_mesh as jax_displace
from pathtracer_tpu.scene.obj import load_obj_full as jax_load_obj_full
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import accel, mesh, trace
from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
from pathtracer_tpu_torch.ops.mesh_tables import MESH_INKERNEL_MAX_TRIS, pack_mesh_tables
from pathtracer_tpu_torch.render.common import shade_bounce
from pathtracer_tpu_torch.render.megakernel import trace_paths
from pathtracer_tpu_torch.scene.displace import displace_mesh
from pathtracer_tpu_torch.scene.obj import load_obj_full
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.scene.structs import MeshInstance
from tests.test_torch_scene import _compare, port_scene_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
ASSETS = os.path.join(ROOT, "scenes", "assets")
MESH_SCENES = ["smooth_mesh", "mesh_demo", "displace_demo", "deform_demo"]
ACCEL_FIELDS = ("chunks", "lo", "hi", "root_lo", "root_hi", "scan_to_file")


def _equal_or_none(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["ico.obj", "ico_smooth.obj", "ico_squashed.obj"])
def test_load_obj_full_matches_jax(name):
    want = jax_load_obj_full(os.path.join(ASSETS, name))
    got = load_obj_full(os.path.join(ASSETS, name))
    np.testing.assert_array_equal(got.verts, want.verts)
    _equal_or_none(got.uv, want.uv)
    _equal_or_none(got.norm, want.norm)
    assert (got.norm is not None) == (name == "ico_smooth.obj")


def test_displace_and_accel_match_jax():
    """``displace_demo``'s mesh (three levels, 1,280 triangles) and the LBVH
    of it and of the 320-triangle icosphere."""
    ico = load_obj_full(os.path.join(ASSETS, "ico.obj")).verts
    got = displace_mesh(ico, 0.06, 3, "sin", 9.0)
    np.testing.assert_array_equal(got, jax_displace(ico, 0.06, 3, "sin", 9.0))
    assert got.shape == (1280, 3, 3)
    smooth = load_obj_full(os.path.join(ASSETS, "ico_smooth.obj")).verts
    for tris in (got, smooth):
        want, acc = jax_build_accel(tris), accel.build_mesh_accel(tris)
        assert acc.n_tris == want.n_tris == tris.shape[0]
        for k in ACCEL_FIELDS:
            np.testing.assert_array_equal(getattr(acc, k).numpy(), np.asarray(getattr(want, k)),
                                          err_msg=k)


@pytest.mark.parametrize("name,frame", [(n, 0) for n in MESH_SCENES] + [("deform_demo", 1)])
def test_scene_for_frame_meshes_match_jax(name, frame):
    path = os.path.join(ROOT, "scenes", f"{name}.txt")
    jscene = jax_load_scene(path).scene_for_frame(frame)
    tscene = load_scene(path).scene_for_frame(frame, device="cpu")
    _compare(jscene, tscene)
    assert len(tscene.meshes) == len(jscene.meshes) == 1
    for jm, tm in zip(jscene.meshes, tscene.meshes):
        assert tm.geom_index == jm.geom_index and tm.has_attrs == jm.has_attrs
        np.testing.assert_array_equal(tm.tri_verts.numpy(), np.asarray(jm.tri_verts))
        _equal_or_none(None if tm.tri_norm is None else tm.tri_norm.numpy(), jm.tri_norm)
        _equal_or_none(None if tm.tri_uv is None else tm.tri_uv.numpy(), jm.tri_uv)
        assert (tm.accel is None) == (jm.accel is None)
        if tm.accel is not None:
            for k in ACCEL_FIELDS:
                np.testing.assert_array_equal(getattr(tm.accel, k).numpy(),
                                              np.asarray(getattr(jm.accel, k)))
    # the JAX scene crosses into the port with the same mesh arrays
    crossed = port_scene_from_jax(jscene).meshes[0]
    assert torch.equal(crossed.tri_verts, tscene.meshes[0].tri_verts)
    assert torch.equal(crossed.scan_table, tscene.meshes[0].scan_table)


@pytest.mark.parametrize("name", ["smooth_mesh", "mesh_demo", "displace_demo"])
def test_pack_mesh_tables_match_jax(name):
    jscene = jax_load_scene(os.path.join(ROOT, "scenes", f"{name}.txt")).scene_for_frame(0)
    jdescs, jtabs = jax_pack_mesh_tables(jscene.meshes)
    got = pack_mesh_tables(port_scene_from_jax(jscene).meshes)
    assert [d for d, _ in got] == [tuple(d) for d in jdescs]  # has_uv too
    tabs = [t.numpy() for _, ts in got for t in ts]
    assert len(tabs) == len(jtabs)
    tri, jtri = tabs[0].reshape(-1, 12), np.asarray(jtabs[0]).reshape(-1, 12)
    np.testing.assert_array_equal(tri[:, :9], jtri[:, :9])  # order, positions, edges
    fn_err = np.abs(tri[:, 9:] - jtri[:, 9:]).max() / np.abs(jtri[:, 9:]).max()
    print(f"{name}: face normal column within {fn_err:.3g} of its largest")
    assert fn_err <= 1e-6
    for t, j in zip(tabs[1:], jtabs[1:]):  # chunk boxes, corner normals
        np.testing.assert_array_equal(t, np.asarray(j))


def _rand_scene(n, t, seed=0):
    """``tests/test_mesh_pallas.py``'s random triangles (one degenerate) and
    rays, as numpy."""
    rng = np.random.RandomState(seed)
    tris = rng.rand(t, 3, 3).astype(np.float32) * 4 - 2
    tris[1] = tris[1][0]
    o = rng.rand(n, 3).astype(np.float32) * 6 - 3
    d = rng.rand(n, 3).astype(np.float32) - 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tris, o, d


@pytest.mark.parametrize("t_count", [64, 130, 320])
def test_mesh_kernel_plain_versions_match_jax_kernels(t_count):
    tris, o, d = _rand_scene(512, t_count, seed=t_count)
    bt_ref, bi_ref = (np.asarray(x) for x in mesh_nearest_pallas(
        jnp.asarray(tris), jnp.asarray(o), jnp.asarray(d), 1e-4, interpret=True))
    occ_ref = np.asarray(mesh_min_pallas(jnp.asarray(tris), jnp.asarray(o), jnp.asarray(d), 1e-4,
                                         interpret=True))
    table = mesh.pack_tri_table(torch.from_numpy(tris))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    boxes = mesh.table_boxes(table)
    before = (mesh.nearest_launches, mesh.min_launches)
    bt, bi = (x.numpy() for x in mesh.mesh_nearest(table, boxes, ot, dt))  # CPU: plain
    occ = mesh.mesh_min(table, boxes, ot, dt).numpy()
    assert (mesh.nearest_launches, mesh.min_launches) == before
    dense_t, dense_i = mesh.mesh_nearest_plain(table, None, ot, dt)
    assert np.array_equal(bt, dense_t.numpy()) and np.array_equal(bi, dense_i.numpy())
    for t, ref in ((bt, bt_ref), (occ, occ_ref)):
        miss, miss_ref = t >= 1e29, ref >= 1e29
        np.testing.assert_array_equal(miss, miss_ref)
        assert 0.05 < (~miss).mean() < 0.95
        rel = np.abs(t[~miss] - ref[~miss]) / np.abs(ref[~miss])
        print(f"T={t_count}: largest relative t difference {rel.max():.3g}")
        np.testing.assert_allclose(t[~miss], ref[~miss], rtol=1e-3)
    np.testing.assert_array_equal(bi[bt < 1e29], bi_ref[bt < 1e29])
    np.testing.assert_array_equal(bt, occ)


def test_mesh_kernel_tie_rule_and_degenerate_guard():
    """Two equal triangles: index 0 wins, as argmin; a zero-area triangle
    never hits, however the rays meet it."""
    tri = np.array([[[-1, -1, 2], [1, -1, 2], [0, 1, 2]]], np.float32)
    table = mesh.pack_tri_table(torch.from_numpy(np.concatenate([tri, tri])))
    o = torch.zeros((256, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(256, 1)
    for boxes in (mesh.table_boxes(table), None):  # culled and dense
        bt, bi = mesh.mesh_nearest_plain(table, boxes, o, d)
        assert torch.all(bt == 2.0) and torch.all(bi == 0)
    flat = np.zeros((1, 3, 3), np.float32)  # every corner at the origin
    flat_table = mesh.pack_tri_table(torch.from_numpy(np.concatenate([flat, tri])))
    o2 = torch.tensor([[0.0, 0.0, -1.0]]).repeat(256, 1)
    for boxes in (mesh.table_boxes(flat_table), None):
        bt2, bi2 = mesh.mesh_nearest_plain(flat_table, boxes, o2, d)
        assert torch.all(bt2 == 3.0) and torch.all(bi2 == 1)
    assert torch.all(mesh.mesh_min_plain(flat_table[:9], mesh.table_boxes(flat_table[:9]), o2,
                                         d) >= mesh.BIG)


@pytest.mark.parametrize("name", ["smooth_mesh", "displace_demo"])
def test_culled_mesh_query_matches_jax(name):
    """The split route's mesh winner on the CPU, kernel 9's culled plain
    version over the mesh's scan order and chunk boxes, against JAX's
    ``mesh_query`` (its LBVH traversal on the CPU, which culls per chunk
    over the whole wavefront): the miss pattern and every hit's triangle
    row equal, ``t`` within 1e-5 relative, the face normal within 1e-6 of
    its largest; and kernel 10's culled plain version equals kernel 9's
    ``t``."""
    from pathtracer_tpu.ops.intersect import mesh_query as jax_mesh_query

    path = os.path.join(ROOT, "scenes", f"{name}.txt")
    jm = jax_load_scene(path).scene_for_frame(0).meshes[0]
    tm = load_scene(path).scene_for_frame(0, device="cpu").meshes[0]
    rng = np.random.default_rng(5)
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)  # noqa: E731
    o = (unit(rng.standard_normal((2048, 3))) * 1.5).astype(np.float32)
    d = unit(rng.standard_normal((2048, 3)) * 0.4 - o).astype(np.float32)
    want_t, want_n, want_i = (np.asarray(x) for x in jax_mesh_query(
        jm, jnp.asarray(o), jnp.asarray(d), with_index=True))
    got_t, got_n, got_i = (x.numpy() for x in mesh.mesh_query(
        tm, torch.from_numpy(o), torch.from_numpy(d), with_index=True))
    hit = want_t < 1e29
    np.testing.assert_array_equal(got_t < 1e29, hit)
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_array_equal(got_i[hit], want_i[hit])
    np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=1e-5)
    assert np.abs(got_n[hit] - want_n[hit]).max() <= 1e-6 * np.abs(want_n[hit]).max()
    occ = mesh.mesh_occlusion_t(tm, torch.from_numpy(o), torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(occ, got_t)


def test_lbvh_traversal_matches_jax():
    """A mesh above kernel 9's 8,192 triangles takes the LBVH traversal
    (per-chunk skips, host-synced); the ico displaced five levels deep has
    20,480."""
    ico = load_obj_full(os.path.join(ASSETS, "ico.obj")).verts
    tris = displace_mesh(ico, 0.06, 5, "sin", 9.0)
    assert tris.shape[0] > mesh.MESH_KERNEL_MAX_TRIS
    rng = np.random.default_rng(2)
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)  # noqa: E731
    o = (unit(rng.standard_normal((512, 3))) * 1.5).astype(np.float32)
    d = unit(rng.standard_normal((512, 3)) * 0.4 - o).astype(np.float32)
    want_t, _, want_i = (np.asarray(x) for x in jax_traverse(
        jnp.asarray(o), jnp.asarray(d), jax_build_accel(tris), 1e-4, with_index=True))
    acc = accel.build_mesh_accel(tris)
    got_t, _, got_i = (x.numpy() for x in accel.mesh_t_and_normal_accel(
        torch.from_numpy(o), torch.from_numpy(d), acc, with_index=True))
    miss = want_t >= 1e29
    np.testing.assert_array_equal(got_t >= 1e29, miss)
    assert 0.2 < (~miss).mean() < 0.95
    np.testing.assert_array_equal(got_i[~miss], want_i[~miss])
    np.testing.assert_allclose(got_t[~miss], want_t[~miss], rtol=1e-5)
    # the split route's dispatch takes the traversal above the kernels' cap,
    # and refuses a mesh that large without its LBVH
    inst = MeshInstance(geom_index=0, tri_verts=torch.from_numpy(tris), accel=acc)
    q_t, _, q_i = mesh.mesh_query(inst, torch.from_numpy(o), torch.from_numpy(d), with_index=True)
    assert torch.equal(q_t, torch.from_numpy(got_t)) and torch.equal(q_i, torch.from_numpy(got_i))
    with pytest.raises(ValueError, match="needs its LBVH"):
        mesh.mesh_query(dataclasses.replace(inst, accel=None), torch.from_numpy(o),
                        torch.from_numpy(d))


def test_meshes_above_the_in_kernel_cap_raise_on_the_fused_routes():
    """Above 4,096 triangles the fused routes run kernel 2's mesh-merge
    variant, as JAX's do (the name is from when they raised): the
    megakernel route (the per-bounce scan), ``fused=True`` and the wavefront
    engine's ``shade_bounce`` give the split route's bounce: terminate,
    emit states and the russian-roulette uniform equal on every lane, the
    float outputs within ``tests/test_torch_shade.py``'s rtol 2e-4 / atol
    2e-5 (the split route shades in PyTorch, the merge variant in the
    kernels' order); the traces' ray counts equal."""
    desc = load_scene(os.path.join(ROOT, "scenes", "displace_demo.txt"))
    ico = load_obj_full(os.path.join(ASSETS, "ico.obj")).verts
    big = displace_mesh(ico, 0.06, 4, "sin", 9.0)  # 5,120 triangles
    assert big.shape[0] > MESH_INKERNEL_MAX_TRIS
    desc = dataclasses.replace(desc, resolution=(6, 4),
                               mesh_tris=tuple(big if t is not None else None
                                               for t in desc.mesh_tris))
    scene = desc.scene_for_frame(0, device="cpu")
    assert not trace.fused_trace_eligible(scene, RenderConfig())
    pixel = torch.arange(24)
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(0, pixel))
    glossy = dict(features=("glossy",))
    args = (scene, rays, torch.ones((24, 3)), pixel, 0, torch.zeros(24), 0)
    split = shade_bounce(*args, RenderConfig(fused=False, **glossy))
    for cfg in (RenderConfig(**glossy), RenderConfig(fused=True, **glossy),
                RenderConfig(wavefront=True, **glossy)):
        got = shade_bounce(*args, cfg)
        assert torch.equal(got.terminate, split.terminate)
        assert torch.equal(got.was_specular, split.was_specular)
        assert torch.equal(got.rr_uniform, split.rr_uniform)
        for f in ("contrib", "next_origin", "next_direction", "throughput_mult"):
            torch.testing.assert_close(getattr(got, f), getattr(split, f), rtol=2e-4, atol=2e-5)
    rad_s, n_s = trace_paths(scene, rays, pixel, 0, RenderConfig(fused=False, max_depth=2, **glossy))
    rad_m, n_m = trace_paths(scene, rays, pixel, 0, RenderConfig(max_depth=2, **glossy))
    assert bool(torch.isfinite(rad_m).all()) and int(n_m) == int(n_s) > 0
    torch.testing.assert_close(rad_m, rad_s, rtol=2e-4, atol=2e-5)
