"""The kernels' per-lane code, built for the host CPU, against the plain
versions.

Every source of ``pathtracer_tpu_torch/csrc/`` keeps the arithmetic of a
lane in functions that also compile as plain C++: the trace
(``trace.cu``), the forward with residuals and the hand-written adjoint of
the reverse loop (``trace_grad.cu``), one bounce (``bounce.cu``) and its
backward (``bounce_grad.cu``), the nearest hit, the winner search and the
occlusion sweep (``intersect.cu``).  This test builds
them with the host's C++ compiler (``tests/kernel_host_harness.cpp``, no
contraction of a*b+c, as ``nvcc -fmad=false``) and runs them lane after
lane, so their logic is checked on every CPU run;
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` check the CUDA
build itself on the card.

Tolerances, with the reason: equal ray counts.  On MINI_SCENE (diffuse,
mirror, glass, area light; depth 3, russian roulette, NEE on and off) and
on its variant with a Phong-glossy sphere, radiance and residuals within
2e-6 on every lane.  On Cornell 48x48 at
depth 8, radiance on 99.5% of lanes and every residual plane of a lane on
98% of lanes (measured 99.957% and 98.83%): the host's libm
sin/cos/exp/log and its ``rsqrtf = 1/sqrtf`` round differently from
torch's CPU kernels, and eight bounces carry that into later bounces'
carries.  The reverse lanes run on the plain version's residuals and are
held to its float64 reference (``tbwd_plain(dtype=torch.float64)``:
float64 autograd at the float32 bounce's values, as the kernel's adjoint
runs in double at them): every table cotangent within 1e-4 of itself plus
1e-6 of the largest magnitude in its table (measured: below 4e-6 of the
largest), every component of d_origin / d_direction within rtol = atol =
1e-5 on every lane.  The float32 plain version misses that element-wise
bar on up to 0.14% of Cornell's lanes, where a component is the small
difference of large terms that float32 autograd rounds (the share is
printed under ``pytest -s``).  Kernel 3's lanes (one bounce's backward, on
random lanes with random cotangents on every lane, misses and light hits
included) are held to ``bounce_bwd_plain``'s float64 reference at the same
bars, every lane; kernel 2's replay planes and kernel 7's t and gid equal
their plain versions on every lane.  The participating-media instances
(``kVol`` / ``kHg`` of kernels 1 and 2, and kernel 1m's triangle split
``pt::mesh_occ_split``) are held to their plain versions at the vacuum
cases' bars, on media scenes and on random lanes with seeded medium
carries.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad, mesh, trace, trace_grad
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
from pathtracer_tpu_torch.ops.intersect import (
    nearest_hit_plain,
    occlusion_t_plain,
    winner_t_gid_plain,
)
from pathtracer_tpu_torch.ops.rng import hash_uniforms_planes
from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
from pathtracer_tpu_torch.scene.structs import Rays
from tests.test_bounce_grad import MINI_SCENE
from tests.test_torch_shade import random_lanes

HERE = os.path.dirname(os.path.abspath(__file__))
P, I = ctypes.c_void_p, ctypes.c_int
NO_MESH = (None, None, None, None, None, 0)  # the launchers' mesh arguments for no meshes
VACUUM = (0, 0, 1)  # the launchers' media arguments (volumetric, hg, vol_nee) for vacuum
# the gradient kernels' media and surface arguments (volumetric, vol_nee, surface
# bits) for vacuum without the surface blocks
VAC_GRAD = (0, 1, 0)
NO_MEDIUM = (None, None, None)  # kernel 3's medium, its cotangent, d_medium (vacuum)
# the bounce launcher's surface bits and deferred-texel planes for neither
NO_SURF = (0, None, None, None)
# MINI_SCENE with its mirror sphere turned Phong-glossy (specular exponent 30)
GLOSSY_MINI = MINI_SCENE.replace("SPECEX 0\nSPECRGB .95 .92 .9", "SPECEX 30\nSPECRGB .95 .92 .9")
assert GLOSSY_MINI != MINI_SCENE
# a second area light, on Cornell's red wall (its material 5): a lane's NEE
# connections sample either, so the reverse lanes' light sums hold one light
# and add the other's columns to the row at once (about one lane in ten
# connects to both at depth 4)
SECOND_LIGHT = """
OBJECT 9
cube
material 5
frame 0
TRANS -4.9 7 0
ROTAT 0 0 0
SCALE .3 2 2
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler on the host")
    out = str(tmp_path_factory.mktemp("kernel_host") / "libtrace_grad_host.so")
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-Wno-unknown-pragmas", "-shared",
         "-fPIC", "-o", out, os.path.join(HERE, "kernel_host_harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(out)
    lib.host_fwd.argtypes = [P, I, P, P, P, ctypes.c_uint, P, P, P, I, P, P, P] + [I] * 7
    lib.host_bwd.argtypes = [P, I, P, I, P, P, ctypes.c_uint, P, I, P, P, P, P, P] + [I] * 7
    lib.host_lane_keys.argtypes = [P, P, P, I, I, I, P]
    lib.host_trace.argtypes = [P, I, P, P, P, ctypes.c_uint, P, P, P, I, P, P, I, I, I, I,
                               I, I, I, I, P, P, P, P, P, I]
    lib.host_trace_sched.argtypes = lib.host_trace.argtypes + [I]
    lib.host_bounce.argtypes = ([P, I, P, P, P, ctypes.c_uint, I, I] + [P] * 17 + [I] * 5
                                + [P] * 3 + [P] * 5 + [I])
    lib.host_bounce_merge.argtypes = ([P, I, P, P, P, ctypes.c_uint, I, I] + [P] * 15
                                      + [I] * 5 + [P] * 6)
    lib.host_mesh_nearest.argtypes = [P, I, P, I, P, P, P, P]
    lib.host_mesh_min.argtypes = [P, I, P, I, P, P, P]
    lib.host_nearest.argtypes = [P, I, I] + [P] * 8
    lib.host_occlusion.argtypes = [P, I, I, P, P, P]
    lib.host_winner.argtypes = [P, I, I, P, P, P, P]
    lib.host_mesh_sweep.argtypes = [P] * 6 + [I, I, I] + [P] * 7
    lib.host_mesh_occ.argtypes = [P] * 6 + [I, I] + [P] * 4
    lib.host_bounce_bwd.argtypes = ([P, I, P, I, P, P, ctypes.c_uint, I, I] + [P] * 16 + [I] * 3
                                    + [P] * 3 + [P])
    lib.host_bounce_bwd_keys.argtypes = [P, P, I] + [P] * 7
    lib.host_fwd_packed.argtypes = lib.host_fwd.argtypes + [I]
    lib.host_bounce_blocks.argtypes = ([P, I, P, P, P, ctypes.c_uint, I, I] + [P] * 15 + [I]
                                       + [P] * 3 + [P] * 5 + [I, P, I])
    lib.host_bounce_grouped.argtypes = ([P, I, P, P, P, ctypes.c_uint, I, I] + [P] * 17
                                        + [I, I, P, I])
    lib.host_event_keys.argtypes = [P, I, P, P, P, ctypes.c_uint, I] + [P] * 5 + [I, P]
    return lib


# scene, resolution, options, least shares of lanes: radiance, residuals
CASES = {
    "mini_nee_rr": ("mini", (37, 23), dict(max_depth=3, nee=True, rr=True, rr_start=1),
                    (1.0, 1.0)),
    "mini_rr": ("mini", (37, 23), dict(max_depth=3, nee=False, rr=True, rr_start=1),
                (1.0, 1.0)),
    "glossy_nee": ("glossy", (37, 23), dict(max_depth=3, nee=True, rr=False, rr_start=3),
                   (1.0, 1.0)),
    "cornell_two_lights": ("cornell_two_lights", (24, 24),
                           dict(max_depth=4, nee=True, rr=False, rr_start=3), (0.995, 0.98)),
    "cornell_d8": ("cornell", (48, 48), dict(max_depth=8, nee=True, rr=False, rr_start=3),
                   (0.995, 0.98)),
    # every lane aimed within 1e-3 of the point Cornell's centre pixel hits:
    # all first hits on one geom, every lane adding to the same columns
    # (the reverse kernel's lane sums and row) from the first bounce on.
    # Residuals on 97% of lanes (measured 97.7%): the lanes start alike, so
    # the host libm's last bits part more of them at the same later bounces
    # than on camera rays; the reverse lanes keep the strict bars.
    "cornell_one_geom": ("cornell", (24, 24),
                         dict(max_depth=8, nee=True, rr=False, rr_start=3), (0.995, 0.97)),
}


def one_geom_rays(scene, seed: int, n: int):
    """``n`` rays from the camera through points within 1e-3 of the point
    its centre pixel's ray hits, and that geom's index."""
    w, h = scene.camera.width, scene.camera.height
    centre = torch.tensor([(h // 2) * w + w // 2])
    ray = generate_camera_rays(scene.camera, centre, camera_uniforms(seed, centre))
    t, gid = winner_t_gid_plain(ray, pack_tables(scene)[0])
    aim = ray.origin[0] + t[0] * ray.direction[0]
    jitter = np.random.default_rng(23).uniform(-1e-3, 1e-3, (n, 3)).astype(np.float32)
    to = aim + torch.from_numpy(jitter) - ray.origin[0]
    return Rays(ray.origin.expand(n, 3).contiguous(), to / to.norm(dim=-1, keepdim=True)), \
        int(gid[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_lanes_match_plain(host_lib, case):
    name, res, kw, (min_rad, min_res) = CASES[case]
    if name in ("mini", "glossy"):
        desc = parse_scene_text(MINI_SCENE if name == "mini" else GLOSSY_MINI, name=name)
    else:
        desc = load_scene(os.path.join(HERE, "..", "scenes", "cornell.txt"))
    if name == "cornell_two_lights":
        with open(os.path.join(HERE, "..", "scenes", "cornell.txt")) as f:
            desc = parse_scene_text(f.read() + SECOND_LIGHT, name=name)
    scene = dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cpu")
    n = res[0] * res[1]
    seed = 1234
    pixel = torch.arange(n)
    sample = 3 * n + pixel
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
    tables = [t.contiguous() for t in pack_tables(scene)]
    if case == "cornell_one_geom":
        rays, gid = one_geom_rays(scene, seed, n)
        assert bool((winner_t_gid_plain(rays, tables[0])[1] == gid).all())
    g, m = tables[0].shape[0], tables[1].shape[0]
    bits = sample.to(torch.int32)  # indices below 2^31: their uint32 bits
    flags = (kw["max_depth"], int(kw["nee"]), int(kw["rr"]), kw["rr_start"])

    rad_p, nr_p, res_p = trace_grad.tfwd_plain(*tables, seed, rays.origin, rays.direction,
                                               sample, **kw)
    rad_k = torch.empty((n, 3))
    res_k = torch.empty_like(res_p)
    nr_k = ctypes.c_ulonglong()
    host_lib.host_fwd(tables[0].data_ptr(), g, tables[1].data_ptr(), tables[2].data_ptr(),
                      tables[3].data_ptr(), seed, rays.origin.data_ptr(),
                      rays.direction.data_ptr(), bits.data_ptr(), n, rad_k.data_ptr(),
                      ctypes.byref(nr_k), res_k.data_ptr(), *flags, *VAC_GRAD)
    assert nr_k.value == int(nr_p)
    rad_frac = float(torch.isclose(rad_k, rad_p, rtol=2e-6, atol=2e-6).all(-1).float().mean())
    res_frac = float(
        torch.isclose(res_k, res_p, rtol=2e-6, atol=2e-6).all(0).all(0).float().mean()
    )

    g_rad = torch.from_numpy(np.random.default_rng(5).standard_normal((n, 3)).astype(np.float32))
    want = trace_grad.tbwd_plain(*tables, seed, sample, res_p, g_rad, dtype=torch.float64,
                                 **kw)
    want32 = trace_grad.tbwd_plain(*tables, seed, sample, res_p, g_rad, **kw)
    d_o, d_d = torch.empty((n, 3)), torch.empty((n, 3))
    row = torch.empty(trace_grad.grad_row_len(g, m))
    host_lib.host_bwd(tables[0].data_ptr(), g, tables[1].data_ptr(), m, tables[2].data_ptr(),
                      tables[3].data_ptr(), seed, bits.data_ptr(), n, res_p.data_ptr(),
                      g_rad.data_ptr(), d_o.data_ptr(), d_d.data_ptr(), row.data_ptr(), *flags,
                      *VAC_GRAD)
    got = tuple(t.double() for t in (*trace_grad.split_grad_row(row, g, m), d_o, d_d))

    def lane_frac(a, b):
        return float(torch.isclose(a.double(), b, rtol=1e-5, atol=1e-5).all(-1).double().mean())

    table_rel = [
        float((k - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        for w, k in zip(want[:4], got[:4])
    ]
    print(f"{case}: lanes within 2e-6: radiance {rad_frac:.5f}, residuals {res_frac:.5f}; "
          f"reverse lanes within 1e-5 of the float64 reference: kernel "
          f"{[lane_frac(k, w) for k, w in zip(got[4:], want[4:])]}, float32 plain "
          f"{[lane_frac(p, w) for p, w in zip(want32[4:], want[4:])]}; "
          f"table errors / max: {table_rel}")
    assert rad_frac >= min_rad and res_frac >= min_res
    for w, k in zip(want[:4], got[:4]):
        # every entry, small ones too (a material's specular exponent has a
        # gradient thousands of times below the table's largest)
        assert bool(((k - w).abs() <= 1e-4 * w.abs() + 1e-6 * float(w.abs().max())).all())
    for w, k in zip(want[4:], got[4:]):
        assert bool(torch.isclose(k, w, rtol=1e-5, atol=1e-5).all())
    assert all(bool(torch.isfinite(t).all()) for t in got)
    if kw["nee"]:
        assert float(want[0].abs().max()) > 0 and float(d_d.abs().max()) > 0


# ---- kernel 1 after the split of the loop body, kernel 2, kernels 6 and 8


def _case_inputs(name, res):
    if name in ("mini", "glossy"):
        desc = parse_scene_text(MINI_SCENE if name == "mini" else GLOSSY_MINI, name=name)
    else:
        desc = load_scene(os.path.join(HERE, "..", "scenes", "cornell.txt"))
    if name == "cornell_two_lights":
        with open(os.path.join(HERE, "..", "scenes", "cornell.txt")) as f:
            desc = parse_scene_text(f.read() + SECOND_LIGHT, name=name)
    scene = dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cpu")
    return scene, [t.contiguous() for t in pack_tables(scene)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_lanes_match_plain_and_forward(host_lib, case):
    """Kernel 1's lanes (``trace.cu:trace_lane`` over ``pt::bounce_step``)
    against ``trace_plain`` at the forward test's radiance bars (measured:
    99.87% of Cornell's lanes within 2e-6, every lane of the others), and
    bit-equal to the forward-with-residuals lanes, ray counts too (the two
    kernels share the loop body)."""
    name, res, kw, (min_rad, _) = CASES[case]
    scene, tables = _case_inputs(name, res)
    n, seed = res[0] * res[1], 99
    pixel = torch.arange(n)
    sample = 5 * n + pixel
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
    g = tables[0].shape[0]
    bits = sample.to(torch.int32)
    flags = (kw["max_depth"], int(kw["nee"]), int(kw["rr"]), kw["rr_start"])
    common = (tables[0].data_ptr(), g, tables[1].data_ptr(), tables[2].data_ptr(),
              tables[3].data_ptr(), seed, rays.origin.data_ptr(), rays.direction.data_ptr(),
              bits.data_ptr(), n)
    rad_k, nr_k = torch.empty((n, 3)), ctypes.c_ulonglong()
    host_lib.host_trace(*common, rad_k.data_ptr(), ctypes.byref(nr_k), *flags, *VACUUM, 0,
                        *NO_MESH)
    rad_f, nr_f = torch.empty((n, 3)), ctypes.c_ulonglong()
    resid = torch.empty((kw["max_depth"], trace_grad.N_RESID, n))
    host_lib.host_fwd(*common, rad_f.data_ptr(), ctypes.byref(nr_f), resid.data_ptr(), *flags,
                      *VAC_GRAD)
    rad_p, nr_p = trace.trace_plain(*tables, seed, rays.origin, rays.direction, sample, **kw)
    frac = float(torch.isclose(rad_k, rad_p, rtol=2e-6, atol=2e-6).all(-1).float().mean())
    print(f"{case}: trace lanes within 2e-6 of trace_plain: {frac:.5f}")
    assert nr_k.value == nr_f.value == int(nr_p)
    assert torch.equal(rad_k, rad_f)
    assert frac >= min_rad


def _bounce_args(scene_name, n, seed):
    scene, tables = _case_inputs(scene_name, (8, 8))
    lanes = {k: torch.from_numpy(v) for k, v in random_lanes(n, seed=seed).items()}
    medium = torch.zeros((n, 4))
    return tables, lanes, medium


@pytest.mark.parametrize("scene_name", ["cornell", "glossy"])
@pytest.mark.parametrize("nee", [True, False])
def test_bounce_lanes_match_plain(host_lib, scene_name, nee):
    """Kernel 2's lanes (``bounce.cu:bounce_lane``, the mask-free
    ``pt::bounce``) against ``bounce_fused_plain`` on 2,048 random lanes at
    mixed depth and emit state.  Every one of the 19 outputs is defined on
    every lane, terminated lanes too (the kernel's contract): terminate, emit
    state and the russian-roulette uniform equal on every lane, the float
    planes within 2e-6 on at least 99.5% of lanes, room for the host's libm
    sin/cos to round a sampled direction differently from torch's
    (measured: every lane, printed under ``pytest -s``)."""
    n, seed = 2048, 77
    tables, t, medium = _bounce_args(scene_name, n, 21)
    want = bounce_fused.bounce_fused_plain(
        tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(), t["depth"],
        t["prev"], medium, seed, nee=nee,
    )
    f32 = dict(dtype=torch.float32)
    contrib, next_o, next_d, thr_mult = (torch.empty((n, 3), **f32) for _ in range(4))
    terminate = torch.empty(n, dtype=torch.uint8)
    wspec, rru, out_medium = torch.empty(n), torch.empty(n), torch.empty((n, 4))
    host_lib.host_bounce(
        tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(), tables[2].data_ptr(),
        tables[3].data_ptr(), seed, int(nee), n, t["origin"].data_ptr(),
        t["direction"].data_ptr(), t["throughput"].data_ptr(), t["sample"].data_ptr(),
        t["depth"].data_ptr(), t["prev"].data_ptr(), medium.data_ptr(), contrib.data_ptr(),
        next_o.data_ptr(), next_d.data_ptr(), thr_mult.data_ptr(), terminate.data_ptr(),
        wspec.data_ptr(), rru.data_ptr(), out_medium.data_ptr(), None, None, *VACUUM, 4,
        *NO_SURF, *NO_MESH,
    )
    assert torch.equal(terminate.bool(), want.terminate)
    assert 0.05 < float(want.terminate.float().mean()) < 0.95
    assert torch.equal(wspec, want.was_specular) and torch.equal(rru, want.rr_uniform)
    assert torch.equal(out_medium, want.next_medium)
    close = torch.ones(n, dtype=torch.bool)
    for got, ref in ((contrib, want.contrib), (next_o, want.next_origin),
                     (next_d, want.next_direction), (thr_mult, want.throughput_mult)):
        close &= torch.isclose(got, ref, rtol=2e-6, atol=2e-6).all(-1)
    frac = float(close.float().mean())
    print(f"{scene_name} nee={nee}: bounce lanes with every plane within 2e-6: {frac:.5f}")
    assert frac >= 0.995
    assert float(contrib.abs().max()) > 0


@pytest.mark.parametrize("scene_name", ["cornell", "glossy"])
def test_intersect_lanes_match_plain(host_lib, scene_name):
    """Kernels 6 and 8's lanes against ``nearest_hit_plain`` /
    ``occlusion_t_plain``: t, gid and mid equal; the frame within 2e-6
    (the host's ``rsqrtf`` is ``1/sqrtf``, as torch's CPU ``rsqrt``)."""
    n = 2048
    tables, t, _ = _bounce_args(scene_name, n, 4)
    gtab = tables[0]
    want = nearest_hit_plain(Rays(t["origin"], t["direction"]), gtab)
    want_occ = occlusion_t_plain(Rays(t["origin"], t["direction"]), gtab)
    t_k, gid, mid = torch.empty(n), torch.empty(n, dtype=torch.int32), torch.empty(
        n, dtype=torch.int32)
    p, p_obj, normal = (torch.empty((n, 3)) for _ in range(3))
    host_lib.host_nearest(gtab.data_ptr(), gtab.shape[0], n, t["origin"].data_ptr(),
                          t["direction"].data_ptr(), t_k.data_ptr(), gid.data_ptr(),
                          mid.data_ptr(), p.data_ptr(), p_obj.data_ptr(), normal.data_ptr())
    occ = torch.empty(n)
    host_lib.host_occlusion(gtab.data_ptr(), gtab.shape[0], n, t["origin"].data_ptr(),
                            t["direction"].data_ptr(), occ.data_ptr())
    assert torch.equal(t_k, want.t) and torch.equal(occ, want_occ)
    assert torch.equal(gid, want.geom_id) and torch.equal(mid, want.material_id)
    for got, ref in ((p, want.position), (p_obj, want.position_obj), (normal, want.normal)):
        torch.testing.assert_close(got, ref, rtol=2e-6, atol=2e-6)


def _host_bounce(host_lib, tables, t, medium, seed, nee, replay=True):
    """Kernel 2's lanes with the replay planes: ``(outputs, replay_gid,
    replay_nee)``."""
    n = t["origin"].shape[0]
    outs = [torch.empty((n, 3)) for _ in range(4)] + [
        torch.empty(n, dtype=torch.uint8), torch.empty(n), torch.empty(n), torch.empty((n, 4))]
    rgid, rnee = torch.empty(n), torch.empty(n)
    host_lib.host_bounce(
        tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(), tables[2].data_ptr(),
        tables[3].data_ptr(), seed, int(nee), n,
        *(t[k].data_ptr() for k in ("origin", "direction", "throughput", "sample", "depth",
                                    "prev")),
        medium.data_ptr(), *(o.data_ptr() for o in outs), rgid.data_ptr(), rnee.data_ptr(),
        *VACUUM, 4, *NO_SURF, *NO_MESH,
    )
    return outs, rgid, rnee


@pytest.mark.parametrize("scene_name", ["cornell", "glossy"])
@pytest.mark.parametrize("nee", [True, False])
def test_bounce_replay_and_backward_lanes_match_plain(host_lib, scene_name, nee):
    """Kernel 2's replay planes equal ``bounce_fused_plain(emit_replay=True)``'s
    on every lane, and kernel 3's lanes (``bounce_grad.cu:bounce_bwd_lane``)
    on those planes, with seeded cotangents on every lane, meet the float64
    reference of ``bounce_bwd_plain`` at the module's bars on every lane:
    misses and light hits included (the mask-free contract)."""
    n, seed = 2048, 77
    tables, t, medium = _bounce_args(scene_name, n, 31)
    args = (tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(),
            t["depth"], t["prev"], medium, seed)
    want, want_gid, want_nee = bounce_fused.bounce_fused_plain(*args, nee=nee, emit_replay=True)
    _, rgid, rnee = _host_bounce(host_lib, tables, t, medium, seed, nee)
    assert torch.equal(rgid, want_gid) and torch.equal(rnee, want_nee)
    miss, light = (rgid < 0), (~(rgid < 0)) & want.terminate
    assert int(miss.sum()) > 0 and int(light.sum()) > 0
    if nee:
        assert int((rnee > 0).sum()) > 0

    r = np.random.default_rng(6)
    cots = [torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32)) for _ in range(4)]
    bargs = (tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(),
             t["depth"], t["prev"], rgid, rnee, *cots, seed)
    ref = bounce_grad.bounce_bwd_plain(*bargs, nee=nee, dtype=torch.float64)
    f32 = bounce_grad.bounce_bwd_plain(*bargs, nee=nee)
    g, m = tables[0].shape[0], tables[1].shape[0]
    d_o, d_d, d_t = (torch.empty((n, 3)) for _ in range(3))
    row = torch.empty(trace_grad.grad_row_len(g, m))
    host_lib.host_bounce_bwd(
        tables[0].data_ptr(), g, tables[1].data_ptr(), m, tables[2].data_ptr(),
        tables[3].data_ptr(), seed, int(nee), n,
        *(t[k].data_ptr() for k in ("origin", "direction", "throughput", "sample", "depth",
                                    "prev")),
        rgid.data_ptr(), rnee.data_ptr(), *(c.data_ptr() for c in cots),
        d_o.data_ptr(), d_d.data_ptr(), d_t.data_ptr(), row.data_ptr(), *VAC_GRAD, *NO_MEDIUM,
        None,
    )
    got = (*trace_grad.split_grad_row(row, g, m), d_o, d_d, d_t)
    frac = [float(torch.isclose(k.double(), w, rtol=1e-5, atol=1e-5).all(-1).double().mean())
            for k, w in zip(got[4:], ref[4:])]
    frac32 = [float(torch.isclose(p.double(), w, rtol=1e-5, atol=1e-5).all(-1).double().mean())
              for p, w in zip(f32[4:], ref[4:])]
    print(f"{scene_name} nee={nee}: {int(miss.sum())} misses, {int(light.sum())} light hits; "
          f"lanes within 1e-5 of the float64 reference: kernel {frac}, float32 plain {frac32}")
    for w, k in zip(ref[:4], got[:4]):
        assert bool(((k.double() - w).abs() <= 1e-4 * w.abs() + 1e-6 * float(w.abs().max())).all())
    for w, k in zip(ref[4:], got[4:]):
        assert bool(torch.isclose(k.double(), w, rtol=1e-5, atol=1e-5).all())
    assert all(bool(torch.isfinite(x).all()) for x in got)
    # zero cotangents give exact zeros on every lane
    zero = torch.zeros((n, 3))
    host_lib.host_bounce_bwd(
        tables[0].data_ptr(), g, tables[1].data_ptr(), m, tables[2].data_ptr(),
        tables[3].data_ptr(), seed, int(nee), n,
        *(t[k].data_ptr() for k in ("origin", "direction", "throughput", "sample", "depth",
                                    "prev")),
        rgid.data_ptr(), rnee.data_ptr(), *(zero.data_ptr() for _ in cots),
        d_o.data_ptr(), d_d.data_ptr(), d_t.data_ptr(), row.data_ptr(), *VAC_GRAD, *NO_MEDIUM,
        None,
    )
    assert not bool(torch.cat([d_o, d_d, d_t, row[None].expand(3, -1).reshape(-1, 3)]).any())
    # a third of the lanes dead (every cotangent zero, as the per-bounce
    # engine gives a lane that died earlier): those skip the adjoint, and the
    # rest still meet the reference
    dead = (torch.arange(n) % 3 == 0)[:, None]
    dcots = [torch.where(dead, 0.0, c) for c in cots]
    dargs = (*bargs[:9], *dcots, seed)
    dref = bounce_grad.bounce_bwd_plain(*dargs, nee=nee, dtype=torch.float64)
    host_lib.host_bounce_bwd(
        tables[0].data_ptr(), g, tables[1].data_ptr(), m, tables[2].data_ptr(),
        tables[3].data_ptr(), seed, int(nee), n,
        *(t[k].data_ptr() for k in ("origin", "direction", "throughput", "sample", "depth",
                                    "prev")),
        rgid.data_ptr(), rnee.data_ptr(), *(c.data_ptr() for c in dcots),
        d_o.data_ptr(), d_d.data_ptr(), d_t.data_ptr(), row.data_ptr(), *VAC_GRAD, *NO_MEDIUM,
        None,
    )
    dgot = (*trace_grad.split_grad_row(row, g, m), d_o, d_d, d_t)
    for w, k in zip(dref[:4], dgot[:4]):
        assert bool(((k.double() - w).abs() <= 1e-4 * w.abs() + 1e-6 * float(w.abs().max())).all())
    for w, k in zip(dref[4:], dgot[4:]):
        assert bool(torch.isclose(k.double(), w, rtol=1e-5, atol=1e-5).all())
        assert not bool(k[dead[:, 0]].any())


def _bwd_case(name, n):
    """Random lanes of kernel 3's instances: ``(tables, lanes, medium,
    features)``; cornell in vacuum (3), ggx_ward with its surface features
    (3s), vol_mini with seeded medium carries (3v)."""
    if name == "vol_mini":
        tables, t, medium = _vol_lanes(name, n, 13)
        return tables, t, medium, frozenset({"volumetric"})
    if name == "ggx_ward":
        _, tables, feats = _surf_grad_scene(name, (8, 8))
        lanes = random_lanes(n, seed=47)
        lanes["origin"] = (lanes["origin"] * 0.8 + np.array(CENTRES[name])).astype(np.float32)
        t = {k: torch.from_numpy(v) for k, v in lanes.items()}
        return tables, t, torch.zeros((n, 4)), feats
    tables, t, medium = _bounce_args(name, n, 31)
    return tables, t, medium, frozenset()


@pytest.mark.parametrize("name", ["cornell", "ggx_ward", "vol_mini"])
def test_bounce_bwd_keys_and_lane_order(host_lib, name):
    """Kernel 3s's lane keys (``bounce_grad.cu:bounce_bwd_key``) equal
    ``bounce_grad.bounce_bwd_keys_plain``'s on every lane, a third of the
    lanes with zero cotangents (the dead lanes of the per-bounce engine,
    which take the last key); and kernel 3 (3s on ggx_ward, 3v on
    vol_mini, each lane's winner rows in its row sums in 3 and 3s) run in
    a lane order grouped by key (within a key in a random order, as the
    card's place pass leaves it) gives every lane's d_origin, d_direction,
    d_throughput (and d_medium) bit-equal to index order, and a table row
    within the float64 reference's bars (every cotangent within 1e-4 of
    itself plus 1e-6 of its table's largest)."""
    n, seed = 2048, 77
    tables, t, medium, feats = _bwd_case(name, n)
    vol, surf = int("volumetric" in feats), trace.surface_bits(feats)
    keys = ("origin", "direction", "throughput", "sample", "depth", "prev")
    args = (tables, *(t[k].long() if k == "sample" else t[k] for k in keys))
    _, rgid, rnee = bounce_fused.bounce_fused_plain(*args, medium, seed, nee=True,
                                                    features=feats, emit_replay=True)
    r = np.random.default_rng(8)
    dead = (torch.arange(n) % 3 == 0)[:, None]
    cots = [torch.where(dead, 0.0, torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32)))
            for _ in range(4)]
    g_med = torch.where(dead, 0.0, torch.from_numpy(r.standard_normal((n, 4)).astype(np.float32)))
    want = bounce_grad.bounce_bwd_keys_plain(tables[0], tables[1], rgid, rnee, cots)
    got = torch.empty(n, dtype=torch.int32)
    host_lib.host_bounce_bwd_keys(tables[0].data_ptr(), tables[1].data_ptr(), n,
                                  rgid.data_ptr(), rnee.data_ptr(), *(c.data_ptr() for c in cots),
                                  got.data_ptr())
    counts = torch.bincount(want, minlength=256)
    print(f"{name}: lanes per key {({k: int(c) for k, c in enumerate(counts) if c})}")
    assert torch.equal(got, want)
    assert int(counts[bounce_grad.KEY_ZERO]) == int(dead.sum())
    assert int(counts[bounce_grad.KEY_MISS]) > 0 and len(torch.unique(want)) >= 4
    if name == "ggx_ward":
        assert int(counts[bounce_grad.KEY_LOBE]) > 0

    order = torch.from_numpy(np.lexsort((r.random(n), want.numpy())).astype(np.int32))
    assert torch.equal(want[order.long()], torch.sort(want).values)
    g, m = tables[0].shape[0], tables[1].shape[0]
    bargs = (*args, rgid, rnee, *cots, seed)
    bkw = dict(nee=True, features=feats)
    if vol:
        bkw.update(medium=medium, g_medium=g_med)
    ref = bounce_grad.bounce_bwd_plain(*bargs, dtype=torch.float64, **bkw)
    runs = []
    for lane_order in (None, order):
        outs = [torch.empty((n, 3)) for _ in range(3)] + [torch.empty((n, 4))]
        row = torch.empty(trace_grad.grad_row_len(g, m))
        host_lib.host_bounce_bwd(
            tables[0].data_ptr(), g, tables[1].data_ptr(), m, tables[2].data_ptr(),
            tables[3].data_ptr(), seed, 1, n, *(t[k].data_ptr() for k in keys),
            rgid.data_ptr(), rnee.data_ptr(), *(c.data_ptr() for c in cots),
            *(o.data_ptr() for o in outs[:3]), row.data_ptr(), vol, 1, surf,
            *((medium.data_ptr(), g_med.data_ptr(), outs[3].data_ptr()) if vol else NO_MEDIUM),
            None if lane_order is None else lane_order.data_ptr(),
        )
        runs.append((trace_grad.split_grad_row(row, g, m), outs[:3 + vol]))
    (row_i, lanes_i), (row_o, lanes_o) = runs
    for a, b in zip(lanes_i, lanes_o):
        assert torch.equal(a, b)
    for row in (row_i, row_o):
        for w, k in zip(ref[:4], row):
            bar = 1e-4 * w.abs() + 1e-6 * float(w.abs().max())
            assert bool(((k.double() - w).abs() <= bar).all())
    assert not bool(torch.cat([x[dead[:, 0]].reshape(-1) for x in lanes_o]).any())


@pytest.mark.parametrize("scene_name", ["cornell", "glossy"])
def test_winner_lanes_match_plain(host_lib, scene_name):
    """Kernel 7's lanes (``intersect.cu:winner_lane``) against
    ``winner_t_gid_plain``: t and gid equal on every lane, and equal to the
    nearest hit's."""
    n = 2048
    tables, t, _ = _bounce_args(scene_name, n, 4)
    gtab = tables[0]
    rays = Rays(t["origin"], t["direction"])
    want_t, want_gid = winner_t_gid_plain(rays, gtab)
    t_k, gid = torch.empty(n), torch.empty(n, dtype=torch.int32)
    host_lib.host_winner(gtab.data_ptr(), gtab.shape[0], n, t["origin"].data_ptr(),
                         t["direction"].data_ptr(), t_k.data_ptr(), gid.data_ptr())
    assert torch.equal(t_k, want_t) and torch.equal(gid, want_gid)
    hit = nearest_hit_plain(rays, gtab)
    assert torch.equal(want_t, hit.t) and torch.equal(want_gid, hit.geom_id)


@pytest.mark.parametrize("table", ["cornell", "cornell repeated rows", "one geom", "max geoms"])
def test_intersect_lanes_on_stress_lanes(host_lib, table):
    """Kernels 6, 7 and 8's lanes (``nearest_lane``, ``winner_lane``,
    ``occlusion_lane``) against ``nearest_hit_plain`` / ``winner_t_gid_plain``
    / ``occlusion_t_plain`` on
    ``tests/intersect_lanes.py``'s lanes: rays at the corners and edges
    where cubes meet, exact ties between repeated rows (the first in index
    order wins), direction components of 0 and around 1e-12, tables of 1
    and ``MAX_GEOMS`` rows.  gid and mid equal on every lane, kernel 7's t
    and gid equal to kernel 6's; t within 2e-6 on every lane and bit-equal
    on at least 99.5%: torch's CPU ``sqrt`` misses the correctly rounded
    ``sqrtf`` by an ulp on a few inputs (1 and 4 of these 2,048 lanes on
    Cornell and on the random table, in the parent's lanes too; on the card
    both round alike and ``test_torch_kernels_cuda.py`` holds t equal); the
    frame within 2e-6 as above; kernel 8's t held as kernel 6's is."""
    from tests.intersect_lanes import stress_rays, stress_table

    gtab = stress_table(table)
    n = 2048
    o, d = stress_rays(gtab, n, 29)
    want = nearest_hit_plain(Rays(o, d), gtab)
    want_t, want_gid = winner_t_gid_plain(Rays(o, d), gtab)
    t_k, gid, mid = torch.empty(n), torch.empty(n, dtype=torch.int32), torch.empty(
        n, dtype=torch.int32)
    p, p_obj, normal = (torch.empty((n, 3)) for _ in range(3))
    host_lib.host_nearest(gtab.data_ptr(), gtab.shape[0], n, o.data_ptr(), d.data_ptr(),
                          t_k.data_ptr(), gid.data_ptr(), mid.data_ptr(), p.data_ptr(),
                          p_obj.data_ptr(), normal.data_ptr())
    w_t, w_gid = torch.empty(n), torch.empty(n, dtype=torch.int32)
    host_lib.host_winner(gtab.data_ptr(), gtab.shape[0], n, o.data_ptr(), d.data_ptr(),
                         w_t.data_ptr(), w_gid.data_ptr())
    assert torch.equal(gid, want.geom_id) and torch.equal(mid, want.material_id)
    assert torch.equal(w_gid, want_gid)
    assert torch.equal(w_t, t_k) and torch.equal(w_gid, gid)
    torch.testing.assert_close(t_k, want.t, rtol=2e-6, atol=0.0)
    assert float((t_k == want.t).double().mean()) >= 0.995
    for got, ref in ((p, want.position), (p_obj, want.position_obj), (normal, want.normal)):
        torch.testing.assert_close(got, ref, rtol=2e-6, atol=2e-6)
    occ = _host_occlusion(host_lib, gtab, o, d)
    want_occ = occlusion_t_plain(Rays(o, d), gtab)
    torch.testing.assert_close(occ, want_occ, rtol=2e-6, atol=0.0)
    assert float((occ == want_occ).double().mean()) >= 0.995


def _host_occlusion(host_lib, gtab, o, d):
    """Kernel 8's host lanes."""
    n = o.shape[0]
    occ = torch.empty(n)
    host_lib.host_occlusion(gtab.data_ptr(), gtab.shape[0], n, o.data_ptr(), d.data_ptr(),
                            occ.data_ptr())
    return occ


@pytest.mark.parametrize("case", ["transforms", "transforms grazing", "cornell grazing",
                                  "cornell shadow rays"])
def test_occlusion_lanes_on_probe_lanes(host_lib, case):
    """Kernel 8's lanes (``intersect.cu:occlusion_lane``) against
    ``occlusion_t_plain`` on ``tests/intersect_lanes.py``'s probe lanes:
    random rotations and scales 0.01-10 with Cornell's walls and sheared
    rows, rays grazing the primitives and the padded boxes of
    ``tools/occlusion_cull.py``, shadow rays made as the split route makes
    them.  Equal on every lane of the shadow rays; on the others bit-equal
    on at least 99.5% and within 2e-6 (torch's CPU ``sqrt`` misses the
    correctly rounded ``sqrtf`` by an ulp on a few inputs, as on the stress
    lanes; the card holds every lane equal, ``test_torch_kernels_cuda.py``)."""
    from tests.intersect_lanes import probe_case

    gtab, o, d = probe_case(case, 4096)
    gtab = gtab.contiguous()
    occ = _host_occlusion(host_lib, gtab, o, d)
    want = occlusion_t_plain(Rays(o, d), gtab)
    if case == "cornell shadow rays":
        assert torch.equal(occ, want)
    torch.testing.assert_close(occ, want, rtol=2e-6, atol=0.0)
    assert float((occ == want).double().mean()) >= 0.995


# ---- triangle meshes: kernels 9 and 10, and the in-kernel sweep of 1 and 2


def object_rays(n: int, seed: int):
    """Numpy object-space rays aimed near a unit-scale mesh at the origin:
    origins 1.5 away, directions towards a point within about 0.4 of the
    centre, so both hits and misses."""
    rng = np.random.default_rng(seed)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    o = unit(rng.standard_normal((n, 3))) * 1.5
    d = unit(rng.standard_normal((n, 3)) * 0.4 - o)
    return o.astype(np.float32), d.astype(np.float32)


def _mesh_scene(res):
    desc = load_scene(os.path.join(HERE, "..", "scenes", "smooth_mesh.txt"))
    scene = dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cpu")
    return scene, [t.contiguous() for t in pack_tables(scene)]


def _mesh_args(km):
    return (km.tri.data_ptr(), km.aabb.data_ptr(), km.norm.data_ptr(), km.uv.data_ptr(),
            km.desc.data_ptr(), len(km.descs))


def adversarial_mesh_rays(m, seed: int = 4):
    """Numpy object-space rays that test chunk culling at its edges, for a
    mesh with an LBVH (its chunk boxes ``accel.lo`` / ``hi``): rays aimed at
    the vertices that lie on a chunk box's face and at the midpoints of
    their edges; axis-parallel rays (two zero direction components) through
    those vertices; rays from each box's centre (inside) and from the centre
    of each of its faces (on it); and rays grazing each face, in its plane
    from outside the box towards the face's centre."""
    rng = np.random.default_rng(seed)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    chunks = m.accel.chunks.numpy()
    lo, hi = m.accel.lo.numpy(), m.accel.hi.numpy()
    o, d = [], []
    for c in range(chunks.shape[0]):
        tri = chunks[c]
        on_face = (tri == lo[c]) | (tri == hi[c])  # [128, 3 corners, 3 axes]
        face_tris, face_corners = np.nonzero(on_face.any(-1))
        verts = tri[face_tris, face_corners]
        mids = 0.5 * (verts + tri[face_tris, (face_corners + 1) % 3])
        for targets in (verts, mids):
            origin = unit(rng.standard_normal((len(targets), 3))) * 1.5
            o.append(origin)
            d.append(unit(targets - origin))
        for ax in range(3):  # axis-parallel, both ways
            e = np.eye(3)[ax]
            o += [verts - 2.0 * e, verts + 2.0 * e]
            d += [np.tile(e, (len(verts), 1)), np.tile(-e, (len(verts), 1))]
        centre = 0.5 * (lo[c] + hi[c])
        for ax in range(3):
            for side in (lo[c], hi[c]):
                face = centre.copy()
                face[ax] = side[ax]
                o += [np.tile(centre, (16, 1)), np.tile(face, (16, 1))]
                d += [unit(rng.standard_normal((16, 3))), unit(rng.standard_normal((16, 3)))]
                # grazing: in the face's plane, from outside towards its centre
                start = face + unit(rng.standard_normal((16, 3)) * (1 - np.eye(3)[ax])) * 2.0
                start[:, ax] = side[ax]
                o.append(start)
                d.append(unit(face - start))
    return (np.concatenate(o).astype(np.float32), np.concatenate(d).astype(np.float32))


def mt_conditioning(table, o, d, idx):
    """Per lane, ``|a| / (|e1| |h|)`` of its triangle ``idx`` (Moeller-
    Trumbore's determinant over its scale, ``h = d x e2``): near 0 where
    the ray runs nearly parallel to the triangle's plane."""
    rows = table.view(-1, 9)[idx.long()]
    e1, e2 = rows[:, 3:6], rows[:, 6:9]
    h = torch.linalg.cross(d, e2, dim=-1)
    a = torch.sum(e1 * h, dim=-1)
    return a.abs() / (e1.norm(dim=-1) * h.norm(dim=-1)).clamp(min=1e-30)


@pytest.mark.parametrize("scene_name", ["smooth_mesh", "displace_demo", "adversarial"])
def test_mesh_kernel_lanes_match_plain(host_lib, scene_name):
    """Kernels 9 and 10's lanes (``mesh.cu``) against ``mesh_nearest_plain``
    / ``mesh_min_plain`` on the mesh's scan-order table (320 and 1,280
    triangles) with its padded chunk boxes, and without them (the dense
    sweep), on 2,048 object-space rays from around it, and on smooth_mesh's
    :func:`adversarial_mesh_rays`: t, winner index and miss pattern equal on
    every lane, culled and dense alike.  Culled equals dense on every lane,
    except on the adversarial rays where the dense winner's
    :func:`mt_conditioning` is below 1e-4 (a ray nearly in the triangle's
    plane, whose t no box margin bounds); those lanes are printed."""
    name = "smooth_mesh" if scene_name == "adversarial" else scene_name
    desc = load_scene(os.path.join(HERE, "..", "scenes", f"{name}.txt"))
    m = desc.scene_for_frame(0, device="cpu").meshes[0]
    table, boxes = m.scan_table, m.scan_boxes
    if scene_name == "adversarial":
        o, d = (torch.from_numpy(a) for a in adversarial_mesh_rays(m))
    else:
        o, d = (torch.from_numpy(a) for a in object_rays(2048, seed=9))
    n, n_tris = o.shape[0], table.shape[0] // 9
    got = {}
    for label, bx in (("culled", boxes), ("dense", None)):
        want_t, want_i = mesh.mesh_nearest_plain(table, bx, o, d)
        want_min = mesh.mesh_min_plain(table, bx, o, d)
        t_k, i_k, min_k = torch.empty(n), torch.empty(n, dtype=torch.int32), torch.empty(n)
        ptr = None if bx is None else bx.data_ptr()
        host_lib.host_mesh_nearest(table.data_ptr(), n_tris, ptr, n, o.data_ptr(), d.data_ptr(),
                                   t_k.data_ptr(), i_k.data_ptr())
        host_lib.host_mesh_min(table.data_ptr(), n_tris, ptr, n, o.data_ptr(), d.data_ptr(),
                               min_k.data_ptr())
        assert torch.equal(t_k, want_t) and torch.equal(i_k, want_i), label
        assert torch.equal(min_k, want_min) and torch.equal(want_min, want_t), label
        got[label] = (want_t, want_i)
    hit = got["dense"][0] < mesh.BIG
    assert 0.2 < float(hit.float().mean()) < 0.95
    differ = (got["culled"][0] != got["dense"][0]) | (got["culled"][1] != got["dense"][1])
    cond = mt_conditioning(table, o, d, got["dense"][1])
    print(f"{scene_name}: {n} rays, {int(hit.sum())} hits; culled differs from dense on "
          f"{int(differ.sum())} lanes: " + ", ".join(
              f"{j} (conditioning {float(cond[j]):.3g})" for j in differ.nonzero()[:, 0].tolist()))
    allowed = (cond < 1e-4) if scene_name == "adversarial" else torch.zeros_like(differ)
    assert not bool((differ & ~allowed).any())


@pytest.mark.parametrize("kw", [dict(max_depth=4, nee=True, rr=False, rr_start=3),
                                dict(max_depth=3, nee=False, rr=True, rr_start=1)])
def test_trace_mesh_lanes_match_plain(host_lib, kw):
    """Kernel 1's lanes with the in-kernel mesh tables (``pt::mesh_sweep`` /
    ``mesh_occ`` inside ``pt::bounce``) against ``trace_plain(mesh=...)`` on
    smooth_mesh at 40x40: equal ray counts, radiance within 2e-6 on at least
    99.5% of lanes (the analytic cases' bar: the host's libm rounds sin /
    cos / exp / log apart from torch's; measured every lane, printed under
    ``pytest -s``)."""
    scene, tables = _mesh_scene((40, 40))
    km = scene.mesh_tables
    n, seed = 1600, 31
    pixel = torch.arange(n)
    sample = 2 * n + pixel
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
    bits = sample.to(torch.int32)  # kept alive across the call
    rad_k, nr_k = torch.empty((n, 3)), ctypes.c_ulonglong()
    host_lib.host_trace(tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(),
                        tables[2].data_ptr(), tables[3].data_ptr(), seed,
                        rays.origin.data_ptr(), rays.direction.data_ptr(),
                        bits.data_ptr(), n, rad_k.data_ptr(),
                        ctypes.byref(nr_k), kw["max_depth"], int(kw["nee"]), int(kw["rr"]),
                        kw["rr_start"], *VACUUM, 0, *_mesh_args(km))
    rad_p, nr_p = trace.trace_plain(*tables, seed, rays.origin, rays.direction, sample,
                                    mesh=km, **kw)
    frac = float(torch.isclose(rad_k, rad_p, rtol=2e-6, atol=2e-6).all(-1).float().mean())
    print(f"smooth_mesh {kw}: trace lanes within 2e-6 of trace_plain: {frac:.5f}")
    assert nr_k.value == int(nr_p)
    assert frac >= 0.995 and float(rad_p.sum()) > 0


@pytest.mark.parametrize("nee", [True, False])
def test_bounce_mesh_lanes_match_plain(host_lib, nee):
    """Kernel 2's lanes with the in-kernel mesh tables against
    ``bounce_fused_plain(mesh=...)`` on 2,048 random lanes of smooth_mesh
    (rays from around the mesh, mixed depth and emit state): terminate,
    emit state and russian-roulette uniform equal on every lane, the float
    planes within 2e-6 on at least 99.5% of lanes (measured: every lane)."""
    n, seed = 2048, 77
    scene, tables = _mesh_scene((8, 8))
    km = scene.mesh_tables
    lanes = random_lanes(n, seed=12)
    lanes["origin"] = (lanes["origin"] * 0.7 + np.array([0.0, 1.8, 0.0])).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    medium = torch.zeros((n, 4))
    want = bounce_fused.bounce_fused_plain(
        tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(), t["depth"],
        t["prev"], medium, seed, nee=nee, mesh=km,
    )
    outs = [torch.empty((n, 3)) for _ in range(4)] + [
        torch.empty(n, dtype=torch.uint8), torch.empty(n), torch.empty(n), torch.empty((n, 4))]
    host_lib.host_bounce(
        tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(), tables[2].data_ptr(),
        tables[3].data_ptr(), seed, int(nee), n,
        *(t[k].data_ptr() for k in ("origin", "direction", "throughput", "sample", "depth",
                                    "prev")),
        medium.data_ptr(), *(o.data_ptr() for o in outs), None, None, *VACUUM, 4, *NO_SURF,
        *_mesh_args(km),
    )
    contrib, next_o, next_d, thr_mult, terminate, wspec, rru, _ = outs
    assert torch.equal(terminate.bool(), want.terminate)
    assert torch.equal(wspec, want.was_specular) and torch.equal(rru, want.rr_uniform)
    close = torch.ones(n, dtype=torch.bool)
    for got, ref in ((contrib, want.contrib), (next_o, want.next_origin),
                     (next_d, want.next_direction), (thr_mult, want.throughput_mult)):
        close &= torch.isclose(got, ref, rtol=2e-6, atol=2e-6).all(-1)
    frac = float(close.float().mean())
    # the mesh's material (glossy gold, 1) wins on some lanes
    on_mesh = bounce_fused.bounce_fused_plain(
        tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(), t["depth"],
        t["prev"], medium, seed, nee=nee,
    )
    moved = (on_mesh.next_direction != want.next_direction).any(-1)
    print(f"smooth_mesh nee={nee}: bounce lanes within 2e-6: {frac:.5f}; lanes the mesh "
          f"changed: {int(moved.sum())}")
    assert frac >= 0.995 and int(moved.sum()) > 100


# ---- the in-kernel sweep's winner and shadow ray (trace_common.cuh:
# mesh_sweep keeps only the winner in its loop and shades it after;
# mesh_occ stops at the first triangle nearer than its limit)

def _scene_with(tmp_path, extra: str, objs: dict, drop_mesh: bool = False):
    """smooth_mesh with ``extra`` appended (``objs``: OBJ files to write to
    ``tmp_path`` first, named in ``extra`` by ``{name}``); ``drop_mesh``
    leaves out its own icosphere."""
    with open(os.path.join(HERE, "..", "scenes", "smooth_mesh.txt")) as f:
        text = f.read()
    if drop_mesh:
        head, tail = text.split("OBJECT 1    // icosahedron mesh")
        text = head + "OBJECT 1\ncube\nmaterial 0\nframe 0\nTRANS 0 -40 0\nROTAT 0 0 0\n" \
            "SCALE 1 1 1\n" + tail[tail.index("\nOBJECT 2"):]
    paths = {}
    for name, body in objs.items():
        paths[name] = str(tmp_path / f"{name}.obj")
        with open(paths[name], "w") as f:
            f.write(body)
    text += extra.format(**paths)
    scene = parse_scene_text(text, scene_dir=os.path.join(HERE, "..", "scenes")).scene_for_frame(
        0, device="cpu")
    return scene, [t.contiguous() for t in pack_tables(scene)]


def _host_sweep(host_lib, tables, km, o, d, uv: bool):
    n = o.shape[0]
    t, p_obj, normal = torch.empty(n), torch.empty((n, 3)), torch.empty((n, 3))
    mid, uvs = torch.empty(n, dtype=torch.int32), torch.empty((n, 3))
    host_lib.host_mesh_sweep(tables[0].data_ptr(), *_mesh_args(km), int(uv), n, o.data_ptr(),
                             d.data_ptr(), t.data_ptr(), p_obj.data_ptr(), normal.data_ptr(),
                             mid.data_ptr(), uvs.data_ptr())
    return t, p_obj, normal, mid, uvs


def _assert_sweep_equal(host_lib, tables, km, o, d):
    """The host sweep bit-equal to ``mesh_sweep`` on every lane, with and
    without the UV blend; returns the plain version's outputs."""
    from pathtracer_tpu_torch.ops.mesh_tables import mesh_sweep

    want = mesh_sweep(km, tables[0], o.unbind(-1), d.unbind(-1), want_uv=True)
    for uv in (False, True):
        t, p_obj, normal, mid, uvs = _host_sweep(host_lib, tables, km, o, d, uv)
        assert torch.equal(t, want["et"])
        assert torch.equal(p_obj, torch.stack(want["epo"], -1))
        assert torch.equal(normal, torch.stack(want["en"], -1))
        assert torch.equal(mid.long(), want["emid"])
        if uv:
            assert torch.equal(uvs, torch.stack([want["muv_u"], want["muv_v"], want["muvv"]], -1))
    return want


def test_mesh_sweep_two_meshes_keeps_the_winners_geom(host_lib, tmp_path):
    """Three meshes under different transforms: smooth_mesh's icosphere
    (normals, material 1), a second copy of it turned and scaled unevenly
    (material 3), and a quad with authored UVs (material 0).  On 4,096 rays
    through them the sweep, which keeps only the winner in its loop and
    shades it after, equals ``mesh_sweep`` (which shades at every
    improvement) bit for bit on every lane; the rays include lanes where a
    later mesh beats an earlier one's hit and lanes where an earlier mesh
    keeps its hit against a later one, so the winner's own geom transform,
    normals and UVs are the ones used."""
    from pathtracer_tpu_torch.ops.mesh_tables import kernel_meshes, mesh_sweep
    from pathtracer_tpu_torch.scene.variants import quad_obj

    extra = ("\nOBJECT 4\nassets/ico_smooth.obj\nmaterial 3\nframe 0\nTRANS 0.9 2.3 1.1\n"
             "ROTAT 20 -35 10\nSCALE 2.5 1.5 3\n"
             "\nOBJECT 5\n{quad}\nmaterial 0\nframe 0\nTRANS -0.8 2.0 1.6\n"
             "ROTAT 10 30 0\nSCALE 3 3 3\n")
    scene, tables = _scene_with(tmp_path, extra, {"quad": quad_obj(True)})
    km = scene.mesh_tables
    assert len(km.descs) == 3 and [d[3:] for d in km.descs] == [(1, 0), (1, 0), (0, 1)]
    rng = np.random.default_rng(21)
    n, centre = 4096, np.array([0.0, 2.1, 0.9])
    o = rng.standard_normal((n, 3))
    o = centre + 6.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = centre + rng.standard_normal((n, 3)) * 0.9 - o
    o = torch.from_numpy(o.astype(np.float32))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    want = _assert_sweep_equal(host_lib, tables, km, o, d)
    # each mesh alone: which lanes it hits, and where
    alone = torch.stack([mesh_sweep(kernel_meshes([m]), tables[0], o.unbind(-1),
                                    d.unbind(-1))["et"] for m in scene.meshes], -1)
    hits = alone < mesh.BIG
    first = torch.argmax(hits.int(), dim=-1)  # the first mesh in sweep order the lane hits
    winner = torch.argmin(alone, dim=-1)
    multi = hits.sum(-1) >= 2
    later_wins = int((multi & (winner > first)).sum())
    earlier_keeps = int((multi & (winner == first)).sum())
    print(f"three meshes: {int(hits.any(-1).sum())} of {n} lanes hit, {int(multi.sum())} hit "
          f"two or more; a later mesh wins on {later_wins}, the first one hit keeps its hit on "
          f"{earlier_keeps}; UV lanes {int(want['muvv'].sum())}")
    assert later_wins >= 20 and earlier_keeps >= 20 and int(want["muvv"].sum()) >= 20


def _facet_grid_obj(cells: int) -> str:
    """A cells x cells grid of unit squares in the z = 0 plane, two
    triangles each, every triangle with its own tilted vertex normal, so
    that the normal a lane gets names the triangle that won."""
    lines = [f"v {i} {j} 0" for j in range(cells + 1) for i in range(cells + 1)]
    faces = []
    for j in range(cells):
        for i in range(cells):
            a = j * (cells + 1) + i + 1
            b, e, dd = a + 1, a + cells + 2, a + cells + 1
            for tri in ((a, b, e), (a, e, dd)):
                k = len(faces) + 1
                lines.append(f"vn {0.05 * (k % 7 - 3)} {0.05 * (k % 5 - 2)} 1")
                faces.append("f " + " ".join(f"{v}//{k}" for v in tri))
    return "\n".join(lines + faces) + "\n"


def test_mesh_sweep_tie_across_chunks_takes_the_lowest_row(host_lib, tmp_path):
    """Rays straight down onto a flat 6 x 6 grid (72 triangles, three chunks
    of 32 after the Morton sort) through every vertex and edge midpoint:
    Moeller-Trumbore's t is exact there (integer corners, dyadic origins),
    so triangles that share the edge or vertex tie, and on some lanes the
    tied rows lie in different chunks.  The sweep takes the lowest row, as
    ``mesh_sweep`` does, on every lane: its normal (each triangle's own)
    equals the plain version's."""
    from pathtracer_tpu_torch.ops.intersect import mt_planes

    cells = 6
    extra = ("\nOBJECT 4\n{grid}\nmaterial 1\nframe 0\nTRANS 0 0 0\nROTAT 0 0 0\n"
             "SCALE 1 1 1\n")
    scene, tables = _scene_with(tmp_path, extra, {"grid": _facet_grid_obj(cells)},
                                drop_mesh=True)
    km = scene.mesh_tables
    assert len(km.descs) == 1 and km.descs[0][1] == 3
    pts = [(x / 2, y / 2) for x in range(1, 2 * cells) for y in range(1, 2 * cells)]
    n = len(pts)
    o = torch.tensor([(x, y, 1.0) for x, y in pts], dtype=torch.float32)
    d = torch.tensor([(0.0, 0.0, -1.0)] * n, dtype=torch.float32)
    _assert_sweep_equal(host_lib, tables, km, o, d)
    tri = km.tri.view(-1, 12)
    t_all, _, _ = mt_planes(o.unbind(-1), d.unbind(-1), tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
    tied = t_all == t_all.min(-1, keepdim=True).values
    rows = torch.arange(tri.shape[0])
    chunk_of = rows // 32
    spans = torch.tensor([len(set(chunk_of[tied[j]].tolist())) for j in range(n)])
    distinct = torch.tensor([len({tuple(r) for r in km.norm.view(-1, 9)[tied[j], :3].tolist()})
                             for j in range(n)])
    across = int(((spans >= 2) & (distinct >= 2)).sum())
    print(f"facet grid: {n} rays, all at t = 1: {bool((t_all.min(-1).values == 1.0).all())}; "
          f"ties across chunks with different normals on {across} lanes")
    assert bool((t_all.min(-1).values == 1.0).all()) and across >= 5


def test_mesh_occ_stops_before_the_limit(host_lib, tmp_path):
    """The shadow ray's sweep against ``mesh_occ`` on smooth_mesh and the
    three-mesh scene: 4,096 rays from around the meshes towards a light
    point either before the meshes or past them (limit = distance - 8e-4,
    the bounce's bar).  On every lane the kernel's answer to t >= limit is
    the plain version's; where the nearest triangle lies beyond the light
    (or none is hit) its t is the plain nearest t, and where one lies
    before it, a t below the limit."""
    from pathtracer_tpu_torch.ops.mesh_tables import mesh_occ
    from pathtracer_tpu_torch.scene.variants import quad_obj

    extra = ("\nOBJECT 4\nassets/ico_smooth.obj\nmaterial 3\nframe 0\nTRANS 0.9 2.3 1.1\n"
             "ROTAT 20 -35 10\nSCALE 2.5 1.5 3\n"
             "\nOBJECT 5\n{quad}\nmaterial 0\nframe 0\nTRANS -0.8 2.0 1.6\n"
             "ROTAT 10 30 0\nSCALE 3 3 3\n")
    for label, (scene, tables) in (("smooth_mesh", _mesh_scene((8, 8))),
                                   ("three meshes", _scene_with(tmp_path, extra,
                                                                {"quad": quad_obj(True)}))):
        km = scene.mesh_tables
        rng = np.random.default_rng(33)
        n, centre = 4096, np.array([0.0, 2.0, 0.6])
        x = rng.standard_normal((n, 3))
        x = centre + 6.0 * x / np.linalg.norm(x, axis=-1, keepdims=True)
        aim = centre + rng.standard_normal((n, 3)) * 0.8
        light = x + (aim - x) * rng.uniform(0.3, 1.8, (n, 1))
        dist = np.linalg.norm(light - x, axis=-1)
        wi = torch.from_numpy(((light - x) / dist[:, None]).astype(np.float32))
        x = torch.from_numpy(x.astype(np.float32))
        limit = torch.from_numpy(dist.astype(np.float32)) - 4.0 * 2e-4
        want = mesh_occ(km, tables[0], x.unbind(-1), wi.unbind(-1))
        got = torch.empty(n)
        host_lib.host_mesh_occ(tables[0].data_ptr(), *_mesh_args(km), n, x.data_ptr(),
                               wi.data_ptr(), limit.data_ptr(), got.data_ptr())
        blocked = want < limit
        beyond = ~blocked & (want < mesh.BIG)
        print(f"{label}: {int(blocked.sum())} shadow rays blocked before the light, "
              f"{int(beyond.sum())} with their nearest triangle beyond it, "
              f"{int((want >= mesh.BIG).sum())} clear")
        assert torch.equal(got < limit, blocked)
        assert torch.equal(got[~blocked], want[~blocked])
        assert int(blocked.sum()) >= 100 and int(beyond.sum()) >= 100


# ---- participating media: the kVol / kHg instances of kernels 1 and 2,
# and kernel 1m's triangle split


def _media_scene(name, res):
    """A media scene at ``res``, its tables, its resolved features and the
    launchers' media flags (volumetric, hg)."""
    from pathtracer_tpu_torch.scene.variants import fog_mesh_scene
    from pathtracer_tpu_torch.render.features import features_for_materials

    if name.startswith("fog_mesh"):
        desc = parse_scene_text(fog_mesh_scene(name.endswith("glass")), name=name,
                                scene_dir=os.path.join(HERE, "..", "scenes"))
    else:
        desc = load_scene(os.path.join(HERE, "..", "scenes", f"{name}.txt"))
    scene = dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cpu")
    feats = frozenset(features_for_materials(scene.materials))
    flags = (int("volumetric" in feats), int("hg" in feats))
    return scene, [t.contiguous() for t in pack_tables(scene)], feats, flags


# scene, options, vol_nee, expected media flags
MEDIA_CASES = {
    "sss_hg": ("sss", dict(max_depth=8, nee=True, rr=False, rr_start=3), True, (1, 1)),
    "fog": ("fog", dict(max_depth=8, nee=True, rr=False, rr_start=3), True, (1, 0)),
    "glass_dof_rr": ("glass_dof", dict(max_depth=6, nee=True, rr=True, rr_start=2), True,
                     (1, 0)),
    "milky_no_vol_nee": ("milky", dict(max_depth=6, nee=True, rr=False, rr_start=3), False,
                         (1, 0)),
    "fog_mesh_glass": ("fog_mesh_glass", dict(max_depth=6, nee=True, rr=False, rr_start=3), True,
                       (1, 0)),
    "fog_mesh_opaque": ("fog_mesh_opaque", dict(max_depth=6, nee=True, rr=False, rr_start=3),
                        True, (1, 0)),
}


@pytest.mark.parametrize("case", sorted(MEDIA_CASES))
def test_trace_media_lanes_match_plain(host_lib, case):
    """Kernel 1's kVol / kHg lanes (and kernel 1m's, whose volumetric NEE
    splits the triangles by material through ``pt::mesh_occ_split``)
    against ``trace_plain(features=...)`` at 32x32: equal ray counts,
    radiance within 2e-6 on at least 99.5% of lanes (the analytic cases'
    bar: the host's libm rounds sin / cos / exp / log apart from torch's;
    measured every lane, printed under ``pytest -s``)."""
    name, kw, vol_nee, want_flags = MEDIA_CASES[case]
    scene, tables, feats, flags = _media_scene(name, (32, 32))
    assert flags == want_flags
    km = scene.mesh_tables
    n, seed = 32 * 32, 17
    pixel = torch.arange(n)
    sample = 4 * n + pixel
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
    bits = sample.to(torch.int32)  # kept alive across the call
    rad_k, nr_k = torch.empty((n, 3)), ctypes.c_ulonglong()
    host_lib.host_trace(tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(),
                        tables[2].data_ptr(), tables[3].data_ptr(), seed,
                        rays.origin.data_ptr(), rays.direction.data_ptr(),
                        bits.data_ptr(), n, rad_k.data_ptr(),
                        ctypes.byref(nr_k), kw["max_depth"], int(kw["nee"]), int(kw["rr"]),
                        kw["rr_start"], *flags, int(vol_nee),
                        0, *(_mesh_args(km) if km is not None else NO_MESH))
    rad_p, nr_p = trace.trace_plain(*tables, seed, rays.origin, rays.direction, sample,
                                    mesh=km, features=feats, vol_nee=vol_nee, **kw)
    vac_p, _ = trace.trace_plain(*tables, seed, rays.origin, rays.direction, sample,
                                 mesh=km, **kw)
    frac = float(torch.isclose(rad_k, rad_p, rtol=2e-6, atol=2e-6).all(-1).float().mean())
    moved = int((rad_p != vac_p).any(-1).sum())
    print(f"{case}: trace lanes within 2e-6 of trace_plain: {frac:.5f}; lanes the media "
          f"changed: {moved}; rays kernel {nr_k.value}, plain {int(nr_p)}")
    assert nr_k.value == int(nr_p)
    assert frac >= 0.995 and float(rad_p.sum()) > 0 and moved > 10


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("hg", [True, False])
def test_bounce_media_lanes_match_plain(host_lib, hg, nee):
    """Kernel 2's kVol / kHg lanes against ``bounce_fused_plain`` on 2,048
    random lanes of sss with seeded medium carries (sigma_a, sigma_s and g
    nonzero on 60% of lanes; the medium [N, 5] with hg, [N, 4] without):
    terminate, emit state, the russian-roulette uniform and the medium
    equal on every lane, the float planes within 2e-6 on at least 99.5% of
    lanes (measured: every lane)."""
    from tests.test_torch_volume import medium_carries

    n, seed = 2048, 77
    _, tables, _, _ = _media_scene("sss", (8, 8))
    lanes = random_lanes(n, seed=14)
    lanes["origin"] = (lanes["origin"] * 0.5 + np.array([0.0, 1.2, 0.0])).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    sa, ss, g = medium_carries(n, seed=6)
    width = 5 if hg else 4
    medium = torch.from_numpy(
        np.ascontiguousarray(np.concatenate([sa, ss[:, None], g[:, None]], -1)[:, :width]))
    feats = frozenset({"volumetric", "hg"} if hg else {"volumetric"})
    want = bounce_fused.bounce_fused_plain(
        tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(), t["depth"],
        t["prev"], medium, seed, nee=nee, features=feats,
    )
    outs = [torch.empty((n, 3)) for _ in range(4)] + [
        torch.empty(n, dtype=torch.uint8), torch.empty(n), torch.empty(n), torch.empty((n, width))]
    host_lib.host_bounce(
        tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(), tables[2].data_ptr(),
        tables[3].data_ptr(), seed, int(nee), n,
        *(t[k].data_ptr() for k in ("origin", "direction", "throughput", "sample", "depth",
                                    "prev")),
        medium.data_ptr(), *(o.data_ptr() for o in outs), None, None, 1, int(hg), 1, width,
        *NO_SURF, *NO_MESH,
    )
    contrib, next_o, next_d, thr_mult, terminate, wspec, rru, out_medium = outs
    assert torch.equal(terminate.bool(), want.terminate)
    assert torch.equal(wspec, want.was_specular) and torch.equal(rru, want.rr_uniform)
    assert torch.equal(out_medium, want.next_medium)
    close = torch.ones(n, dtype=torch.bool)
    for got, ref in ((contrib, want.contrib), (next_o, want.next_origin),
                     (next_d, want.next_direction), (thr_mult, want.throughput_mult)):
        close &= torch.isclose(got, ref, rtol=2e-6, atol=2e-6).all(-1)
    frac = float(close.float().mean())
    states = [int((wspec == v).sum()) for v in (0.0, 1.0, 2.0)]
    changed = int((out_medium != medium).any(-1).sum())
    print(f"hg={hg} nee={nee}: bounce lanes within 2e-6: {frac:.5f}; emit states {states}; "
          f"media changed {changed}")
    assert frac >= 0.995 and changed > 50
    if nee:
        assert states[2] > 10


# ---- differentiable participating media: kernels 4v and 5v, 2r-v and 3v


def _vol_grad_scene(name, res):
    """A media scene of the gradient kernels (volumetric, no hg) at ``res``
    and its tables: ``tests/test_torch_volume_diff.VOL_MINI`` or a file of
    ``scenes/``."""
    from tests.test_torch_volume_diff import VOL_MINI

    if name == "vol_mini":
        desc = parse_scene_text(VOL_MINI, name=name)
    else:
        desc = load_scene(os.path.join(HERE, "..", "scenes", f"{name}.txt"))
    scene = dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cpu")
    return scene, [t.contiguous() for t in pack_tables(scene)]


def _lane_share(got, want):
    """Share of lanes whose every component is within rtol = atol = 1e-5 of
    the float64 reference's."""
    return float(torch.isclose(got.double(), want, rtol=1e-5, atol=1e-5).all(-1).double().mean())


def _check_table_cotangents(got, want):
    for w, k in zip(want, got):
        # every entry, small ones too
        assert bool(((k.double() - w).abs() <= 1e-4 * w.abs() + 1e-6 * float(w.abs().max())).all())


# scene, resolution, options, vol_nee, least share of lanes whose residuals
# are within 2e-6
VOL_GRAD_CASES = {
    "vol_mini_rr": ("vol_mini", (37, 23), dict(max_depth=3, nee=True, rr=True, rr_start=1), True,
                    0.995),
    "vol_mini_no_vol_nee": ("vol_mini", (37, 23), dict(max_depth=4, nee=True, rr=False,
                                                       rr_start=3), False, 0.995),
    "milky": ("milky", (24, 24), dict(max_depth=6, nee=True, rr=False, rr_start=3), True, 0.98),
    "fog": ("fog", (24, 24), dict(max_depth=4, nee=True, rr=False, rr_start=3), True, 0.995),
}


@pytest.mark.parametrize("case", sorted(VOL_GRAD_CASES))
def test_trace_grad_vol_lanes_match_plain(host_lib, case):
    """Kernels 4v and 5v (``trace_grad.cu``'s kVol instances): the forward
    lanes against ``tfwd_plain(features={"volumetric"})`` (equal ray counts;
    radiance and all 17 residual planes within 2e-6 on at least 99.5% of
    lanes, room for the host's libm exp / log, as the media forward cases
    above, and the residuals on 98% of milky's at depth 6, as Cornell's at
    depth 8; measured: every lane, 98.96% on milky), and the reverse lanes
    on the plain
    version's residuals against ``tbwd_plain``'s float64 reference at the
    bars of ``chip_smoke.py``'s ``[grad:vol]``: every table cotangent within
    1e-4 of itself plus 1e-6 of its table's largest, every component of
    d_origin / d_direction within rtol = atol = 1e-5 on at least 99.99% of
    lanes (measured: every lane).  The medium's material columns get
    gradients."""
    name, res, kw, vol_nee, min_res = VOL_GRAD_CASES[case]
    scene, tables = _vol_grad_scene(name, res)
    n, seed = res[0] * res[1], 4321
    pixel = torch.arange(n)
    sample = 2 * n + pixel
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
    g, m = tables[0].shape[0], tables[1].shape[0]
    bits = sample.to(torch.int32)
    flags = (kw["max_depth"], int(kw["nee"]), int(kw["rr"]), kw["rr_start"])
    feats = frozenset({"volumetric"})
    vkw = dict(kw, features=feats, vol_nee=vol_nee)

    rad_p, nr_p, res_p = trace_grad.tfwd_plain(*tables, seed, rays.origin, rays.direction,
                                               sample, **vkw)
    assert res_p.shape == (kw["max_depth"], trace_grad.N_RESID_VOL, n)
    rad_k, res_k, nr_k = torch.empty((n, 3)), torch.empty_like(res_p), ctypes.c_ulonglong()
    host_lib.host_fwd(tables[0].data_ptr(), g, tables[1].data_ptr(), tables[2].data_ptr(),
                      tables[3].data_ptr(), seed, rays.origin.data_ptr(),
                      rays.direction.data_ptr(), bits.data_ptr(), n, rad_k.data_ptr(),
                      ctypes.byref(nr_k), res_k.data_ptr(), *flags, 1, int(vol_nee), 0)
    assert nr_k.value == int(nr_p)
    rad_frac = float(torch.isclose(rad_k, rad_p, rtol=2e-6, atol=2e-6).all(-1).float().mean())
    res_frac = float(
        torch.isclose(res_k, res_p, rtol=2e-6, atol=2e-6).all(0).all(0).float().mean())
    in_medium = int((res_p[:, trace_grad.R_SS] > 0).sum())

    g_rad = torch.from_numpy(np.random.default_rng(8).standard_normal((n, 3)).astype(np.float32))
    want = trace_grad.tbwd_plain(*tables, seed, sample, res_p, g_rad, dtype=torch.float64, **vkw)
    d_o, d_d = torch.empty((n, 3)), torch.empty((n, 3))
    row = torch.empty(trace_grad.grad_row_len(g, m))
    host_lib.host_bwd(tables[0].data_ptr(), g, tables[1].data_ptr(), m, tables[2].data_ptr(),
                      tables[3].data_ptr(), seed, bits.data_ptr(), n, res_p.data_ptr(),
                      g_rad.data_ptr(), d_o.data_ptr(), d_d.data_ptr(), row.data_ptr(), *flags, 1,
                      int(vol_nee), 0)
    got = (*trace_grad.split_grad_row(row, g, m), d_o, d_d)
    shares = [_lane_share(k, w) for k, w in zip(got[4:], want[4:])]
    media = [k for k in range(m) if float(tables[1][k, 14] * tables[1][k, 15]) > 0
             or float(tables[1][k, 11:14].abs().sum()) > 0]
    d_media = float(want[1][media][:, 11:16].abs().max())
    print(f"{case}: lane-bounces in a medium {in_medium}; forward lanes within 2e-6: radiance "
          f"{rad_frac:.5f}, residuals {res_frac:.5f}; reverse lanes within 1e-5 of the float64 "
          f"reference {shares}; largest medium-column cotangent {d_media:.4g}")
    assert rad_frac >= 0.995 and res_frac >= min_res and in_medium > 20
    _check_table_cotangents(got[:4], want[:4])
    assert min(shares) >= 0.9999
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert d_media > 0


def _vol_lanes(name, n, seed):
    """Random lanes about a media scene with seeded medium carries [N, 4]
    (sigma_a, sigma_s nonzero on about 60% of lanes)."""
    from tests.test_torch_volume import medium_carries

    _, tables = _vol_grad_scene(name, (8, 8))
    lanes = random_lanes(n, seed=seed)
    centre = np.array([0.0, 6.5, 2.0] if name == "vol_mini" else [0.0, 0.0, 0.0])
    lanes["origin"] = (lanes["origin"] + centre).astype(np.float32)
    sa, ss, _ = medium_carries(n, seed=seed + 1)
    medium = torch.from_numpy(np.ascontiguousarray(np.concatenate([sa, ss[:, None]], -1)))
    return tables, {k: torch.from_numpy(v) for k, v in lanes.items()}, medium


@pytest.mark.parametrize("vol_nee", [True, False])
@pytest.mark.parametrize("scene_name", ["vol_mini", "fog"])
def test_bounce_vol_replay_and_backward_lanes_match_plain(host_lib, scene_name, vol_nee):
    """Kernel 2r-v (``bounce.cu``'s kVol instance with the replay planes)
    against ``bounce_fused_plain(features={"volumetric"}, emit_replay=True)``
    on 2,048 random lanes with seeded media: replay planes, terminate, emit
    state and the medium equal on every lane, the float planes within 2e-6
    on at least 99.5% of lanes; and kernel 3v (``bounce_grad.cu``'s kVol
    instance) on those planes with seeded cotangents on every lane (the
    medium's too) against ``bounce_bwd_plain``'s float64 reference: every
    table cotangent within 1e-4 of itself plus 1e-6 of its table's largest,
    every component of d_origin / d_direction / d_throughput / d_medium
    within rtol = atol = 1e-5 on at least 99.99% of lanes (measured: every
    lane), misses, light hits and in-medium scatters included."""
    n, seed = 2048, 55
    tables, t, medium = _vol_lanes(scene_name, n, 40)
    feats = frozenset({"volumetric"})
    keys = ("origin", "direction", "throughput", "sample", "depth", "prev")
    args = (tables, *(t[k].long() if k == "sample" else t[k] for k in keys))
    want, want_gid, want_nee = bounce_fused.bounce_fused_plain(
        *args, medium, seed, nee=True, features=feats, vol_nee=vol_nee, emit_replay=True)
    outs = [torch.empty((n, 3)) for _ in range(4)] + [
        torch.empty(n, dtype=torch.uint8), torch.empty(n), torch.empty(n), torch.empty((n, 4))]
    rgid, rnee = torch.empty(n), torch.empty(n)
    host_lib.host_bounce(
        tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(), tables[2].data_ptr(),
        tables[3].data_ptr(), seed, 1, n, *(t[k].data_ptr() for k in keys), medium.data_ptr(),
        *(o.data_ptr() for o in outs), rgid.data_ptr(), rnee.data_ptr(), 1, 0, int(vol_nee), 4,
        *NO_SURF, *NO_MESH,
    )
    contrib, next_o, next_d, thr_mult, terminate, wspec, _, out_medium = outs
    assert torch.equal(rgid, want_gid) and torch.equal(rnee, want_nee)
    assert torch.equal(terminate.bool(), want.terminate)
    assert torch.equal(wspec, want.was_specular) and torch.equal(out_medium, want.next_medium)
    close = torch.ones(n, dtype=torch.bool)
    for got, ref in ((contrib, want.contrib), (next_o, want.next_origin),
                     (next_d, want.next_direction), (thr_mult, want.throughput_mult)):
        close &= torch.isclose(got, ref, rtol=2e-6, atol=2e-6).all(-1)
    frac = float(close.float().mean())
    miss, light = rgid < 0, (rgid >= 0) & want.terminate
    # the lanes whose free path ends before their surface
    u8 = hash_uniforms_planes(seed, t["sample"].long(), t["depth"], 11)[8]
    free_path = torch.where(medium[:, 3] > 0, -torch.log(torch.clamp(1.0 - u8, 1e-7, 1.0))
                            / torch.clamp(medium[:, 3], min=1e-12), 1e30)
    scatter = (rgid >= 0) & (free_path < nearest_hit_plain(Rays(t["origin"], t["direction"]),
                                                           tables[0]).t)
    assert frac >= 0.995 and int(miss.sum()) > 0 and int(light.sum()) > 0

    r = np.random.default_rng(9)
    cots = [torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32)) for _ in range(4)]
    g_med = torch.from_numpy(r.standard_normal((n, 4)).astype(np.float32))
    bargs = (*args, rgid, rnee, *cots, seed)
    bkw = dict(nee=True, features=feats, medium=medium, g_medium=g_med, vol_nee=vol_nee)
    ref = bounce_grad.bounce_bwd_plain(*bargs, dtype=torch.float64, **bkw)
    g, m = tables[0].shape[0], tables[1].shape[0]
    d_o, d_d, d_t, d_m = torch.empty((n, 3)), torch.empty((n, 3)), torch.empty((n, 3)), torch.empty(
        (n, 4))
    row = torch.empty(trace_grad.grad_row_len(g, m))
    host_lib.host_bounce_bwd(
        tables[0].data_ptr(), g, tables[1].data_ptr(), m, tables[2].data_ptr(),
        tables[3].data_ptr(), seed, 1, n, *(t[k].data_ptr() for k in keys), rgid.data_ptr(),
        rnee.data_ptr(), *(c.data_ptr() for c in cots), d_o.data_ptr(), d_d.data_ptr(),
        d_t.data_ptr(), row.data_ptr(), 1, int(vol_nee), 0, medium.data_ptr(), g_med.data_ptr(),
        d_m.data_ptr(), None,
    )
    got = (*trace_grad.split_grad_row(row, g, m), d_o, d_d, d_t, d_m)
    shares = [_lane_share(k, w) for k, w in zip(got[4:], ref[4:])]
    print(f"{scene_name} vol_nee={vol_nee}: {int(miss.sum())} misses, {int(light.sum())} light "
          f"hits, {int(scatter.sum())} in-medium scatters; 2r-v lanes within 2e-6: {frac:.5f}; "
          f"3v lanes within 1e-5 of the float64 reference (d_o, d_d, d_thr, d_medium): {shares}")
    assert int(scatter.sum()) > 50
    _check_table_cotangents(got[:4], ref[:4])
    assert min(shares) >= 0.9999
    assert all(bool(torch.isfinite(x).all()) for x in got)
    assert float(d_m.abs().max()) > 0


# ---- the optional surface physics: the kSurf instances of kernels 1 and 2
# and kernel 2's deferred-texel variant (kTex)


def _surface_scene(name, res):
    """A surface scene at ``res``: ward, its GGX copy, textured with stripes
    or textured_image; its tables, resolved features and surface bits."""
    from pathtracer_tpu_torch.scene.variants import ggx_ward_scene, striped_scene
    from pathtracer_tpu_torch.render.features import features_for_materials

    scenes = os.path.join(HERE, "..", "scenes")
    if name == "ggx_ward":
        desc = parse_scene_text(ggx_ward_scene(), name=name)
    elif name == "striped":
        desc = parse_scene_text(striped_scene(), name=name, scene_dir=scenes)
    else:
        desc = load_scene(os.path.join(scenes, f"{name}.txt"))
    scene = dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cpu")
    feats = frozenset(features_for_materials(scene.materials))
    return scene, [t.contiguous() for t in pack_tables(scene)], feats, trace.surface_bits(feats)


# scene, options, expected surface bits, least share of lanes within 2e-6
# and largest relative difference of the ray counts
SURF_CASES = {
    "ward": ("ward", dict(max_depth=8, nee=True, rr=False, rr_start=3), 12, (0.995, 0.0)),
    "ggx_ward_rr": ("ggx_ward", dict(max_depth=6, nee=True, rr=True, rr_start=2), 12,
                    (0.995, 0.0)),
    "striped": ("striped", dict(max_depth=8, nee=True, rr=False, rr_start=3), 3, (0.99, 1e-3)),
    "striped_no_nee": ("striped", dict(max_depth=6, nee=False, rr=False, rr_start=3), 3,
                       (0.99, 1e-3)),
}


@pytest.mark.parametrize("case", sorted(SURF_CASES))
def test_trace_surface_lanes_match_plain(host_lib, case):
    """Kernel 1's kSurf lanes against ``trace_plain(features=...)`` at
    32x32: equal ray counts and radiance within 2e-6 on at least 99.5% of
    lanes (the analytic cases' bar: the host's libm rounds sin / cos / exp /
    log apart from torch's).  With the bump, the host's ``sinf`` and torch's
    vectorized ``sin`` of phases near 10^3 rad differ in the last ulp, which
    moves the bumped normal by about 1e-4 and sends a few paths elsewhere:
    99% of lanes and the ray counts within 0.1% (measured 99.41% and 4 of
    10,894 rays).  On the card the kernel and the plain version call the
    same ``sinf`` and agree bit for bit (``chip_smoke.py`` ``[surf]``)."""
    name, kw, want_bits, (least, rays_tol) = SURF_CASES[case]
    scene, tables, feats, bits_s = _surface_scene(name, (32, 32))
    assert bits_s == want_bits
    n, seed = 32 * 32, 23
    pixel = torch.arange(n)
    sample = 2 * n + pixel
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
    bits = sample.to(torch.int32)  # kept alive across the call
    rad_k, nr_k = torch.empty((n, 3)), ctypes.c_ulonglong()
    host_lib.host_trace(tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(),
                        tables[2].data_ptr(), tables[3].data_ptr(), seed,
                        rays.origin.data_ptr(), rays.direction.data_ptr(), bits.data_ptr(), n,
                        rad_k.data_ptr(), ctypes.byref(nr_k), kw["max_depth"], int(kw["nee"]),
                        int(kw["rr"]), kw["rr_start"], *VACUUM, bits_s, *NO_MESH)
    rad_p, nr_p = trace.trace_plain(*tables, seed, rays.origin, rays.direction, sample,
                                    features=feats, **kw)
    base_p, _ = trace.trace_plain(*tables, seed, rays.origin, rays.direction, sample, **kw)
    frac = float(torch.isclose(rad_k, rad_p, rtol=2e-6, atol=2e-6).all(-1).float().mean())
    moved = int((rad_p != base_p).any(-1).sum())
    print(f"{case}: trace lanes within 2e-6 of trace_plain: {frac:.5f}; lanes the surface "
          f"features changed: {moved}; rays kernel {nr_k.value}, plain {int(nr_p)}")
    assert abs(nr_k.value - int(nr_p)) <= rays_tol * int(nr_p)
    assert frac >= least and float(rad_p.sum()) > 0 and moved > 40


CENTRES = {"ward": (0.0, 2.0, 0.0), "ggx_ward": (0.0, 2.0, 0.0), "striped": (0.0, 4.0, -1.0),
           "textured_image": (0.0, 2.0, 0.0)}


@pytest.mark.parametrize("name", ["milky", "fog", "ward", "ggx_ward", "textured"])
def test_lane_keys_match_plain(host_lib, name):
    """The keys by which the reverse kernel's media and surface instances
    order their lanes (``trace_grad.cu:lane_key``) equal
    ``trace_grad.lane_keys_plain``'s on every lane of the forward's
    residuals at depth 8: one bit per bounce the lane lives in a scattering
    medium (milky, fog) or on a Cook-Torrance or Ward material (ward,
    ggx_ward; textured has neither: every key 0)."""
    if name in ("milky", "fog"):
        scene, tables = _vol_grad_scene(name, (24, 24))
        feats = frozenset({"volumetric"})
    else:
        scene, tables, feats = _surf_grad_scene(name, (24, 24))
    n, seed, depth = 24 * 24, 77, 8
    pixel = torch.arange(n)
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
    _, _, resid = trace_grad.tfwd_plain(*tables, seed, rays.origin, rays.direction, pixel,
                                        max_depth=depth, nee=True, rr=False, rr_start=3,
                                        features=feats)
    want = trace_grad.lane_keys_plain(tables[0], tables[1], resid, feats, depth)
    got = torch.empty(n, dtype=torch.int32)
    host_lib.host_lane_keys(tables[0].data_ptr(), tables[1].data_ptr(), resid.data_ptr(), n,
                            depth, int("volumetric" in feats), got.data_ptr())
    print(f"{name}: {int((want > 0).sum())} of {n} lanes with a costly bounce, "
          f"{len(torch.unique(want))} keys")
    assert torch.equal(got, want)
    assert (name == "textured") == (int(want.max()) == 0)


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("name", ["ggx_ward", "striped", "textured_image"])
def test_bounce_surface_lanes_match_plain(host_lib, name, nee):
    """Kernel 2's kSurf lanes (and on textured_image its kTex lanes, with
    the deferred texel's planes) against ``bounce_fused_plain`` on 2,048
    random lanes: terminate, emit state, the russian-roulette uniform, the
    medium and the atlas slot equal on every lane, the float planes and the
    UV within 2e-6 on at least 99.5% of lanes (measured: 99.9% to every
    lane)."""
    n, seed = 2048, 31
    scene, tables, feats, bits_s = _surface_scene(name, (8, 8))
    tex = scene.textures is not None
    lanes = random_lanes(n, seed=19)
    lanes["origin"] = (lanes["origin"] * 0.8 + np.asarray(CENTRES[name])).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    medium = torch.zeros((n, 4))
    want = bounce_fused.bounce_fused_plain(
        tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(), t["depth"],
        t["prev"], medium, seed, nee=nee, features=feats, tex_defer=tex,
    )
    want, want_tex = (want[0], want[1:]) if tex else (want, ())
    outs = [torch.empty((n, 3)) for _ in range(4)] + [
        torch.empty(n, dtype=torch.uint8), torch.empty(n), torch.empty(n), torch.empty((n, 4))]
    tex_out = [torch.empty(n) for _ in range(3)] if tex else []
    host_lib.host_bounce(
        tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(), tables[2].data_ptr(),
        tables[3].data_ptr(), seed, int(nee), n,
        *(t[k].data_ptr() for k in ("origin", "direction", "throughput", "sample", "depth",
                                    "prev")),
        medium.data_ptr(), *(o.data_ptr() for o in outs), None, None, *VACUUM, 4, bits_s,
        *((o.data_ptr() for o in tex_out) if tex else (None, None, None)), *NO_MESH,
    )
    contrib, next_o, next_d, thr_mult, terminate, wspec, rru, out_medium = outs
    assert torch.equal(terminate.bool(), want.terminate)
    assert torch.equal(wspec, want.was_specular) and torch.equal(rru, want.rr_uniform)
    assert torch.equal(out_medium, want.next_medium)
    close = torch.ones(n, dtype=torch.bool)
    for got, ref in ((contrib, want.contrib), (next_o, want.next_origin),
                     (next_d, want.next_direction), (thr_mult, want.throughput_mult)):
        close &= torch.isclose(got, ref, rtol=2e-6, atol=2e-6).all(-1)
    if tex:
        assert torch.equal(tex_out[2], want_tex[2])
        for got, ref in zip(tex_out[:2], want_tex[:2]):
            close &= torch.isclose(got, ref, rtol=2e-6, atol=2e-6)
        assert int((want_tex[2] >= 0).sum()) > 100
    frac = float(close.float().mean())
    print(f"{name} nee={nee}: bounce lanes within 2e-6: {frac:.5f}")
    assert frac >= 0.995


# ---- meshes above the in-kernel cap and image textures on meshes: kernel
# 2's mesh-merge variant (2mm, bounce_merge.cu) and kernel 2m's UV sweep
# (2mt)


def _bigmesh_scene(name, tmp_path):
    """The 5,120-triangle scene, or textured_mesh_scene with a vt grid of
    65 cells (8,450 triangles, the merge variant) or 24 (in-kernel)."""
    from pathtracer_tpu_torch.scene.variants import bigmesh_scene, grid_obj, textured_mesh_scene
    from pathtracer_tpu_torch.render.features import features_for_materials

    scenes = os.path.join(HERE, "..", "scenes")
    if name == "big":
        text = bigmesh_scene(4)
    else:
        obj = tmp_path / f"{name}.obj"
        obj.write_text(grid_obj(65 if name == "grid65" else 24))
        text = textured_mesh_scene(str(obj))
    scene = parse_scene_text(text, name=name, scene_dir=scenes).scene_for_frame(0, device="cpu")
    feats = frozenset(features_for_materials(scene.materials)) | {"glossy"}
    return scene, [t.contiguous() for t in pack_tables(scene)], feats


def _aimed(centre, n, seed):
    lanes = random_lanes(n, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    o = np.asarray(centre) + lanes["direction"] * rng.uniform(2.0, 4.0, (n, 1))
    d = np.asarray(centre) + rng.standard_normal((n, 3)) * 0.6 - o
    lanes["origin"] = o.astype(np.float32)
    lanes["direction"] = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in lanes.items()}


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("name", ["big", "grid65"])
def test_bounce_merge_lanes_match_plain(host_lib, tmp_path, name, nee):
    """Kernel 2mm's lanes (the merge of the outside mesh winner, the
    deferred shadow ray; on the vt grid the deferred texel with the
    authored UV of mesh_uv) against ``bounce_fused_plain(mesh_in=...)`` on
    2,048 lanes aimed at the mesh: terminate, emit state, russian-roulette
    uniform, atlas slot and the deferred candidate bit equal on every lane;
    the float planes (the 11 deferred ones too) within 2e-6 on at least
    99.5% of lanes (the host's libm; measured printed)."""
    n, seed = 2048, 41
    scene, tables, feats = _bigmesh_scene(name, tmp_path)
    tex = scene.textures is not None
    # the copper mesh is glossy: aim the big scene's lanes at the floor's
    # diffuse lanes too, below and in front of it
    t = _aimed((0.0, 0.4, 1.5) if name == "big" else (0.3, 2.4, 2.5), n, seed=17)
    mesh_in, mesh_uv = bounce_fused.merge_planes(scene, t["origin"], t["direction"], tables[0],
                                                 with_uv=tex)
    medium = torch.zeros((n, 4))
    want = bounce_fused.bounce_fused_plain(
        tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(), t["depth"],
        t["prev"], medium, seed, nee=nee, features=feats, tex_defer=tex, mesh_in=mesh_in,
        mesh_uv=mesh_uv)
    want, *extra = want if isinstance(want, tuple) else (want,)
    outs = [torch.empty((n, 3)) for _ in range(4)] + [
        torch.empty(n, dtype=torch.uint8), torch.empty(n), torch.empty(n), torch.empty((n, 4))]
    tex_out = [torch.empty(n) for _ in range(3)] if tex else [None] * 3
    deferred = torch.empty((11, n)) if nee else None
    host_lib.host_bounce_merge(
        tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(), tables[2].data_ptr(),
        tables[3].data_ptr(), seed, int(nee), n,
        *(t[k].data_ptr() for k in ("origin", "direction", "throughput", "sample", "depth",
                                    "prev")),
        medium.data_ptr(), *(o.data_ptr() for o in outs), *VACUUM, 4, trace.surface_bits(feats),
        *(None if o is None else o.data_ptr() for o in tex_out), mesh_in.data_ptr(),
        None if mesh_uv is None else mesh_uv.data_ptr(),
        None if deferred is None else deferred.data_ptr(),
    )
    contrib, next_o, next_d, thr_mult, terminate, wspec, rru, out_medium = outs
    assert torch.equal(terminate.bool(), want.terminate)
    assert torch.equal(wspec, want.was_specular) and torch.equal(rru, want.rr_uniform)
    close = torch.ones(n, dtype=torch.bool)
    for got, ref in ((contrib, want.contrib), (next_o, want.next_origin),
                     (next_d, want.next_direction), (thr_mult, want.throughput_mult)):
        close &= torch.isclose(got, ref, rtol=2e-6, atol=2e-6).all(-1)
    if tex:
        assert torch.equal(tex_out[2], extra[2]) and int((extra[2] >= 0).sum()) > 100
        for got, ref in zip(tex_out[:2], extra[:2]):
            close &= torch.isclose(got, ref, rtol=2e-6, atol=2e-6)
    if nee:
        ref = extra[-1]
        assert torch.equal(deferred[10], ref[10]) and int(ref[10].sum()) > 50
        close &= torch.isclose(deferred[:10], ref[:10], rtol=2e-6, atol=2e-6).all(0)
    on_mesh = int((mesh_in[0] < 1e29).sum())
    frac = float(close.float().mean())
    print(f"{name} nee={nee}: {on_mesh} lanes on the mesh; merge lanes within 2e-6: {frac:.5f}")
    assert frac >= 0.995 and on_mesh > 200


@pytest.mark.parametrize("nee", [True, False])
def test_bounce_mesh_tex_lanes_match_plain(host_lib, tmp_path, nee):
    """Kernel 2mt's lanes (the deferred texel with in-kernel meshes: kernel
    2m's UV sweep and the box map of a mesh lane) against
    ``bounce_fused_plain(mesh=..., tex_defer=True)`` on 2,048 lanes aimed at
    a 1,152-triangle vt grid: terminate, emit state, russian-roulette
    uniform and atlas slot equal on every lane, the float planes and the UV
    within 2e-6 on at least 99.5% of lanes."""
    n, seed = 2048, 43
    scene, tables, feats = _bigmesh_scene("grid24", tmp_path)
    km = scene.mesh_tables
    assert km is not None and km.has_uv
    t = _aimed((0.3, 2.4, 2.5), n, seed=23)
    medium = torch.zeros((n, 4))
    want, *want_tex = bounce_fused.bounce_fused_plain(
        tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(), t["depth"],
        t["prev"], medium, seed, nee=nee, features=feats, tex_defer=True, mesh=km)
    outs = [torch.empty((n, 3)) for _ in range(4)] + [
        torch.empty(n, dtype=torch.uint8), torch.empty(n), torch.empty(n), torch.empty((n, 4))]
    tex_out = [torch.empty(n) for _ in range(3)]
    host_lib.host_bounce(
        tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(), tables[2].data_ptr(),
        tables[3].data_ptr(), seed, int(nee), n,
        *(t[k].data_ptr() for k in ("origin", "direction", "throughput", "sample", "depth",
                                    "prev")),
        medium.data_ptr(), *(o.data_ptr() for o in outs), None, None, *VACUUM, 4,
        trace.surface_bits(feats), *(o.data_ptr() for o in tex_out), *_mesh_args(km),
    )
    contrib, next_o, next_d, thr_mult, terminate, wspec, rru, _ = outs
    assert torch.equal(terminate.bool(), want.terminate)
    assert torch.equal(wspec, want.was_specular) and torch.equal(rru, want.rr_uniform)
    assert torch.equal(tex_out[2], want_tex[2])
    close = torch.ones(n, dtype=torch.bool)
    for got, ref in ((contrib, want.contrib), (next_o, want.next_origin),
                     (next_d, want.next_direction), (thr_mult, want.throughput_mult),
                     *zip(tex_out[:2], (w[:, None] for w in want_tex[:2]))):
        close &= torch.isclose(got.reshape(ref.shape), ref, rtol=2e-6, atol=2e-6).all(-1)
    frac = float(close.float().mean())
    slots = int((want_tex[2] >= 0).sum())
    print(f"2mt nee={nee}: {slots} image-textured events; lanes within 2e-6: {frac:.5f}")
    assert frac >= 0.995 and slots > 100


# ---- differentiable surface physics: kernels 4s and 5s, 2r-s and 3s (the
# kSurf instances of the gradient kernels; kVol x kSurf too)


def _surf_grad_scene(name, res):
    """A scene of the gradient kernels' surface instances at ``res``: a
    file of ``scenes/``, ``scene/variants.ggx_ward_scene`` or a case of
    ``tests/test_torch_surface_diff.py``; its tables and resolved
    features."""
    from pathtracer_tpu_torch.render.features import features_for_materials
    from pathtracer_tpu_torch.scene.variants import ggx_ward_scene
    from tests import test_torch_surface_diff as sd

    texts = {"ggx_ward": ggx_ward_scene(), "checker_bump_mini": sd.CHECKER_BUMP_MINI,
             "ct_mini": sd.CT_MINI, "surf_vol_mini": sd.SURF_VOL_MINI}
    if name in texts:
        desc = parse_scene_text(texts[name], name=name)
    else:
        desc = load_scene(os.path.join(HERE, "..", "scenes", f"{name}.txt"))
    scene = dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cpu")
    feats = frozenset(features_for_materials(scene.materials))
    return scene, [t.contiguous() for t in pack_tables(scene)], feats


# scene, resolution, options, least share of lanes whose residuals are
# within 2e-6
SURF_GRAD_CASES = {
    "ward": ("ward", (24, 24), dict(max_depth=6, nee=True, rr=False, rr_start=3), 0.98),
    "textured": ("textured", (24, 24), dict(max_depth=6, nee=True, rr=False, rr_start=3), 0.98),
    "ggx_ward_rr": ("ggx_ward", (24, 24), dict(max_depth=4, nee=True, rr=True, rr_start=1), 0.98),
    "checker_bump_mini_no_nee": ("checker_bump_mini", (24, 24),
                                 dict(max_depth=3, nee=False, rr=False, rr_start=3), 0.98),
    "surf_vol_mini": ("surf_vol_mini", (24, 24), dict(max_depth=4, nee=True, rr=False,
                                                      rr_start=3), 0.98),
}


@pytest.mark.parametrize("case", sorted(SURF_GRAD_CASES))
def test_trace_grad_surf_lanes_match_plain(host_lib, case):
    """Kernels 4s and 5s (``trace_grad.cu``'s kSurf instances; on
    surf_vol_mini the kVol x kSurf ones): the forward lanes against
    ``tfwd_plain(features=...)`` (equal ray counts, radiance and every
    residual plane within 2e-6 on at least 98% of lanes: the host's libm
    rounds sin / cos / exp / log apart from torch's, and the bump's phases
    near 10^3 rad carry that into later bounces, as in the forward cases),
    and the reverse lanes on the plain version's residuals against
    ``tbwd_plain``'s float64 reference at the bars of the media cases:
    every table cotangent within 1e-4 of itself plus 1e-6 of its table's
    largest, every component of d_origin / d_direction within rtol = atol
    = 1e-5 on at least 99.99% of lanes.  The surface columns (the second
    colour, the bump's, the roughness) get gradients."""
    name, res, kw, min_res = SURF_GRAD_CASES[case]
    scene, tables, feats = _surf_grad_scene(name, res)
    vol = "volumetric" in feats
    surf = trace.surface_bits(feats)
    assert surf
    n, seed = res[0] * res[1], 5151
    pixel = torch.arange(n)
    sample = 3 * n + pixel
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
    g, m = tables[0].shape[0], tables[1].shape[0]
    bits = sample.to(torch.int32)
    flags = (kw["max_depth"], int(kw["nee"]), int(kw["rr"]), kw["rr_start"])
    skw = dict(kw, features=feats)

    rad_p, nr_p, res_p = trace_grad.tfwd_plain(*tables, seed, rays.origin, rays.direction,
                                               sample, **skw)
    rad_k, res_k, nr_k = torch.empty((n, 3)), torch.empty_like(res_p), ctypes.c_ulonglong()
    host_lib.host_fwd(tables[0].data_ptr(), g, tables[1].data_ptr(), tables[2].data_ptr(),
                      tables[3].data_ptr(), seed, rays.origin.data_ptr(),
                      rays.direction.data_ptr(), bits.data_ptr(), n, rad_k.data_ptr(),
                      ctypes.byref(nr_k), res_k.data_ptr(), *flags, int(vol), 1, surf)
    rad_frac = float(torch.isclose(rad_k, rad_p, rtol=2e-6, atol=2e-6).all(-1).float().mean())
    res_frac = float(
        torch.isclose(res_k, res_p, rtol=2e-6, atol=2e-6).all(0).all(0).float().mean())

    g_rad = torch.from_numpy(np.random.default_rng(12).standard_normal((n, 3)).astype(np.float32))
    want = trace_grad.tbwd_plain(*tables, seed, sample, res_p, g_rad, dtype=torch.float64, **skw)
    d_o, d_d = torch.empty((n, 3)), torch.empty((n, 3))
    row = torch.empty(trace_grad.grad_row_len(g, m))
    host_lib.host_bwd(tables[0].data_ptr(), g, tables[1].data_ptr(), m, tables[2].data_ptr(),
                      tables[3].data_ptr(), seed, bits.data_ptr(), n, res_p.data_ptr(),
                      g_rad.data_ptr(), d_o.data_ptr(), d_d.data_ptr(), row.data_ptr(), *flags,
                      int(vol), 1, surf)
    got = (*trace_grad.split_grad_row(row, g, m), d_o, d_d)
    shares = [_lane_share(k, w) for k, w in zip(got[4:], want[4:])]
    surf_cols = [c for c in (18, 19, 20, 21, 22, 25, 26) if float(want[1][:, c].abs().max()) > 0]
    print(f"{case}: forward lanes within 2e-6: radiance {rad_frac:.5f}, residuals "
          f"{res_frac:.5f}; rays kernel {nr_k.value}, plain {int(nr_p)}; reverse lanes within "
          f"1e-5 of the float64 reference {shares}; material columns with gradient {surf_cols}")
    assert rad_frac >= min_res and res_frac >= min_res
    assert abs(nr_k.value - int(nr_p)) <= 2e-3 * int(nr_p)
    _check_table_cotangents(got[:4], want[:4])
    assert min(shares) >= 0.9999
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert surf_cols


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("scene_name", ["ggx_ward", "textured", "surf_vol_mini"])
def test_bounce_surf_replay_and_backward_lanes_match_plain(host_lib, scene_name, nee):
    """Kernel 2r-s (``bounce.cu``'s kSurf instance with the replay planes;
    on surf_vol_mini kVol x kSurf with seeded media) against
    ``bounce_fused_plain(features=..., emit_replay=True)`` on 2,048 random
    lanes: replay planes, terminate, emit state and the medium equal on
    every lane, the float planes within 2e-6 on at least 99.5% of lanes; and
    kernel 3s (``bounce_grad.cu``'s kSurf instance) on those planes with
    seeded cotangents on every lane against ``bounce_bwd_plain``'s float64
    reference at the media cases' bars: every table cotangent within 1e-4 of
    itself plus 1e-6 of its table's largest, every component of the carry
    cotangents within rtol = atol = 1e-5 on at least 99.99% of the lanes
    whose forward planes agree, misses and light hits included.  A lane
    whose forward the host's libm moved (one of textured's: the bump's sin
    near 10^3 rad) differentiates other values; it is printed, with its
    backward's worst difference."""
    n, seed = 2048, 61
    _, tables, feats = _surf_grad_scene(scene_name, (8, 8))
    vol = "volumetric" in feats
    surf = trace.surface_bits(feats)
    lanes = random_lanes(n, seed=47)
    centre = np.array({"ggx_ward": [0.0, 2.0, 0.0], "textured": [0.0, 4.0, -1.0]}.get(
        scene_name, [0.0, 3.0, 1.0]))
    lanes["origin"] = (lanes["origin"] * 0.8 + centre).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    if vol:
        from tests.test_torch_volume import medium_carries

        sa, ss, _ = medium_carries(n, seed=48)
        medium = torch.from_numpy(np.ascontiguousarray(np.concatenate([sa, ss[:, None]], -1)))
    else:
        medium = torch.zeros((n, 4))
    keys = ("origin", "direction", "throughput", "sample", "depth", "prev")
    args = (tables, *(t[k].long() if k == "sample" else t[k] for k in keys))
    want, want_gid, want_nee = bounce_fused.bounce_fused_plain(
        *args, medium, seed, nee=nee, features=feats, emit_replay=True)
    outs = [torch.empty((n, 3)) for _ in range(4)] + [
        torch.empty(n, dtype=torch.uint8), torch.empty(n), torch.empty(n), torch.empty((n, 4))]
    rgid, rnee = torch.empty(n), torch.empty(n)
    host_lib.host_bounce(
        tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(), tables[2].data_ptr(),
        tables[3].data_ptr(), seed, int(nee), n, *(t[k].data_ptr() for k in keys),
        medium.data_ptr(), *(o.data_ptr() for o in outs), rgid.data_ptr(), rnee.data_ptr(),
        int(vol), 0, 1, 4, surf, None, None, None, *NO_MESH,
    )
    contrib, next_o, next_d, thr_mult, terminate, wspec, _, out_medium = outs
    assert torch.equal(rgid, want_gid) and torch.equal(rnee, want_nee)
    assert torch.equal(terminate.bool(), want.terminate)
    assert torch.equal(wspec, want.was_specular) and torch.equal(out_medium, want.next_medium)
    close = torch.ones(n, dtype=torch.bool)
    for got, ref in ((contrib, want.contrib), (next_o, want.next_origin),
                     (next_d, want.next_direction), (thr_mult, want.throughput_mult)):
        close &= torch.isclose(got, ref, rtol=2e-6, atol=2e-6).all(-1)
    frac = float(close.float().mean())
    miss, light = rgid < 0, (rgid >= 0) & want.terminate
    assert frac >= 0.995 and int(miss.sum()) > 0 and int(light.sum()) > 0

    r = np.random.default_rng(10)
    cots = [torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32)) for _ in range(4)]
    g_med = torch.from_numpy(r.standard_normal((n, 4)).astype(np.float32))
    bargs = (*args, rgid, rnee, *cots, seed)
    bkw = dict(nee=nee, features=feats)
    if vol:
        bkw.update(medium=medium, g_medium=g_med)
    ref = bounce_grad.bounce_bwd_plain(*bargs, dtype=torch.float64, **bkw)
    g, m = tables[0].shape[0], tables[1].shape[0]
    d_o, d_d, d_t, d_m = (torch.empty((n, 3)), torch.empty((n, 3)), torch.empty((n, 3)),
                          torch.empty((n, 4)))
    row = torch.empty(trace_grad.grad_row_len(g, m))
    host_lib.host_bounce_bwd(
        tables[0].data_ptr(), g, tables[1].data_ptr(), m, tables[2].data_ptr(),
        tables[3].data_ptr(), seed, int(nee), n, *(t[k].data_ptr() for k in keys),
        rgid.data_ptr(), rnee.data_ptr(), *(c.data_ptr() for c in cots), d_o.data_ptr(),
        d_d.data_ptr(), d_t.data_ptr(), row.data_ptr(), int(vol), 1, surf,
        *((medium.data_ptr(), g_med.data_ptr(), d_m.data_ptr()) if vol else NO_MEDIUM), None,
    )
    got = (*trace_grad.split_grad_row(row, g, m), d_o, d_d, d_t) + ((d_m,) if vol else ())
    shares = [_lane_share(k[close], w[close]) for k, w in zip(got[4:], ref[4:])]
    moved = {int(i): max(float((k[i].double() - w[i]).abs().max())
                         for k, w in zip(got[4:], ref[4:]))
             for i in torch.nonzero(~close).ravel()}
    surf_cols = [c for c in (18, 19, 20, 21, 22, 25, 26) if float(ref[1][:, c].abs().max()) > 0]
    print(f"{scene_name} nee={nee}: {int(miss.sum())} misses, {int(light.sum())} light hits; "
          f"2r-s lanes within 2e-6: {frac:.5f}; 3s lanes within 1e-5 of the float64 reference "
          f"{shares}; lanes the host's libm moved and their backward's worst difference {moved}; "
          f"material columns with gradient {surf_cols}")
    _check_table_cotangents(got[:4], ref[:4])
    assert min(shares) >= 0.9999
    assert all(bool(torch.isfinite(x).all()) for x in got)
    assert surf_cols


# ---- kernel 1's persistent schedule


def _sched_scene(name, res):
    """A scene of the schedule's cases at ``res``: its tables, in-kernel
    mesh tables (or None), the launchers' media and surface arguments
    (volumetric, hg, surface bits) and the scene."""
    from pathtracer_tpu_torch.render.features import features_for_materials
    from pathtracer_tpu_torch.scene.variants import fog_mesh_scene

    if name == "mini":
        desc = parse_scene_text(MINI_SCENE, name=name)
    elif name.startswith("fog_mesh"):
        desc = parse_scene_text(fog_mesh_scene(name.endswith("glass")), name=name,
                                scene_dir=os.path.join(HERE, "..", "scenes"))
    else:
        desc = load_scene(os.path.join(HERE, "..", "scenes", f"{name}.txt"))
    scene = dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cpu")
    feats = frozenset(features_for_materials(scene.materials))
    flags = (*trace.media_args(feats, True)[:2], trace.surface_bits(feats))
    return [t.contiguous() for t in pack_tables(scene)], scene.mesh_tables, flags, scene


# scene, options, whether kernel 4 takes it (no meshes, no hg)
SCHED_CASES = {
    "mini_nee_rr": ("mini", dict(max_depth=3, nee=True, rr=True, rr_start=1), True),
    "cornell_d8": ("cornell", dict(max_depth=8, nee=True, rr=False, rr_start=3), True),
    "cornell_d8_rr": ("cornell", dict(max_depth=8, nee=True, rr=True, rr_start=3), True),
    "cornell_no_nee_rr": ("cornell", dict(max_depth=6, nee=False, rr=True, rr_start=2), True),
    "milky": ("milky", dict(max_depth=6, nee=True, rr=False, rr_start=3), True),
    "fog_rr": ("fog", dict(max_depth=6, nee=True, rr=True, rr_start=2), True),
    "glass_dof": ("glass_dof", dict(max_depth=6, nee=True, rr=False, rr_start=3), True),
    "ward": ("ward", dict(max_depth=6, nee=True, rr=True, rr_start=2), True),
    "textured": ("textured", dict(max_depth=6, nee=True, rr=False, rr_start=3), True),
    "sss_hg": ("sss", dict(max_depth=6, nee=True, rr=False, rr_start=3), False),
    "smooth_mesh": ("smooth_mesh", dict(max_depth=4, nee=True, rr=False, rr_start=3), False),
    "fog_mesh_glass": ("fog_mesh_glass", dict(max_depth=4, nee=True, rr=True, rr_start=2),
                       False),
}


@pytest.mark.parametrize("threads", [64, 200, 1024])
@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_persistent_schedule_matches_index_order(host_lib, case, threads):
    """Kernel 1 under a host emulation of its persistent schedule
    (``trace.cu:persistent_paths``: warps of 32 lanes in lockstep, one lane
    counter, a warp's free lanes refilled by rank as soon as one is free),
    the warps taking their passes in an uneven order, against the same
    lanes run one by one in index order: radiance and ray count bit-equal.
    29x31 lanes (not a multiple of 32) on 64 threads (each thread runs
    about 14 paths), on 200 (a part-filled warp) and on 1,024 (more threads
    than lanes).  Kernel 4, which keeps one path per thread, gives the same
    radiance and rays."""
    name, kw, fwd = SCHED_CASES[case]
    tables, km, (vol, hg, surf), scene = _sched_scene(name, (29, 31))
    n, seed = 29 * 31, 41
    pixel = torch.arange(n)
    sample = 3 * n + pixel
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
    bits = sample.to(torch.int32)  # kept alive across the calls
    flags = (kw["max_depth"], int(kw["nee"]), int(kw["rr"]), kw["rr_start"])
    common = (tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(),
              tables[2].data_ptr(), tables[3].data_ptr(), seed, rays.origin.data_ptr(),
              rays.direction.data_ptr(), bits.data_ptr(), n)
    mesh = _mesh_args(km) if km is not None else NO_MESH

    def nan(*shape):
        return torch.full(shape, float("nan"))

    rad_i, rad_s = nan(n, 3), nan(n, 3)
    nr_i, nr_s = ctypes.c_ulonglong(), ctypes.c_ulonglong()
    host_lib.host_trace(*common, rad_i.data_ptr(), ctypes.byref(nr_i), *flags, vol, hg, 1, surf,
                        *mesh)
    host_lib.host_trace_sched(*common, rad_s.data_ptr(), ctypes.byref(nr_s), *flags, vol, hg, 1,
                              surf, *mesh, threads)
    print(f"{case}: {nr_i.value} rays, {nr_i.value / n / (2 if kw['nee'] else 1):.3f} bounces "
          f"per lane of {kw['max_depth']}")
    assert nr_s.value == nr_i.value > 0
    assert torch.equal(rad_s, rad_i) and float(rad_i.sum()) > 0
    if not fwd:
        return
    nr = trace_grad.N_RESID_VOL if vol else trace_grad.N_RESID
    rad_f, res_f, nr_f = nan(n, 3), nan(kw["max_depth"], nr, n), ctypes.c_ulonglong()
    host_lib.host_fwd(*common, rad_f.data_ptr(), ctypes.byref(nr_f), res_f.data_ptr(), *flags,
                      vol, 1, surf)
    assert nr_f.value == nr_i.value and torch.equal(rad_f, rad_i)
    assert not bool(res_f.isnan().any())
    assert float(res_f[-1, nr - 3].mean()) < 1.0  # the alive plane: some paths ended early


@pytest.mark.parametrize("threads", [128, 256])
@pytest.mark.parametrize("case", sorted(c for c, (_, _, fwd) in SCHED_CASES.items() if fwd))
def test_fwd_block_packing_matches_index_order(host_lib, case, threads):
    """Kernel 4 as the card runs it (``trace_grad.cu:trace_fwd_kernel_packed``: a
    block's paths in its path planes, at each bounce every path's record,
    the live paths packed into the first threads for their bounces, every
    path's outcome), emulated block by block with the packed paths run in
    reverse, against the same lanes run one by one in index order
    (``fwd_lane``): radiance, ray count and the whole residual stack
    bit-equal, in the vacuum, kVol and kSurf instances.  29x31 lanes, not a
    multiple of the block of 128 or 256 paths."""
    name, kw, _ = SCHED_CASES[case]
    tables, _, (vol, _, surf), scene = _sched_scene(name, (29, 31))
    n, seed = 29 * 31, 43
    pixel = torch.arange(n)
    sample = 2 * n + pixel
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
    bits = sample.to(torch.int32)  # kept alive across the calls
    flags = (kw["max_depth"], int(kw["nee"]), int(kw["rr"]), kw["rr_start"], vol, 1, surf)
    common = (tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(),
              tables[2].data_ptr(), tables[3].data_ptr(), seed, rays.origin.data_ptr(),
              rays.direction.data_ptr(), bits.data_ptr(), n)
    nr = trace_grad.N_RESID_VOL if vol else trace_grad.N_RESID
    out = {}
    for packed in (False, True):
        rad = torch.full((n, 3), float("nan"))
        res = torch.full((kw["max_depth"], nr, n), float("nan"))
        rays_n = ctypes.c_ulonglong()
        if packed:
            host_lib.host_fwd_packed(*common, rad.data_ptr(), ctypes.byref(rays_n),
                                     res.data_ptr(), *flags, threads)
        else:
            host_lib.host_fwd(*common, rad.data_ptr(), ctypes.byref(rays_n), res.data_ptr(),
                              *flags)
        out[packed] = (rad, rays_n.value, res)
    (rad_i, nr_i, res_i), (rad_p, nr_p, res_p) = out[False], out[True]
    alive = res_i[:, nr - 3]
    print(f"{case}, blocks of {threads}: {nr_i} rays; live lanes per bounce "
          + " ".join(f"{float(a.mean()):.3f}" for a in alive))
    assert nr_p == nr_i > 0
    assert torch.equal(rad_p, rad_i) and float(rad_i.sum()) > 0
    assert torch.equal(res_p, res_i) and not bool(res_i.isnan().any())
    assert float(alive[-1].mean()) < 1.0  # some paths ended early: the packing had work


def _mesh_bounce_lanes(tmp_path, name):
    """Lanes of kernel 2m (smooth_mesh, random rays around the icosphere)
    or 2mt (a vt grid of 24 cells, rays aimed at it): the tables, in-kernel
    meshes, surface bits and deferred-texel flag, and the lanes."""
    n = 2048
    if name == "2m":
        scene, tables = _mesh_scene((8, 8))
        lanes = random_lanes(n, seed=12)
        lanes["origin"] = (lanes["origin"] * 0.7 + np.array([0.0, 1.8, 0.0])).astype(np.float32)
        t = {k: torch.from_numpy(v) for k, v in lanes.items()}
        return tables, scene.mesh_tables, 0, False, t
    scene, tables, feats = _bigmesh_scene("grid24", tmp_path)
    return tables, scene.mesh_tables, trace.surface_bits(feats), True, _aimed(
        (0.3, 2.4, 2.5), n, seed=23)


def _host_bounce_planes(host_lib, tables, km, surf, tex, t, nee):
    """Every output plane of kernel 2's lanes with in-kernel meshes, each
    lane sweeping the triangles on its own (``host_bounce``)."""
    n = t["origin"].shape[0]
    outs = [torch.empty((n, 3)) for _ in range(4)] + [
        torch.empty(n, dtype=torch.uint8), torch.empty(n), torch.empty(n), torch.empty((n, 4))]
    tex_out = [torch.empty(n) for _ in range(3)] if tex else [None] * 3
    medium = torch.zeros((n, 4))
    host_lib.host_bounce(
        tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(), tables[2].data_ptr(),
        tables[3].data_ptr(), 77, int(nee), n,
        *(t[k].data_ptr() for k in ("origin", "direction", "throughput", "sample", "depth",
                                    "prev")),
        medium.data_ptr(), *(o.data_ptr() for o in outs), None, None, *VACUUM, 4, surf,
        *(None if o is None else o.data_ptr() for o in tex_out), *_mesh_args(km),
    )
    return outs + [o for o in tex_out if o is not None]


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("name", ["2m", "2mt"])
def test_bounce_mesh_block_sweep_matches_the_lane_sweep(host_lib, tmp_path, name, nee):
    """Kernel 2m and 2mt as the card runs them (``bounce.cu``: each block of
    128 lanes sweeps the triangles together, ``block_mesh_sweep``: a chunk
    no lane reaches skipped, a reaching lane's 32 triangle tests shared out
    and its first minimum taken), emulated block by block, against every
    lane sweeping on its own (``mesh_sweep``): every output plane bit-equal,
    on 2,000 lanes (not a multiple of the block), dealt to the blocks in
    index order and in a shuffled order (a lane's winner does not depend on
    its block-mates).  Some lanes of each case reach a chunk, some do not."""
    from pathtracer_tpu_torch.ops.mesh_tables import mesh_sweep

    tables, km, surf, tex, t = _mesh_bounce_lanes(tmp_path, name)
    n = 2000
    t = {k: v[:n].contiguous() for k, v in t.items()}
    want = _host_bounce_planes(host_lib, tables, km, surf, tex, t, nee)
    medium = torch.zeros((n, 4))
    shuffled = torch.from_numpy(np.random.default_rng(9).permutation(n).astype(np.int32))
    for order in (None, shuffled):
        outs = [torch.empty((n, 3)) for _ in range(4)] + [
            torch.empty(n, dtype=torch.uint8), torch.empty(n), torch.empty(n),
            torch.empty((n, 4))]
        tex_out = [torch.empty(n) for _ in range(3)] if tex else [None] * 3
        host_lib.host_bounce_blocks(
            tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(),
            tables[2].data_ptr(), tables[3].data_ptr(), 77, int(nee), n,
            *(t[k].data_ptr() for k in ("origin", "direction", "throughput", "sample", "depth",
                                        "prev")),
            medium.data_ptr(), *(o.data_ptr() for o in outs), surf,
            *(None if o is None else o.data_ptr() for o in tex_out), *_mesh_args(km),
            None if order is None else order.data_ptr(), 128,
        )
        got = outs + [o for o in tex_out if o is not None]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    reached = mesh_sweep(km, tables[0], t["origin"].unbind(-1), t["direction"].unbind(-1))[
        "reached"]
    print(f"{name} nee={nee}: {int((reached > 0).sum())} of {n} lanes reach a chunk, "
          f"{int(reached.sum())} lane-chunks, at most {int(reached.max())} for one lane")
    assert 100 < int((reached > 0).sum()) < n


# ---- kernel 2's grouped kernel (bounce.cu:bounce_kernel_grouped, 2r-v):
# each block's lanes shaded in the order of the event their nearest hit
# gives


GROUPED_N = 16 * 128 + 77  # a partial last block at 128 and at 256 lanes
# media scenes of 2r-v and the centre of their random lanes
GROUPED_SCENES = {"sss": (0.0, 1.2, 0.0), "milky": (2.2, 1.6, 1.5)}


def _grouped_lanes(name):
    """Random lanes about a media scene: its tables, the lanes and seeded
    medium carries ``[N, 4]`` (2r-v's: volumetric, no hg)."""
    from tests.test_torch_volume import medium_carries

    _, tables, _, _ = _media_scene(name, (8, 8))
    lanes = random_lanes(GROUPED_N, seed=23)
    lanes["origin"] = (lanes["origin"] * 0.8 + np.asarray(GROUPED_SCENES[name])).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    sa, ss, _ = medium_carries(GROUPED_N, seed=24)
    medium = torch.from_numpy(np.ascontiguousarray(np.concatenate([sa, ss[:, None]], -1)))
    return tables, t, medium


GROUPED_PLANES = ("origin", "direction", "throughput", "sample", "depth", "prev")


def _grouped_outputs(tables, t, medium, nee: bool, vol_nee: bool, host_fn, *tail):
    """Every output plane of 2r-v's lanes, the replay planes included, by
    ``host_fn`` (``host_bounce`` with the kVol flags, or
    ``host_bounce_grouped`` with ``tail``: the order and the block size),
    as int32 bit patterns."""
    n, width = GROUPED_N, medium.shape[1]
    outs = [torch.empty((n, 3)) for _ in range(4)] + [
        torch.empty(n, dtype=torch.uint8), torch.empty(n), torch.empty(n),
        torch.empty((n, width)), torch.empty(n), torch.empty(n)]
    head = (tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(),
            tables[2].data_ptr(), tables[3].data_ptr(), 5, int(nee), n,
            *(t[k].data_ptr() for k in GROUPED_PLANES), medium.data_ptr(),
            *(o.data_ptr() for o in outs))
    if tail:
        host_fn(*head, int(vol_nee), width, *tail)
    else:  # host_bounce: volumetric, no hg, no surface bits, no texel, no mesh
        host_fn(*head, 1, 0, int(vol_nee), width, 0, None, None, None, *NO_MESH)
    return [o.view(torch.uint8 if o.dtype == torch.uint8 else torch.int32) for o in outs]


def _event_keys_of(host_lib, tables, t, medium):
    keys = torch.empty(GROUPED_N, dtype=torch.int32)
    host_lib.host_event_keys(tables[0].data_ptr(), tables[0].shape[0], tables[1].data_ptr(),
                             tables[2].data_ptr(), tables[3].data_ptr(), 5, GROUPED_N,
                             t["origin"].data_ptr(), t["direction"].data_ptr(),
                             t["sample"].data_ptr(), t["depth"].data_ptr(), medium.data_ptr(),
                             medium.shape[1], keys.data_ptr())
    return keys


GROUPED_CASES = [(name, nee, vol_nee) for name in GROUPED_SCENES for nee in (True, False)
                 for vol_nee in (True, False)]


@pytest.mark.parametrize("name, nee, vol_nee", GROUPED_CASES)
def test_bounce_grouped_blocks_match_index_order(host_lib, name, nee, vol_nee):
    """Kernel 2's grouped kernel as the card runs it (2r-v:
    ``host_bounce_grouped``, each block's lanes swept, ordered by event key
    through the lane planes and shaded in that order) against
    ``host_bounce``'s kVol instance with the replay planes (one lane after
    another in index order) on 2,125 random lanes: every output plane bit
    for bit, the replay planes too, in blocks of 128 and 256 lanes with a
    partial last block, with the lanes dealt to the blocks in index order
    and shuffled.  The lanes span several events in each block."""
    tables, t, medium = _grouped_lanes(name)
    want = _grouped_outputs(tables, t, medium, nee, vol_nee, host_lib.host_bounce)
    assert len(torch.unique(_event_keys_of(host_lib, tables, t, medium))) >= 4
    shuffled = torch.from_numpy(np.random.default_rng(3).permutation(GROUPED_N).astype(np.int32))
    for threads in (128, 256):
        for label, order in (("index", None), ("shuffled", shuffled)):
            got = _grouped_outputs(tables, t, medium, nee, vol_nee, host_lib.host_bounce_grouped,
                                   None if order is None else order.data_ptr(), threads)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (threads, label)


@pytest.mark.parametrize("name", sorted(GROUPED_SCENES))
def test_event_keys_match_plain(host_lib, name):
    """The event key by which the grouped kernel orders a block's lanes
    (``trace_common.cuh:event_key``) equals ``tools/kernel_split.event_keys``
    on every lane, that wider key's surface lobes mapped to the kernel's
    (the media instance has no bump, texture, Cook-Torrance or Ward)."""
    from pathtracer_tpu_torch.tools import kernel_split

    tables, t, medium = _grouped_lanes(name)
    got = _event_keys_of(host_lib, tables, t, medium).long()
    want = kernel_split.event_keys(tables, t["origin"], t["direction"], t["sample"].long(),
                                   t["depth"], medium, 5, frozenset({"volumetric"}))
    surface = want >= kernel_split.EV_SURFACE
    assert not bool(((want - kernel_split.EV_SURFACE) % 4)[surface].any())  # no bump, texture
    want = torch.where(surface, kernel_split.EV_SURFACE + (want - kernel_split.EV_SURFACE) // 4,
                       want)
    counts = torch.bincount(got, minlength=6)
    print(f"{name}: lanes per event key {counts.tolist()}")
    assert torch.equal(got, want)
    assert int(counts[kernel_split.EV_ENDS]) > 0 and int(counts[kernel_split.EV_SCATTER]) > 0
