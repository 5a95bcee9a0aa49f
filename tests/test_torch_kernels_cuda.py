"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test decides inside itself whether a card is
present and skips where there is none (nvcc builds the kernel on first
use).  Run on a machine with an NVIDIA H100:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerances (those of ``tests/test_trace_pallas.py`` for the TPU kernel
against its scan): equal ray counts; radiance within rtol = atol = 2e-6 on
at least 99.9% of lanes; the wavefront's sum within 1e-5 relative.  Kernel
and plain version run the same float32 operations in the same order
(nvcc -fmad=false, no fast math), so they usually agree bit for bit.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import os

import pytest
import torch

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import trace
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
from tests.test_bounce_grad import MINI_SCENE

pytestmark = pytest.mark.cuda

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")


def _scene(name, res):
    if name == "mini":
        desc = parse_scene_text(MINI_SCENE, name="mini")
    elif name == "glossy":  # the mirror sphere turned Phong-glossy
        desc = parse_scene_text(
            MINI_SCENE.replace("SPECEX 0\nSPECRGB .95 .92 .9", "SPECEX 30\nSPECRGB .95 .92 .9"),
            name="glossy",
        )
    else:
        desc = load_scene(os.path.join(ROOT, "scenes", f"{name}.txt"))
    return dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cuda")


@pytest.mark.parametrize(
    "name,res,kw",
    [
        ("cornell", (160, 120), dict(max_depth=8, nee=True)),
        ("mini", (64, 64), dict(max_depth=6, nee=False, russian_roulette=True, rr_start=1)),
        ("mini", (64, 64), dict(max_depth=4, nee=True)),
    ],
)
def test_trace_kernel_matches_plain(name, res, kw):
    _need_cuda()
    scene = _scene(name, res)
    cfg = RenderConfig(**kw)
    n = res[0] * res[1]
    pixel = torch.arange(n, device="cuda")
    seed = 1234
    for iteration in (0, 7):
        sample = iteration * n + pixel
        rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
        args = (*pack_tables(scene), seed, rays.origin, rays.direction, sample)
        opts = dict(max_depth=cfg.max_depth, nee=cfg.nee, rr=cfg.russian_roulette,
                    rr_start=cfg.rr_start)
        before = trace.launches
        rad_k, rays_k = trace.trace_cuda(*args, **opts)
        assert trace.launches == before + 1
        rad_p, rays_p = trace.trace_plain(*args, **opts)
        torch.cuda.synchronize()
        assert int(rays_k) == int(rays_p)
        close = torch.isclose(rad_k, rad_p, rtol=2e-6, atol=2e-6).all(-1)
        assert float(close.float().mean()) >= 0.999
        total = float(rad_p.double().sum())
        assert abs(float(rad_k.double().sum()) - total) <= 1e-5 * abs(total)


def test_render_launches_once_per_iteration():
    _need_cuda()
    scene = _scene("cornell", (64, 48))
    before = trace.launches
    img, accum, stats = render(scene, 5, RenderConfig(iters_per_launch=2), device="cuda")
    torch.cuda.synchronize()
    assert trace.launches - before == 5
    assert img.shape == (48, 64, 3) and bool(torch.isfinite(accum).all())
    assert stats["rays_traced"] > 0


def test_wrapper_checks_inputs():
    _need_cuda()
    scene = _scene("mini", (8, 8))
    gtab, mtab, ltab, scal = pack_tables(scene)
    o = torch.zeros((4, 3), device="cuda")
    d = torch.ones((4, 3), device="cuda")
    s = torch.arange(4, device="cuda")
    kw = dict(max_depth=2, nee=True, rr=False, rr_start=3)
    with pytest.raises(TypeError):
        trace.trace_cuda(gtab.double(), mtab, ltab, scal, 1, o, d, s, **kw)
    with pytest.raises(ValueError):
        trace.trace_cuda(gtab, mtab, ltab, scal, 1, torch.zeros((3, 4), device="cuda").t(), d, s, **kw)
    big = gtab.repeat(trace.MAX_GEOMS, 1)
    with pytest.raises(ValueError):
        trace.trace_cuda(big, mtab, ltab.repeat(trace.MAX_GEOMS, 1), scal, 1, o, d, s, **kw)


# ---- the differentiable trace: forward with residuals and reverse kernels
#
# Tolerances (those chip_smoke.py holds at full width): the forward kernel's
# radiance equals the trace kernel's bit for bit (same device function),
# its ray count equals the plain version's, and its residual planes are
# within 2e-6 of the plain version's on at least 99.9% of lanes.  The
# reverse kernel's d_origin / d_direction have every component within
# rtol = atol = 1e-5 of the float64 reference's (tbwd_plain with
# dtype=float64: float64 autograd at the float32 bounce's values, as the
# kernel's adjoint runs in double at them) on at least 99.9% of lanes; the
# float32 plain version misses that bar on up to 0.14% of Cornell's lanes,
# where a component is the small difference of large terms that float32
# autograd rounds.  Each table cotangent within 1e-4 of the largest
# magnitude in its table of the float32 plain version's (sums over lanes
# in another order, with shared-memory float atomics inside a block).

GRAD_CASES = [
    ("cornell", (160, 120), dict(max_depth=8, nee=True, rr=False, rr_start=3)),
    ("mini", (37, 23), dict(max_depth=3, nee=True, rr=True, rr_start=1)),
    ("mini", (64, 64), dict(max_depth=4, nee=False, rr=True, rr_start=1)),
    ("glossy", (64, 64), dict(max_depth=4, nee=True, rr=False, rr_start=3)),
]


def _grad_inputs(name, res, seed=77, iteration=2):
    from pathtracer_tpu_torch.ops import trace_grad  # noqa: F401

    scene = _scene(name, res)
    n = res[0] * res[1]
    pixel = torch.arange(n, device="cuda")
    sample = iteration * n + pixel
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
    return pack_tables(scene), seed, rays, sample


@pytest.mark.parametrize("name,res,kw", GRAD_CASES)
def test_trace_fwd_kernel_matches_plain(name, res, kw):
    _need_cuda()
    from pathtracer_tpu_torch.ops import trace_grad

    tables, seed, rays, sample = _grad_inputs(name, res)
    args = (*tables, seed, rays.origin, rays.direction, sample)
    before = trace_grad.fwd_launches
    rad_k, nr_k, res_k = trace_grad.tfwd_cuda(*args, **kw)
    assert trace_grad.fwd_launches == before + 1
    rad_t, nr_t = trace.trace_cuda(*args, **kw)
    rad_p, nr_p, res_p = trace_grad.tfwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(rad_k, rad_t) and int(nr_k) == int(nr_t) == int(nr_p)
    close = torch.isclose(res_k, res_p, rtol=2e-6, atol=2e-6).all(1)
    assert float(close.float().mean()) >= 0.999


@pytest.mark.parametrize("name,res,kw", GRAD_CASES)
def test_trace_bwd_kernel_matches_plain(name, res, kw):
    _need_cuda()
    import numpy as np

    from pathtracer_tpu_torch.ops import trace_grad

    tables, seed, rays, sample = _grad_inputs(name, res)
    n = res[0] * res[1]
    _, _, resid = trace_grad.tfwd_plain(*tables, seed, rays.origin, rays.direction, sample, **kw)
    g_rad = torch.from_numpy(
        np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    ).cuda()
    before = trace_grad.bwd_launches
    got = trace_grad.tbwd_cuda(*tables, seed, sample, resid, g_rad, **kw)
    assert trace_grad.bwd_launches == before + 1
    want = trace_grad.tbwd_plain(*tables, seed, sample, resid, g_rad, **kw)
    ref = trace_grad.tbwd_plain(*tables, seed, sample, resid, g_rad, dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[:4], want[:4]):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30)
    for g, w in zip(got[4:], ref[4:]):
        assert bool(torch.isfinite(g).all())
        close = torch.isclose(g.double(), w, rtol=1e-5, atol=1e-5).all(-1)
        assert float(close.double().mean()) >= 0.999


def test_loss_and_grad_launches_both_kernels_once_per_iteration():
    _need_cuda()
    from pathtracer_tpu_torch.ops import trace_grad
    from pathtracer_tpu_torch.ops.rng import prng_key
    from pathtracer_tpu_torch.render import diff

    desc = dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", "cornell.txt")),
                               resolution=(64, 48))
    params, static = diff.params_from_description(desc, 0, device="cuda")
    target = torch.zeros((64 * 48, 3), device="cuda")
    cfg = RenderConfig(max_depth=5)
    f0, b0 = trace_grad.fwd_launches, trace_grad.bwd_launches
    loss, grads, rays = diff.loss_and_grad_rays(params, static, target, 3, prng_key(0), cfg)
    torch.cuda.synchronize()
    assert (trace_grad.fwd_launches - f0, trace_grad.bwd_launches - b0) == (3, 3)
    leaves = grads.leaves()
    assert all(bool(torch.isfinite(v).all()) for v in leaves.values())
    assert float(loss) > 0 and int(rays) > 3 * 64 * 48
    # the plain versions on the CPU give the same loss and gradients (the
    # CPU's sin / cos / exp round differently from the card's: 5e-4 bar)
    cp, _ = diff.params_from_description(desc, 0, device="cpu")
    loss_c, grads_c = diff.loss_and_grad(cp, static, target.cpu(), 3, prng_key(0), cfg,
                                         device="cpu")
    assert abs(float(loss) - float(loss_c)) <= 1e-4 * abs(float(loss_c))
    cl = grads_c.leaves()
    gscale = max(float(v.abs().max()) for v in cl.values())
    for k, v in leaves.items():
        assert float((v.cpu() - cl[k]).abs().max()) <= 5e-4 * max(gscale, 1.0), k


def test_grad_wrappers_check_inputs():
    _need_cuda()
    from pathtracer_tpu_torch.ops import trace_grad

    tables, seed, rays, sample = _grad_inputs("mini", (8, 8))
    kw = dict(max_depth=2, nee=True, rr=False, rr_start=3)
    gtab, mtab, ltab, scal = tables
    with pytest.raises(TypeError):
        trace_grad.tfwd_cuda(gtab.double(), mtab, ltab, scal, seed, rays.origin,
                             rays.direction, sample, **kw)
    with pytest.raises(ValueError):
        trace_grad.tfwd_cuda(*tables, seed, rays.origin[:5], rays.direction, sample, **kw)
    resid = torch.zeros((2, trace_grad.N_RESID, 64), device="cuda")
    g = torch.zeros((64, 3), device="cuda")
    with pytest.raises(ValueError):
        trace_grad.tbwd_cuda(*tables, seed, sample, resid[:1], g, **kw)
    with pytest.raises(ValueError):
        trace_grad.tbwd_cuda(*tables, seed, sample, resid, g.t().contiguous().t(), **kw)
    with pytest.raises(ValueError):
        trace_grad.tbwd_cuda(*tables, seed, sample, resid, g.cpu(), **kw)


# ---- the per-bounce kernel (kernel 2) and the split route's nearest-hit
# and occlusion kernels (kernels 6 and 8)
#
# Tolerances (those chip_smoke.py holds at full width): kernel 2's
# terminate, emit state and russian-roulette uniform equal the plain
# version's on every lane, and every float plane is within rtol = atol =
# 2e-6 on at least 99.9% of lanes, terminated lanes included (the kernel
# defines every output on every lane, as bounce_physics does).  Kernel 6's
# t, gid and mid equal on every lane, its frame within 2e-6 on at least
# 99.9%; kernel 8's t equal on every lane (the same float32 operations in
# the same order, and the card's sqrtf rounds as torch's CUDA sqrt).


def _random_lanes_cuda(n, seed):
    """Lanes of one bounce, as ``tests/test_torch_shade.random_lanes`` makes
    them (that module imports the JAX package)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    lanes = dict(
        origin=(rng.standard_normal((n, 3)) * 3.0).astype(np.float32),
        direction=(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32),
        throughput=rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
        sample=rng.integers(0, 10_000_000, n).astype(np.int32),
        depth=rng.integers(0, 8, n).astype(np.int32),
        prev=rng.choice(np.array([0.0, 1.0, 2.0], np.float32), n, p=[0.6, 0.3, 0.1]),
    )
    return {k: torch.from_numpy(v).cuda() for k, v in lanes.items()}


@pytest.mark.parametrize("name", ["cornell", "glossy"])
@pytest.mark.parametrize("nee", [True, False])
def test_bounce_kernel_matches_plain(name, nee):
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused

    scene = _scene(name, (8, 8))
    tables = pack_tables(scene)
    n = 50_000
    t = _random_lanes_cuda(n, 8)
    medium = torch.zeros((n, 4), device="cuda")
    args = (tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(),
            t["depth"], t["prev"], medium, 4321)
    before = bounce_fused.launches
    got = bounce_fused.bounce_fused_cuda(*args, nee=nee)
    assert bounce_fused.launches == before + 1
    want = bounce_fused.bounce_fused_plain(*args, nee=nee)
    torch.cuda.synchronize()
    assert torch.equal(got.terminate, want.terminate)
    assert torch.equal(got.was_specular, want.was_specular)
    assert torch.equal(got.rr_uniform, want.rr_uniform)
    assert torch.equal(got.next_medium, want.next_medium)
    close = torch.ones(n, dtype=torch.bool, device="cuda")
    for f in ("contrib", "next_origin", "next_direction", "throughput_mult"):
        close &= torch.isclose(getattr(got, f), getattr(want, f), rtol=2e-6, atol=2e-6).all(-1)
    assert float(close.float().mean()) >= 0.999


@pytest.mark.parametrize("name", ["cornell", "glossy"])
def test_intersect_kernels_match_plain(name):
    _need_cuda()
    from pathtracer_tpu_torch.ops import intersect_cuda
    from pathtracer_tpu_torch.ops.intersect import nearest_hit_plain, occlusion_t_plain
    from pathtracer_tpu_torch.scene.structs import Rays

    gtab = pack_tables(_scene(name, (8, 8)))[0]
    t = _random_lanes_cuda(50_000, 9)
    rays = Rays(t["origin"], t["direction"])
    before = (intersect_cuda.nearest_launches, intersect_cuda.occlusion_launches)
    got = intersect_cuda.nearest_hit(rays, gtab)
    occ = intersect_cuda.occlusion_t(rays, gtab)
    assert (intersect_cuda.nearest_launches, intersect_cuda.occlusion_launches) == (
        before[0] + 1, before[1] + 1)
    want = nearest_hit_plain(rays, gtab)
    want_occ = occlusion_t_plain(rays, gtab)
    torch.cuda.synchronize()
    _assert_nearest_equal(got, want, name)
    assert torch.equal(occ, want_occ)


def _assert_nearest_equal(got, want, label):
    """Kernel 6's t, hit, gid and mid equal to the plain version's on every lane,
    its frame within 2e-6 on at least 99.9% (printed: the lanes whose frame
    is bit-equal)."""
    assert torch.equal(got.t, want.t) and torch.equal(got.geom_id, want.geom_id)
    assert torch.equal(got.hit, want.hit) and torch.equal(got.material_id, want.material_id)
    n = got.t.shape[0]
    same = torch.ones(n, dtype=torch.bool, device=got.t.device)
    for f in ("position", "position_obj", "normal"):
        a, b = getattr(got, f), getattr(want, f)
        close = torch.isclose(a, b, rtol=2e-6, atol=2e-6).all(-1)
        assert float(close.float().mean()) >= 0.999, f
        same &= (a == b).all(-1)
    print(f"{label}: kernel 6's frame bit-equal on {float(same.double().mean()):.6f} of {n} lanes")


@pytest.mark.parametrize("table,n", [("cornell", 1), ("cornell", 127), ("cornell", 129),
                                     ("cornell", 50_001), ("cornell repeated rows", 50_001),
                                     ("one geom", 4_097), ("max geoms", 50_001)])
def test_intersect_kernels_on_stress_lanes(table, n):
    """Kernels 6, 7 and 8 on ``tests/intersect_lanes.py``'s lanes: rays at
    the corners and edges where cubes meet, exact ties between repeated
    rows (the first in index order wins), direction components of 0 and
    around 1e-12; n = 1, 127, 129 and 50,001 (a thread's partial set of rays
    and a partial last block) and tables of 1 and ``MAX_GEOMS`` rows.
    Kernels 6, 7 and 8 equal to their plain versions (kernel 6's frame
    within 2e-6 on 99.9%)."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import intersect_cuda
    from pathtracer_tpu_torch.ops.intersect import (
        nearest_hit_plain,
        occlusion_t_plain,
        winner_t_gid_plain,
    )
    from pathtracer_tpu_torch.scene.structs import Rays
    from tests.intersect_lanes import stress_rays, stress_table

    gtab = stress_table(table).cuda()
    o, d = stress_rays(gtab.cpu(), n, 23)
    rays = Rays(o.cuda(), d.cuda())
    got = intersect_cuda.nearest_hit_cuda(rays, gtab)
    wt, wg = intersect_cuda.winner_t_gid_cuda(rays, gtab)
    occ = intersect_cuda.occlusion_t_cuda(rays, gtab)
    want = nearest_hit_plain(rays, gtab)
    pt, pg = winner_t_gid_plain(rays, gtab)
    want_occ = occlusion_t_plain(rays, gtab)
    torch.cuda.synchronize()
    _assert_nearest_equal(got, want, f"{table}, n={n}")
    assert torch.equal(wt, pt) and torch.equal(wg, pg)
    assert torch.equal(wt, got.t) and torch.equal(wg, got.geom_id)
    assert torch.equal(occ, want_occ)


@pytest.mark.parametrize("case", ["transforms", "transforms grazing", "cornell grazing",
                                  "cornell shadow rays"])
def test_occlusion_kernel_on_probe_lanes(case):
    """Kernel 8 on ``tests/intersect_lanes.py``'s probe lanes (random
    rotations and scales 0.01-10 with walls and sheared rows, rays grazing
    the primitives and the padded boxes of ``tools/occlusion_cull.py``,
    shadow rays made as the split route makes them), 50,001 of them: t
    equal to ``occlusion_t_plain`` on every lane."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import intersect_cuda
    from pathtracer_tpu_torch.ops.intersect import occlusion_t_plain
    from pathtracer_tpu_torch.scene.structs import Rays
    from tests.intersect_lanes import probe_case

    gtab, o, d = probe_case(case, 50_001)
    rays = Rays(o.cuda(), d.cuda())
    occ = intersect_cuda.occlusion_t_cuda(rays, gtab.cuda())
    want = occlusion_t_plain(rays, gtab.cuda())
    torch.cuda.synchronize()
    assert torch.equal(occ, want)


def test_occlusion_kernel_on_split_route_shadow_rays():
    """Kernel 8 on the shadow rays the split route launches it on: every
    launch of a 2-spp Cornell render at 96x72 (one per super-step), captured
    by a hook on ``occlusion_t_cuda``, equal to ``occlusion_t_plain`` on
    every lane."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import intersect_cuda
    from pathtracer_tpu_torch.ops.intersect import occlusion_t_plain
    from pathtracer_tpu_torch.render import wavefront

    scene = _scene("cornell", (96, 72))
    occ, launches = intersect_cuda.occlusion_t_cuda, []

    def recording(rays, gtab):
        t = occ(rays, gtab)
        launches.append(torch.equal(t, occlusion_t_plain(rays, gtab)))
        return t

    intersect_cuda.occlusion_t_cuda = recording
    try:
        wavefront.super_steps = 0
        render(scene, 2, RenderConfig(wavefront=True, fused=False, max_depth=8, nee=True),
               device="cuda")
        torch.cuda.synchronize()
    finally:
        intersect_cuda.occlusion_t_cuda = occ
    assert len(launches) == wavefront.super_steps > 0 and all(launches)


@pytest.mark.parametrize("engine", [dict(wavefront=True),
                                    dict(wavefront=True, wavefront_pinned=False,
                                         wavefront_capacity=1 << 11),
                                    dict(wavefront=True, fused=False)],
                         ids=["pinned", "queue", "split"])
def test_wavefront_render_launches_its_kernels_once_per_super_step(engine):
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused, intersect_cuda
    from pathtracer_tpu_torch.render import wavefront

    scene = _scene("cornell", (64, 48))
    _, mega, ms = render(scene, 4, RenderConfig(max_depth=6), device="cuda")
    counts = lambda: (trace.launches, bounce_fused.launches, intersect_cuda.nearest_launches,  # noqa: E731
                      intersect_cuda.occlusion_launches, wavefront.super_steps)
    before = counts()
    _, wave, ws = render(scene, 4, RenderConfig(max_depth=6, **engine), device="cuda")
    torch.cuda.synchronize()
    d = [a - b for a, b in zip(counts(), before)]
    steps = d[4]
    assert steps > 0 and d[0] == 0
    if engine.get("fused") is False:
        assert d[1:4] == [0, steps, steps]
    else:
        assert d[1:4] == [steps, 0, 0]
    assert ws["rays_traced"] == ms["rays_traced"]
    close = torch.isclose(wave, mega, rtol=2e-4, atol=2e-4)
    assert float(close.float().mean()) >= 0.999
    assert abs(float(wave.double().sum() - mega.double().sum())) <= 1e-5 * float(mega.double().sum())


def test_bounce_and_intersect_wrappers_check_inputs():
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused, intersect_cuda
    from pathtracer_tpu_torch.scene.structs import Rays

    tables = pack_tables(_scene("mini", (8, 8)))
    o, d = torch.zeros((4, 3), device="cuda"), torch.ones((4, 3), device="cuda")
    thr, s = torch.ones((4, 3), device="cuda"), torch.arange(4, device="cuda")
    prev, med = torch.zeros(4, device="cuda"), torch.zeros((4, 4), device="cuda")
    with pytest.raises(ValueError):
        bounce_fused.bounce_fused_cuda(tables, o[:3], d, thr, s, 0, prev, med, 1, nee=True)
    with pytest.raises(ValueError):
        bounce_fused.bounce_fused_cuda(tables, o, d, thr, s, 0, prev, med[:, :3], 1, nee=True)
    with pytest.raises(TypeError):
        intersect_cuda.nearest_hit_cuda(Rays(o.double(), d), tables[0])
    with pytest.raises(ValueError):
        intersect_cuda.occlusion_t_cuda(Rays(o, d), tables[0].repeat(200, 1))


# ---- the per-bounce differentiable engine (kernel 2 with replay planes and
# kernel 3) and the lean scan's winner search (kernel 7)
#
# Tolerances (those chip_smoke.py holds at full width): kernel 2's replay
# planes equal the plain version's on every lane and its other outputs equal
# the wavefront kernel's bit for bit (one kernel, two more stores); kernel
# 3's d_origin / d_direction / d_throughput have every component within
# rtol = atol = 1e-5 of the float64 reference's (bounce_bwd_plain with
# dtype=float64) on at least 99.9% of lanes, on random lanes with random
# cotangents on every lane (misses and light hits included: the kernel's
# mask-free contract), and each table cotangent within 1e-4 of the largest
# magnitude in its table of the float32 plain version's; zero cotangents
# give exact zeros.  Kernel 7's t and gid equal the plain version's on
# every lane.  The engines' losses and gradients match the full-depth
# engine's at the bars of tests/test_torch_diff.py.


@pytest.mark.parametrize("name", ["cornell", "glossy"])
@pytest.mark.parametrize("nee", [True, False])
def test_bounce_replay_and_backward_kernels_match_plain(name, nee):
    _need_cuda()
    import numpy as np

    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad

    tables = pack_tables(_scene(name, (8, 8)))
    n = 50_000
    t = _random_lanes_cuda(n, 10)
    medium = torch.zeros((n, 4), device="cuda")
    args = (tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(),
            t["depth"], t["prev"])
    before = (bounce_fused.launches, bounce_fused.replay_launches)
    res, rgid, rnee = bounce_fused.bounce_fused_cuda(*args, medium, 4321, nee=nee,
                                                     emit_replay=True)
    assert (bounce_fused.launches, bounce_fused.replay_launches) == (before[0], before[1] + 1)
    plain, pgid, pnee = bounce_fused.bounce_fused_plain(*args, medium, 4321, nee=nee,
                                                        emit_replay=True)
    plain_k = bounce_fused.bounce_fused_cuda(*args, medium, 4321, nee=nee)
    torch.cuda.synchronize()
    assert torch.equal(rgid, pgid) and torch.equal(rnee, pnee)
    for f in ("contrib", "next_origin", "next_direction", "throughput_mult", "terminate",
              "was_specular", "rr_uniform", "next_medium"):
        assert torch.equal(getattr(res, f), getattr(plain_k, f)), f
    assert int((rgid < 0).sum()) > 0

    r = np.random.default_rng(11)
    cots = [torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32)).cuda()
            for _ in range(4)]
    bargs = (*args, rgid, rnee, *cots, 4321)
    before = bounce_grad.launches
    got = bounce_grad.bounce_bwd_cuda(*bargs, nee=nee)
    assert bounce_grad.launches == before + 1
    want = bounce_grad.bounce_bwd_plain(*bargs, nee=nee)
    ref = bounce_grad.bounce_bwd_plain(*bargs, nee=nee, dtype=torch.float64)
    torch.cuda.synchronize()
    for g, w in zip(got[:4], want[:4]):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30)
    for g, w in zip(got[4:], ref[4:]):
        assert bool(torch.isfinite(g).all())
        close = torch.isclose(g.double(), w, rtol=1e-5, atol=1e-5).all(-1)
        assert float(close.double().mean()) >= 0.999
    zero = torch.zeros((n, 3), device="cuda")
    zgot = bounce_grad.bounce_bwd_cuda(*args, rgid, rnee, zero, zero, zero, zero, 4321, nee=nee)
    assert not any(bool(z.any()) for z in zgot)


@pytest.mark.parametrize("name", ["cornell", "glossy", "ggx_ward", "milky"])
def test_backward_lane_order_leaves_each_lane(name):
    """Kernel 3 (3s on ggx_ward, 3v on milky) as it runs (3s with its lanes
    grouped by key) and in index order (``ordered=False``) on 50,000 random
    lanes, a third of them with zero cotangents: every lane's d_origin,
    d_direction, d_throughput (and d_medium) bit for bit the same, both
    rows within their bar of the float64 reference."""
    _need_cuda()
    import numpy as np

    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad
    from pathtracer_tpu_torch.render.features import features_for_materials

    scene = _surface_scene(name, (8, 8))
    n = 50_000
    t = _random_lanes_cuda(n, 21)
    centre = CENTRES.get(name, [0.0, 0.0, 0.0])
    origin = (t["origin"] * 0.8 + torch.tensor(centre, device="cuda")).contiguous()
    feats = frozenset(features_for_materials(scene.materials)) & {
        "volumetric", "texture", "bump", "microfacet", "ward"}
    medium = torch.zeros((n, 4), device="cuda")
    r = np.random.default_rng(2)
    if "volumetric" in feats:
        medium = torch.from_numpy(np.abs(r.standard_normal((n, 4))).astype(np.float32)).cuda()
        medium = medium * torch.from_numpy(r.random((n, 1)) < 0.6).cuda()
    args = (pack_tables(scene), origin, t["direction"], t["throughput"], t["sample"].long(),
            t["depth"], t["prev"])
    _, rgid, rnee = bounce_fused.bounce_fused_cuda(*args, medium, 4321, nee=True, features=feats,
                                                   emit_replay=True)
    dead = torch.from_numpy(np.arange(n) % 3 == 0).cuda()[:, None]
    cots = [torch.where(dead, 0.0, torch.from_numpy(r.standard_normal((n, 3)).astype(
        np.float32)).cuda()) for _ in range(4)]
    kw = dict(nee=True, features=feats)
    if "volumetric" in feats:
        g_med = torch.from_numpy(r.standard_normal((n, 4)).astype(np.float32)).cuda()
        kw.update(medium=medium, g_medium=torch.where(dead, 0.0, g_med))
    bargs = (*args, rgid, rnee, *cots, 4321)
    ordered = bounce_grad.bounce_bwd_cuda(*bargs, **kw)
    index = bounce_grad.bounce_bwd_cuda(*bargs, ordered=False, **kw)
    ref = bounce_grad.bounce_bwd_plain(*bargs, dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    for a, b in zip(ordered[4:], index[4:]):
        assert torch.equal(a, b)
    _assert_rows_near(ordered, ref)
    _assert_rows_near(index, ref)


def _assert_rows_near(got, ref):
    """Each table cotangent within 1e-4 of itself plus 1e-6 of its table's
    largest (``chip_smoke.hold_adjoint``'s bar): the kernels add a block's
    lanes in no fixed order and the blocks' rows in another tree than
    float64 autograd."""
    for g, r in zip(got[:4], ref[:4]):
        assert bool(torch.isfinite(g).all())
        bar = 1e-4 * r.abs() + 1e-6 * float(r.abs().max())
        assert bool(((g.double() - r).abs() <= bar).all())


@pytest.mark.parametrize("n", [0, 1, 127, 129, 640_000])
def test_backward_row_sums_at_any_width(n):
    """Kernel 3's and kernel 5's table rows (``bounce_adj.cuh:row_sum``: one
    pass up to 64 partial rows, two above) against their float64
    references on n random lanes of Cornell, from none to 640,000 (one
    block, and one partial row, per 128 lanes: 5,000 at 640,000); no lanes
    give a zero row."""
    _need_cuda()
    import numpy as np

    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad, trace_grad

    tables = pack_tables(_scene("cornell", (8, 8)))
    t = _random_lanes_cuda(n, 17)
    medium = torch.zeros((n, 4), device="cuda")
    args = (tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(),
            t["depth"], t["prev"])
    _, rgid, rnee = bounce_fused.bounce_fused_cuda(*args, medium, 99, nee=True, emit_replay=True)
    r = np.random.default_rng(5)
    cots = [torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32)).cuda()
            for _ in range(4)]
    bargs = (*args, rgid, rnee, *cots, 99)
    got3 = bounce_grad.bounce_bwd_cuda(*bargs, nee=True)
    kw = dict(max_depth=4, nee=True, rr=False, rr_start=3)
    sample = t["sample"].long()
    _, _, resid = trace_grad.tfwd_cuda(*tables, 99, t["origin"], t["direction"], sample, **kw)
    g_rad = cots[0]
    got5 = trace_grad.tbwd_cuda(*tables, 99, sample, resid, g_rad, **kw)
    torch.cuda.synchronize()
    if n == 0:
        assert not any(bool(g.any()) for g in got3[:4] + got5[:4])
        return
    _assert_rows_near(got3, bounce_grad.bounce_bwd_plain(*bargs, nee=True, dtype=torch.float64))
    _assert_rows_near(got5, trace_grad.tbwd_plain(*tables, 99, sample, resid, g_rad,
                                                  dtype=torch.float64, **kw))


def test_backward_row_with_every_lane_on_one_geom():
    """640,000 lanes aimed within 1e-3 of the point that Cornell's centre
    pixel hits: every lane hits that geom, so every lane adds to the same
    table entries (the worst contention for the atomics into each block's
    row).  The row within its bar of the float64 reference, the lanes at
    1e-5 on 99.9%."""
    _need_cuda()
    import numpy as np

    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad, intersect_cuda
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.scene.structs import Rays

    scene = _scene("cornell", (8, 8))
    tables = pack_tables(scene)
    n = 640_000
    centre = torch.tensor([36], device="cuda")
    ray = generate_camera_rays(scene.camera, centre, camera_uniforms(7, centre))
    t_c, g_c = intersect_cuda.winner_t_gid_cuda(ray, tables[0])
    r = np.random.default_rng(23)
    aim = ray.origin[0] + t_c[0] * ray.direction[0]
    to = aim + torch.from_numpy(r.uniform(-1e-3, 1e-3, (n, 3)).astype(np.float32)).cuda() \
        - ray.origin[0]
    rays = Rays(ray.origin.expand(n, 3).contiguous(), to / to.norm(dim=-1, keepdim=True))
    medium = torch.zeros((n, 4), device="cuda")
    sample = torch.arange(n, device="cuda")
    args = (tables, rays.origin, rays.direction, torch.ones((n, 3), device="cuda"), sample,
            torch.zeros(n, dtype=torch.int32, device="cuda"), torch.zeros(n, device="cuda"))
    _, rgid, rnee = bounce_fused.bounce_fused_cuda(*args, medium, 7, nee=True, emit_replay=True)
    assert bool((rgid == g_c[0].float()).all())
    cots = [torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32)).cuda()
            for _ in range(4)]
    bargs = (*args, rgid, rnee, *cots, 7)
    got = bounce_grad.bounce_bwd_cuda(*bargs, nee=True)
    ref = bounce_grad.bounce_bwd_plain(*bargs, nee=True, dtype=torch.float64)
    torch.cuda.synchronize()
    _assert_rows_near(got, ref)
    for g, w in zip(got[4:], ref[4:]):
        close = torch.isclose(g.double(), w, rtol=1e-5, atol=1e-5).all(-1)
        assert float(close.double().mean()) >= 0.999


def test_full_depth_backward_row_with_every_lane_on_one_geom():
    """Kernel 5's worst contention: 640,000 lanes aimed within 1e-3 of the
    point that Cornell's centre pixel hits, all first hits on that geom, run
    through the full-depth forward and reverse at depth 8 with NEE, so that
    every lane adds to the same table entries at its first bounce and to the
    light's columns at each of its NEE bounces.  The row within its bar of
    the float64 reference, the lanes at 1e-5 on 99.9%."""
    _need_cuda()
    import numpy as np

    from pathtracer_tpu_torch.ops import intersect_cuda, trace_grad
    from pathtracer_tpu_torch.scene.structs import Rays

    scene = _scene("cornell", (8, 8))
    tables = pack_tables(scene)
    n = 640_000
    centre = torch.tensor([36], device="cuda")
    ray = generate_camera_rays(scene.camera, centre, camera_uniforms(7, centre))
    t_c, g_c = intersect_cuda.winner_t_gid_cuda(ray, tables[0])
    r = np.random.default_rng(29)
    aim = ray.origin[0] + t_c[0] * ray.direction[0]
    to = aim + torch.from_numpy(r.uniform(-1e-3, 1e-3, (n, 3)).astype(np.float32)).cuda() \
        - ray.origin[0]
    rays = Rays(ray.origin.expand(n, 3).contiguous(), to / to.norm(dim=-1, keepdim=True))
    _, g_all = intersect_cuda.winner_t_gid_cuda(rays, tables[0])
    assert bool((g_all == g_c[0]).all())
    sample = torch.arange(n, device="cuda")
    kw = dict(max_depth=8, nee=True, rr=False, rr_start=3)
    _, _, resid = trace_grad.tfwd_cuda(*tables, 7, rays.origin, rays.direction, sample, **kw)
    g_rad = torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32)).cuda()
    got = trace_grad.tbwd_cuda(*tables, 7, sample, resid, g_rad, **kw)
    ref = trace_grad.tbwd_plain(*tables, 7, sample, resid, g_rad, dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    _assert_rows_near(got, ref)
    for g, w in zip(got[4:], ref[4:]):
        close = torch.isclose(g.double(), w, rtol=1e-5, atol=1e-5).all(-1)
        assert float(close.double().mean()) >= 0.999


@pytest.mark.parametrize("name", ["cornell", "glossy"])
def test_winner_kernel_matches_plain(name):
    _need_cuda()
    from pathtracer_tpu_torch.ops import intersect_cuda
    from pathtracer_tpu_torch.ops.intersect import winner_t_gid_plain
    from pathtracer_tpu_torch.scene.structs import Rays

    gtab = pack_tables(_scene(name, (8, 8)))[0]
    t = _random_lanes_cuda(50_000, 12)
    rays = Rays(t["origin"], t["direction"])
    before = intersect_cuda.winner_launches
    got_t, got_gid = intersect_cuda.winner_t_gid(rays, gtab)
    assert intersect_cuda.winner_launches == before + 1
    want_t, want_gid = winner_t_gid_plain(rays, gtab)
    torch.cuda.synchronize()
    assert torch.equal(got_t, want_t) and torch.equal(got_gid, want_gid)


@pytest.mark.parametrize("engine", [dict(grad_full_trace=False), dict(grad_fused=False)],
                         ids=["perbounce", "lean"])
def test_grad_engines_launch_their_kernels(engine):
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad, intersect_cuda, trace_grad
    from pathtracer_tpu_torch.ops.rng import prng_key
    from pathtracer_tpu_torch.render import diff

    desc = dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", "cornell.txt")),
                               resolution=(64, 48))
    params, static = diff.params_from_description(desc, 0, device="cuda")
    target = torch.zeros((64 * 48, 3), device="cuda")
    cfg = RenderConfig(max_depth=5)

    def counts():
        return (trace.launches, trace_grad.fwd_launches, trace_grad.bwd_launches,
                bounce_fused.launches, bounce_fused.replay_launches, bounce_grad.launches,
                intersect_cuda.winner_launches, intersect_cuda.occlusion_launches,
                intersect_cuda.nearest_launches)

    full_loss, full, _ = diff.loss_and_grad_rays(params, static, target, 3, prng_key(0), cfg)
    before = counts()
    loss, grads, _ = diff.loss_and_grad_rays(params, static, target, 3, prng_key(0),
                                             dataclasses.replace(cfg, **engine))
    torch.cuda.synchronize()
    d = [a - b for a, b in zip(counts(), before)]
    if "grad_full_trace" in engine:  # 3 spp x 5 bounces of kernels 2-replay and 3
        assert d == [0, 0, 0, 0, 15, 15, 0, 0, 0], d
    else:  # kernel 4 forward; the backward's winner search once per bounce, its NEE
        # bits replayed (no shadow ray)
        assert d == [0, 3, 0, 0, 0, 0, 15, 0, 0], d
    assert abs(float(loss) - float(full_loss)) <= 1e-5 * abs(float(full_loss))
    fl, gl = full.leaves(), grads.leaves()
    gscale = max(float(v.abs().max()) for v in fl.values())
    for k, v in gl.items():
        assert bool(torch.isfinite(v).all()), k
        assert float((v - fl[k]).abs().max()) <= 5e-4 * max(gscale, 1.0), k


def test_grad_engine_wrappers_check_inputs():
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_grad, intersect_cuda
    from pathtracer_tpu_torch.scene.structs import Rays

    tables = pack_tables(_scene("mini", (8, 8)))
    o, d = torch.zeros((4, 3), device="cuda"), torch.ones((4, 3), device="cuda")
    thr, s = torch.ones((4, 3), device="cuda"), torch.arange(4, device="cuda")
    prev, gid, bit = (torch.zeros(4, device="cuda") for _ in range(3))
    g = torch.zeros((4, 3), device="cuda")
    args = (tables, o, d, thr, s, 0, prev, gid, bit)
    with pytest.raises(ValueError):
        bounce_grad.bounce_bwd_cuda(*args[:7], gid[:3], bit, g, g, g, g, 1, nee=True)
    with pytest.raises(TypeError):
        bounce_grad.bounce_bwd_cuda(*args, g.double(), g, g, g, 1, nee=True)
    with pytest.raises(ValueError):
        bounce_grad.bounce_bwd_cuda(*args, g, g.cpu(), g, g, 1, nee=True)
    with pytest.raises(TypeError):
        intersect_cuda.winner_t_gid_cuda(Rays(o.double(), d), tables[0])
    with pytest.raises(ValueError):
        intersect_cuda.winner_t_gid_cuda(Rays(o, d), tables[0].repeat(200, 1))


# ---- differentiable participating media: kernels 4v, 5v, 2r-v and 3v.
# Bars: 4v's radiance equal to kernel 1's volumetric instance and its 17
# residual planes equal to tfwd_plain's; 2r-v equal to plain in every
# output; 5v and 3v against the float64 references, every component within
# rtol = atol = 1e-5 on at least 99.9% of lanes (the vacuum kernels' bar
# here; chip_smoke.py's [grad:vol] holds 99.99% on milky's 640,000 lanes),
# every table cotangent within 1e-4 of itself plus 1e-6 of its table's
# largest.  Each lane beyond the bar is printed with its component, its
# errors and, for 5v, the path it took (ops/trace_grad.lane_events).


def _vol_table_bars(got, ref):
    for g, w in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        assert bool(((g.double() - w).abs() <= 1e-4 * w.abs() + 1e-6 * float(w.abs().max())).all())


def _vol_lane_bars(got, ref, names, f32=None, path=None):
    for name, g, w, p in zip(names, got, ref, f32 or [None] * len(names)):
        assert bool(torch.isfinite(g).all())
        close = torch.isclose(g.double(), w, rtol=1e-5, atol=1e-5).all(-1)
        for i in (~close).nonzero()[:, 0].tolist()[:8]:
            c = int((g[i].double() - w[i]).abs().argmax())
            k, r = float(g[i, c]), float(w[i, c])
            plain = "" if p is None else (
                f", |float32 plain - float64| {abs(float(p[i, c]) - r):.3g}")
            print(f"{name}[{c}] lane {i}: kernel {k:.9g}, float64 {r:.9g}, |kernel - float64| "
                  f"{abs(k - r):.3g}{plain}, largest |component| {float(w[i].abs().max()):.4g}"
                  + ("" if path is None else f"; path {path(i)}"))
        assert float(close.double().mean()) >= 0.999, name


@pytest.mark.parametrize("name,vol_nee", [("milky", True), ("milky", False), ("fog", True)])
def test_trace_grad_vol_kernels_match_plain(name, vol_nee):
    _need_cuda()
    import numpy as np

    from pathtracer_tpu_torch.ops import trace_grad

    tables, seed, rays, sample = _grad_inputs(name, (96, 96))
    n = 96 * 96
    kw = dict(max_depth=6, nee=True, rr=False, rr_start=3, vol_nee=vol_nee)
    feats = frozenset({"volumetric"})
    args = (*tables, seed, rays.origin, rays.direction, sample)
    before = (trace_grad.fwd_launches, trace_grad.fwd_vol_launches)
    rad_k, nr_k, res_k = trace_grad.tfwd_cuda(*args, features=feats, **kw)
    assert (trace_grad.fwd_launches, trace_grad.fwd_vol_launches) == (before[0], before[1] + 1)
    rad_t, nr_t = trace.trace_cuda(*args, features=feats, **kw)
    rad_p, nr_p, res_p = trace_grad.tfwd_plain(*args, features=feats, **kw)
    torch.cuda.synchronize()
    assert torch.equal(rad_k, rad_t) and int(nr_k) == int(nr_t) == int(nr_p)
    assert torch.equal(res_k, res_p)
    g_rad = torch.from_numpy(
        np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)).cuda()
    before = (trace_grad.bwd_launches, trace_grad.bwd_vol_launches)
    got = trace_grad.tbwd_cuda(*tables, seed, sample, res_k, g_rad, features=feats, **kw)
    assert (trace_grad.bwd_launches, trace_grad.bwd_vol_launches) == (before[0], before[1] + 1)
    ref = trace_grad.tbwd_plain(*tables, seed, sample, res_k, g_rad, features=feats,
                                dtype=torch.float64, **kw)
    f32 = trace_grad.tbwd_plain(*tables, seed, sample, res_k, g_rad, features=feats, **kw)
    torch.cuda.synchronize()
    _vol_table_bars(got[:4], ref[:4])
    _vol_lane_bars(got[4:], ref[4:], ("d_origin", "d_direction"), f32[4:], lambda i: (
        trace_grad.lane_events(tables[0], seed, sample, res_k, i, feats)))


@pytest.mark.parametrize("vol_nee", [True, False])
def test_bounce_vol_replay_and_backward_kernels_match_plain(vol_nee):
    _need_cuda()
    import numpy as np

    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad

    tables = pack_tables(_scene("milky", (8, 8)))
    n = 50_000
    t = _random_lanes_cuda(n, 12)
    t["origin"] = t["origin"] + torch.tensor([2.2, 1.6, 1.5], device="cuda")
    r = np.random.default_rng(5)
    on = r.random((n, 1)) < 0.6
    medium = torch.from_numpy(np.concatenate([r.uniform(0, 0.3, (n, 3)), r.uniform(0, 3, (n, 1))],
                                             -1).astype(np.float32) * on).cuda()
    feats = frozenset({"volumetric"})
    args = (tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(),
            t["depth"], t["prev"])
    before = (bounce_fused.replay_launches, bounce_fused.replay_vol_launches)
    res, rgid, rnee = bounce_fused.bounce_fused_cuda(*args, medium, 4321, nee=True,
                                                     features=feats, vol_nee=vol_nee,
                                                     emit_replay=True)
    assert (bounce_fused.replay_launches, bounce_fused.replay_vol_launches) == (
        before[0], before[1] + 1)
    plain, pgid, pnee = bounce_fused.bounce_fused_plain(*args, medium, 4321, nee=True,
                                                        features=feats, vol_nee=vol_nee,
                                                        emit_replay=True)
    torch.cuda.synchronize()
    assert torch.equal(rgid, pgid) and torch.equal(rnee, pnee)
    for f in ("contrib", "next_origin", "next_direction", "throughput_mult", "terminate",
              "was_specular", "rr_uniform", "next_medium"):
        assert torch.equal(getattr(res, f), getattr(plain, f)), f

    cots = [torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32)).cuda()
            for _ in range(4)]
    g_med = torch.from_numpy(r.standard_normal((n, 4)).astype(np.float32)).cuda()
    bargs = (*args, rgid, rnee, *cots, 4321)
    bkw = dict(nee=True, features=feats, medium=medium, g_medium=g_med, vol_nee=vol_nee)
    before = (bounce_grad.launches, bounce_grad.vol_launches)
    got = bounce_grad.bounce_bwd_cuda(*bargs, **bkw)
    assert (bounce_grad.launches, bounce_grad.vol_launches) == (before[0], before[1] + 1)
    ref = bounce_grad.bounce_bwd_plain(*bargs, dtype=torch.float64, **bkw)
    torch.cuda.synchronize()
    _vol_table_bars(got[:4], ref[:4])
    _vol_lane_bars(got[4:], ref[4:], ("d_origin", "d_direction", "d_throughput", "d_medium"))


# engine, launches of 2 spp at depth 5: kernel 1v, 4v, 5v, 2r-v, 3v, 7, 8 (the
# lean engine's forward is 4v, its backward replays the NEE bits: no kernel 8)
VOL_ENGINES = {
    "full-depth": (dict(), [0, 2, 2, 0, 0, 0, 0]),
    "per-bounce": (dict(grad_full_trace=False), [0, 0, 0, 10, 10, 0, 0]),
    "lean": (dict(grad_fused=False), [0, 2, 0, 0, 0, 10, 0]),
}


@pytest.mark.parametrize("name", sorted(VOL_ENGINES))
def test_vol_grad_engines_launch_their_kernels(name):
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad, intersect_cuda, trace_grad
    from pathtracer_tpu_torch.ops.rng import prng_key
    from pathtracer_tpu_torch.render import diff

    desc = dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", "milky.txt")),
                               resolution=(48, 48))
    params, static = diff.params_from_description(desc, 0, device="cuda")
    target = torch.zeros((48 * 48, 3), device="cuda")
    engine, launched = VOL_ENGINES[name]
    cfg = RenderConfig(max_depth=5, **engine)

    def counts():
        return (trace.vol_launches, trace_grad.fwd_vol_launches, trace_grad.bwd_vol_launches,
                bounce_fused.replay_vol_launches, bounce_grad.vol_launches,
                intersect_cuda.winner_launches, intersect_cuda.occlusion_launches)

    before = counts()
    loss, grads, _ = diff.loss_and_grad_rays(params, static, target, 2, prng_key(0), cfg)
    torch.cuda.synchronize()
    d = [a - b for a, b in zip(counts(), before)]
    assert d == launched, d
    cp, _ = diff.params_from_description(desc, 0, device="cpu")
    loss_c, grads_c = diff.loss_and_grad(cp, static, target.cpu(), 2, prng_key(0), cfg,
                                         device="cpu")
    assert abs(float(loss) - float(loss_c)) <= 1e-4 * abs(float(loss_c))
    cl, gl = grads_c.leaves(), grads.leaves()
    gscale = max(float(v.abs().max()) for v in cl.values())
    for k, v in gl.items():
        assert bool(torch.isfinite(v).all()), k
        assert float((v.cpu() - cl[k]).abs().max()) <= 5e-4 * gscale, k
    assert float(grads.materials.absorption_coefficient.abs().max()) > 0


# ---- differentiable surface physics: kernels 4s, 5s, 2r-s and 3s (the
# kSurf instances; kVol x kSurf on surf_vol_mini), at the media cases' bars:
# 4s equal to kernel 1's surface instance and its residuals to tfwd_plain's,
# 2r-s equal to plain in every output, 5s and 3s against the float64
# references (99.9% of lanes here; chip_smoke.py's [grad:surf] holds 99.99%
# on ward's and textured's full width).


def _surf_grad_scene(name, res):
    from tests.test_torch_surface_diff import SURF_VOL_MINI

    if name == "surf_vol_mini":
        desc = parse_scene_text(SURF_VOL_MINI, name=name)
    elif name == "ggx_ward":
        from pathtracer_tpu_torch.scene.variants import ggx_ward_scene

        desc = parse_scene_text(ggx_ward_scene(), name=name)
    else:
        desc = load_scene(os.path.join(ROOT, "scenes", f"{name}.txt"))
    return dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cuda")


@pytest.mark.parametrize("name", ["ward", "textured", "surf_vol_mini"])
def test_trace_grad_surf_kernels_match_plain(name):
    _need_cuda()
    import numpy as np

    from pathtracer_tpu_torch.ops import trace_grad
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render.features import features_for_materials

    scene = _surf_grad_scene(name, (96, 96))
    feats = frozenset(features_for_materials(scene.materials))
    tables = pack_tables(scene)
    seed = key_to_seed(prng_key(0))
    n = 96 * 96
    sample = torch.arange(n, device="cuda") + 2 * n
    rays = generate_camera_rays(scene.camera, sample - 2 * n, camera_uniforms(seed, sample))
    kw = dict(max_depth=6, nee=True, rr=False, rr_start=3, features=feats)
    args = (*tables, seed, rays.origin, rays.direction, sample)
    before = trace_grad.fwd_surf_launches
    rad_k, nr_k, res_k = trace_grad.tfwd_cuda(*args, **kw)
    assert trace_grad.fwd_surf_launches == before + 1
    rad_t, nr_t = trace.trace_cuda(*args, **kw)
    _, nr_p, res_p = trace_grad.tfwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(rad_k, rad_t) and int(nr_k) == int(nr_t) == int(nr_p)
    assert torch.equal(res_k, res_p)
    g_rad = torch.from_numpy(
        np.random.default_rng(4).standard_normal((n, 3)).astype(np.float32)).cuda()
    before = trace_grad.bwd_surf_launches
    got = trace_grad.tbwd_cuda(*tables, seed, sample, res_k, g_rad, **kw)
    assert trace_grad.bwd_surf_launches == before + 1
    ref = trace_grad.tbwd_plain(*tables, seed, sample, res_k, g_rad, dtype=torch.float64, **kw)
    f32 = trace_grad.tbwd_plain(*tables, seed, sample, res_k, g_rad, **kw)
    torch.cuda.synchronize()
    _vol_table_bars(got[:4], ref[:4])
    _vol_lane_bars(got[4:], ref[4:], ("d_origin", "d_direction"), f32[4:], lambda i: (
        trace_grad.lane_events(tables[0], seed, sample, res_k, i, feats)))


@pytest.mark.parametrize("name", ["milky", "fog", "ward", "textured", "surf_vol_mini"])
def test_lane_order_matches_plain(name):
    """The lane order that kernels 5v and 5s run before their body
    (``trace_grad.lane_order_cuda``) on 96x96 lanes' residuals at depth 8:
    its keys equal ``lane_keys_plain``'s, its order is a permutation of the
    lanes, and the keys in that order are the plain keys sorted (within a
    key the order is free)."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import trace_grad
    from pathtracer_tpu_torch.render.features import features_for_materials

    if name in ("milky", "fog"):
        tables, seed, rays, sample = _grad_inputs(name, (96, 96))
        feats = frozenset({"volumetric"})
    else:
        scene = _surf_grad_scene(name, (96, 96))
        feats = frozenset(features_for_materials(scene.materials))
        tables, seed = pack_tables(scene), 11
        sample = torch.arange(96 * 96, device="cuda")
        rays = generate_camera_rays(scene.camera, sample, camera_uniforms(seed, sample))
    kw = dict(max_depth=8, nee=True, rr=False, rr_start=3, features=feats)
    _, _, resid = trace_grad.tfwd_cuda(*tables, seed, rays.origin, rays.direction, sample, **kw)
    keys, order = trace_grad.lane_order_cuda(tables[0], tables[1], resid, feats, 8)
    want = trace_grad.lane_keys_plain(tables[0], tables[1], resid, feats, 8)
    torch.cuda.synchronize()
    assert torch.equal(keys, want)
    assert torch.equal(torch.sort(order.long()).values, torch.arange(96 * 96, device="cuda"))
    assert torch.equal(keys[order.long()], torch.sort(want).values)
    assert (name == "textured") == (int(want.max()) == 0)


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("name", ["ggx_ward", "textured", "surf_vol_mini"])
def test_bounce_surf_replay_and_backward_kernels_match_plain(name, nee):
    _need_cuda()
    import numpy as np

    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad
    from pathtracer_tpu_torch.render.features import features_for_materials

    scene = _surf_grad_scene(name, (8, 8))
    feats = frozenset(features_for_materials(scene.materials))
    vol = "volumetric" in feats
    tables = pack_tables(scene)
    n = 50_000
    t = _random_lanes_cuda(n, 13)
    centre = {"ggx_ward": [0.0, 2.0, 0.0], "textured": [0.0, 4.0, -1.0]}.get(name, [0.0, 3.0, 1.0])
    t["origin"] = t["origin"] * 0.8 + torch.tensor(centre, device="cuda")
    r = np.random.default_rng(6)
    medium = torch.zeros((n, 4), device="cuda")
    if vol:
        on = r.random((n, 1)) < 0.6
        medium = torch.from_numpy(np.concatenate(
            [r.uniform(0, 0.3, (n, 3)), r.uniform(0, 3, (n, 1))], -1).astype(np.float32)
            * on).cuda()
    args = (tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(),
            t["depth"], t["prev"])
    before = bounce_fused.replay_surf_launches
    res, rgid, rnee = bounce_fused.bounce_fused_cuda(*args, medium, 4321, nee=nee,
                                                     features=feats, emit_replay=True)
    assert bounce_fused.replay_surf_launches == before + 1
    plain, pgid, pnee = bounce_fused.bounce_fused_plain(*args, medium, 4321, nee=nee,
                                                        features=feats, emit_replay=True)
    torch.cuda.synchronize()
    assert torch.equal(rgid, pgid) and torch.equal(rnee, pnee)
    for f in ("contrib", "next_origin", "next_direction", "throughput_mult", "terminate",
              "was_specular", "rr_uniform", "next_medium"):
        assert torch.equal(getattr(res, f), getattr(plain, f)), f

    cots = [torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32)).cuda()
            for _ in range(4)]
    bargs = (*args, rgid, rnee, *cots, 4321)
    bkw = dict(nee=nee, features=feats)
    names = ("d_origin", "d_direction", "d_throughput")
    if vol:
        g_med = torch.from_numpy(r.standard_normal((n, 4)).astype(np.float32)).cuda()
        bkw.update(medium=medium, g_medium=g_med)
        names += ("d_medium",)
    before = bounce_grad.surf_launches
    got = bounce_grad.bounce_bwd_cuda(*bargs, **bkw)
    assert bounce_grad.surf_launches == before + 1
    ref = bounce_grad.bounce_bwd_plain(*bargs, dtype=torch.float64, **bkw)
    torch.cuda.synchronize()
    _vol_table_bars(got[:4], ref[:4])
    _vol_lane_bars(got[4:], ref[4:], names)


# engine, launches of 2 spp at depth 5: kernel 1s, 4s, 5s, 2r-s, 3s, 7, 8 (the
# lean engine's forward is 4s, its backward replays the NEE bits: no kernel 8)
SURF_ENGINES = {
    "full-depth": (dict(), [0, 2, 2, 0, 0, 0, 0]),
    "per-bounce": (dict(grad_full_trace=False), [0, 0, 0, 10, 10, 0, 0]),
    "lean": (dict(grad_fused=False), [0, 2, 0, 0, 0, 10, 0]),
}


def _off_bump_grads(params, static, cfg, spp, device):
    """The gradient of the mean squared error (target zeros) over the
    pixels whose paths meet no bumped material in any iteration (the CPU's
    full-depth forward decides), by ``cfg``'s engine on ``device``: on the
    bumped sphere's re-hits the float32 forward's last bits, which the card
    and the CPU round apart, decide the geometry and camera derivatives
    (``tests/test_torch_surface_diff.py::
    test_textured_gradient_against_float64_paths``; ROADMAP queue 3)."""
    from pathtracer_tpu_torch.ops import trace_grad
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.render.features import resolve_features

    cpu, _ = diff.params_from_description(static.desc, 0, device="cpu")
    scene = diff.build_scene(cpu, static.static)
    feats = frozenset(resolve_features(cfg, cpu.materials).features)
    tables = pack_tables(scene)
    bump_geom = tables[1][tables[0][:, 13].long(), 21] > 0
    n, seed = static.n, key_to_seed(prng_key(0))
    pix = torch.arange(n)
    tail = trace_grad.tail_plane(feats)
    bumped = torch.zeros(n, dtype=torch.bool)
    for it in range(spp):
        sample = it * n + pix
        rays = generate_camera_rays(scene.camera, pix, camera_uniforms(seed, sample))
        _, _, res = trace_grad.tfwd_plain(*tables, seed, rays.origin, rays.direction, sample,
                                          max_depth=cfg.max_depth, nee=cfg.nee, rr=False,
                                          rr_start=3, features=feats)
        gid, live = res[:, tail + 2].long(), res[:, tail + 1] > 0.5
        bumped |= (live & (gid >= 0) & bump_geom[gid.clamp(min=0)]).any(0)
    weight = (~bumped).float().to(device)
    names, values = zip(*params.leaves().items())
    leaves = [v.detach().requires_grad_(True) for v in values]
    p = diff.SceneParams.from_leaves(dict(zip(names, leaves)))
    with torch.enable_grad():
        img = diff.render_linear(p, static.static, spp, prng_key(0), cfg)
        loss = torch.mean(weight[:, None] * img ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), {k: (torch.zeros_like(x) if g is None else g).cpu()
                                  for k, g, x in zip(names, grads, leaves)}


@pytest.mark.parametrize("name", ["ward", "textured"])
@pytest.mark.parametrize("engine", sorted(SURF_ENGINES))
def test_surf_grad_engines_launch_their_kernels(engine, name):
    """Each engine's kernels on a 48x48 step; its loss and leaves against
    the CPU's plain versions at the media engines' bars: on textured over
    the pixels whose paths meet no bump (``_off_bump_grads``)."""
    _need_cuda()
    import types

    from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad, intersect_cuda, trace_grad
    from pathtracer_tpu_torch.ops.rng import prng_key
    from pathtracer_tpu_torch.render import diff

    desc = dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", f"{name}.txt")),
                               resolution=(48, 48))
    params, static = diff.params_from_description(desc, 0, device="cuda")
    target = torch.zeros((48 * 48, 3), device="cuda")
    cfg_kw, launched = SURF_ENGINES[engine]
    cfg = RenderConfig(max_depth=5, **cfg_kw)

    def counts():
        return (trace.surf_launches, trace_grad.fwd_surf_launches, trace_grad.bwd_surf_launches,
                bounce_fused.replay_surf_launches, bounce_grad.surf_launches,
                intersect_cuda.winner_launches, intersect_cuda.occlusion_launches)

    before = counts()
    loss, grads, _ = diff.loss_and_grad_rays(params, static, target, 2, prng_key(0), cfg)
    torch.cuda.synchronize()
    d = [a - b for a, b in zip(counts(), before)]
    assert d == launched, d
    assert all(bool(torch.isfinite(v).all()) for v in grads.leaves().values())
    cp, _ = diff.params_from_description(desc, 0, device="cpu")
    if name == "textured":
        st = types.SimpleNamespace(desc=desc, static=static, n=48 * 48)
        loss, gl = _off_bump_grads(params, st, cfg, 2, "cuda")
        loss_c, cl = _off_bump_grads(cp, st, cfg, 2, "cpu")
    else:
        loss_c, grads_c = diff.loss_and_grad(cp, static, target.cpu(), 2, prng_key(0), cfg,
                                             device="cpu")
        cl, gl = grads_c.leaves(), {k: v.cpu() for k, v in grads.leaves().items()}
    assert abs(float(loss) - float(loss_c)) <= 1e-4 * abs(float(loss_c))
    gscale = max(float(v.abs().max()) for v in cl.values())
    for k, v in gl.items():
        assert float((v - cl[k]).abs().max()) <= 5e-4 * gscale, k


def test_image_texture_grad_takes_the_lean_engine():
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused, intersect_cuda
    from pathtracer_tpu_torch.ops.rng import prng_key
    from pathtracer_tpu_torch.render import diff

    desc = dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", "textured_image.txt")),
                               resolution=(48, 48))
    params, static = diff.params_from_description(desc, 0, device="cuda")
    target = torch.zeros((48 * 48, 3), device="cuda")
    before = (bounce_fused.tex_launches, intersect_cuda.winner_launches)
    _, grads, _ = diff.loss_and_grad_rays(params, static, target, 2, prng_key(0),
                                          RenderConfig(max_depth=5))
    torch.cuda.synchronize()
    assert (bounce_fused.tex_launches - before[0], intersect_cuda.winner_launches - before[1]) == (
        10, 10)
    g = grads.textures.data
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    cp, _ = diff.params_from_description(desc, 0, device="cpu")
    _, grads_c = diff.loss_and_grad(cp, static, target.cpu(), 2, prng_key(0),
                                    RenderConfig(max_depth=5), device="cpu")
    gscale = max(float(v.abs().max()) for v in grads_c.leaves().values())
    for k, v in grads.leaves().items():
        assert float((v.cpu() - grads_c.leaves()[k]).abs().max()) <= 5e-4 * gscale, k


# ---- triangle meshes: kernels 9 and 10, kernels 1 and 2 with the in-kernel
# sweep.  Bars: kernels 9 and 10 equal their plain versions on every lane (t,
# index, miss pattern); kernel 1 with meshes equal ray counts and radiance
# within 2e-6 on at least 99.9% of lanes; kernel 2 with meshes the module's
# bounce bars; a mesh render launches kernel 1 once per iteration, and the
# split route kernels 6, 8, 9 and 10 once per bounce.


def _object_rays_cuda(n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    o = unit(rng.standard_normal((n, 3))) * 1.5
    d = unit(rng.standard_normal((n, 3)) * 0.4 - o)
    return (torch.from_numpy(o.astype(np.float32)).cuda(),
            torch.from_numpy(d.astype(np.float32)).cuda())


@pytest.mark.parametrize("name", ["smooth_mesh", "displace_demo", "adversarial"])
def test_mesh_kernels_match_plain(name):
    """Kernels 9 and 10, culled (the mesh's padded chunk boxes) and dense
    (no boxes), equal to their plain versions on every lane; culled equal
    to dense on every lane, except on ``tests/test_torch_kernel_host.
    adversarial_mesh_rays`` where the dense winner's conditioning is below
    1e-4 (printed)."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import mesh
    from tests.test_torch_kernel_host import adversarial_mesh_rays, mt_conditioning

    m = _scene("smooth_mesh" if name == "adversarial" else name, (8, 8)).meshes[0]
    table, boxes = m.scan_table, m.scan_boxes
    if name == "adversarial":
        cpu = load_scene(os.path.join(ROOT, "scenes", "smooth_mesh.txt")).scene_for_frame(
            0, device="cpu").meshes[0]
        o, d = (torch.from_numpy(a).cuda() for a in adversarial_mesh_rays(cpu))
    else:
        o, d = _object_rays_cuda(100_000, 3)
    got = {}
    for label, bx in (("culled", boxes), ("dense", None)):
        before = (mesh.nearest_launches, mesh.min_launches, mesh.dense_launches)
        t, idx = mesh.mesh_nearest(table, bx, o, d)
        occ = mesh.mesh_min(table, bx, o, d)
        after = (mesh.nearest_launches, mesh.min_launches, mesh.dense_launches)
        assert [a - b for a, b in zip(after, before)] == ([1, 1, 0] if bx is not None
                                                         else [0, 0, 2]), label
        want_t, want_i = mesh.mesh_nearest_plain(table, bx, o, d)
        want_occ = mesh.mesh_min_plain(table, bx, o, d)
        torch.cuda.synchronize()
        assert 0.2 < float((want_t < mesh.BIG).float().mean()) < 0.95
        assert torch.equal(t, want_t) and torch.equal(idx, want_i), label
        assert torch.equal(occ, want_occ), label
        got[label] = (t, idx)
    differ = (got["culled"][0] != got["dense"][0]) | (got["culled"][1] != got["dense"][1])
    cond = mt_conditioning(table, o, d, got["dense"][1])
    print(f"{name}: culled differs from dense on {int(differ.sum())} of {o.shape[0]} lanes, "
          f"conditioning {cond[differ].tolist()[:16]}")
    allowed = (cond < 1e-4) if name == "adversarial" else torch.zeros_like(differ)
    assert not bool((differ & ~allowed).any())


@pytest.mark.parametrize("kw", [dict(max_depth=8, nee=True),
                                dict(max_depth=5, nee=False, russian_roulette=True, rr_start=1)])
def test_trace_kernel_with_meshes_matches_plain(kw):
    _need_cuda()
    scene = _scene("smooth_mesh", (128, 96))
    cfg = RenderConfig(**kw)
    n = 128 * 96
    pixel = torch.arange(n, device="cuda")
    sample = 3 * n + pixel
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(77, sample))
    args = (*pack_tables(scene), 77, rays.origin, rays.direction, sample)
    opts = dict(max_depth=cfg.max_depth, nee=cfg.nee, rr=cfg.russian_roulette,
                rr_start=cfg.rr_start, mesh=scene.mesh_tables)
    before = (trace.launches, trace.mesh_launches)
    rad_k, rays_k = trace.trace_cuda(*args, **opts)
    assert (trace.launches, trace.mesh_launches) == (before[0], before[1] + 1)
    rad_p, rays_p = trace.trace_plain(*args, **opts)
    torch.cuda.synchronize()
    assert int(rays_k) == int(rays_p)
    close = torch.isclose(rad_k, rad_p, rtol=2e-6, atol=2e-6).all(-1)
    assert float(close.float().mean()) >= 0.999


@pytest.mark.parametrize("nee", [True, False])
def test_bounce_kernel_with_meshes_matches_plain(nee):
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused

    scene = _scene("smooth_mesh", (8, 8))
    n = 50_000
    t = _random_lanes_cuda(n, 8)
    t["origin"] = t["origin"] * 0.7 + torch.tensor([0.0, 1.8, 0.0], device="cuda")
    medium = torch.zeros((n, 4), device="cuda")
    args = (pack_tables(scene), t["origin"], t["direction"], t["throughput"], t["sample"].long(),
            t["depth"], t["prev"], medium, 4321)
    before = (bounce_fused.launches, bounce_fused.mesh_launches)
    got = bounce_fused.bounce_fused_cuda(*args, nee=nee, mesh=scene.mesh_tables)
    assert (bounce_fused.launches, bounce_fused.mesh_launches) == (before[0], before[1] + 1)
    want = bounce_fused.bounce_fused_plain(*args, nee=nee, mesh=scene.mesh_tables)
    torch.cuda.synchronize()
    assert torch.equal(got.terminate, want.terminate)
    assert torch.equal(got.was_specular, want.was_specular)
    assert torch.equal(got.rr_uniform, want.rr_uniform)
    close = torch.ones(n, dtype=torch.bool, device="cuda")
    for f in ("contrib", "next_origin", "next_direction", "throughput_mult"):
        close &= torch.isclose(getattr(got, f), getattr(want, f), rtol=2e-6, atol=2e-6).all(-1)
    assert float(close.float().mean()) >= 0.999


def test_mesh_render_launches_its_kernels():
    _need_cuda()
    from pathtracer_tpu_torch.ops import intersect_cuda, mesh

    scene = _scene("smooth_mesh", (64, 48))
    counts = lambda: (trace.mesh_launches, intersect_cuda.nearest_launches,  # noqa: E731
                      intersect_cuda.occlusion_launches, mesh.nearest_launches,
                      mesh.min_launches)
    before = counts()
    _, mega, ms = render(scene, 2, RenderConfig(max_depth=4), device="cuda")
    assert [a - b for a, b in zip(counts(), before)] == [2, 0, 0, 0, 0]
    before = counts()
    _, split, ss = render(scene, 2, RenderConfig(max_depth=4, fused=False), device="cuda")
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [0, 8, 8, 8, 8]
    assert ss["rays_traced"] == ms["rays_traced"]
    close = torch.isclose(split, mega, rtol=2e-4, atol=2e-4)
    assert float(close.float().mean()) >= 0.995


# ---- participating media: kernel 1's and kernel 2's kVol / kHg instances,
# and kernel 1m's triangle split (chip_smoke.py [vol] holds them at full
# width).  Bit for bit: kernel and plain version run the same functions on
# the card.


def _media_scene(name, res):
    from pathtracer_tpu_torch.scene.variants import fog_mesh_scene

    if name.startswith("fog_mesh"):
        desc = parse_scene_text(fog_mesh_scene(name.endswith("glass")), name=name,
                                scene_dir=os.path.join(ROOT, "scenes"))
        return dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cuda")
    return _scene(name, res)


@pytest.mark.parametrize("name", ["sss", "fog", "glass_dof", "milky", "fog_mesh_glass",
                                  "fog_mesh_opaque"])
def test_trace_media_kernel_matches_plain(name):
    _need_cuda()
    from pathtracer_tpu_torch.render.features import features_for_materials

    scene = _media_scene(name, (96, 96))
    feats = frozenset(features_for_materials(scene.materials))
    assert "volumetric" in feats
    n = 96 * 96
    pixel = torch.arange(n, device="cuda")
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(99, pixel))
    args = (*pack_tables(scene), 99, rays.origin, rays.direction, pixel)
    opts = dict(max_depth=8, nee=True, rr=False, rr_start=3, mesh=scene.mesh_tables,
                features=feats)
    before = (trace.vol_launches, trace.hg_launches, trace.mesh_vol_launches)
    rad_k, rays_k = trace.trace_cuda(*args, **opts)
    after = (trace.vol_launches, trace.hg_launches, trace.mesh_vol_launches)
    want = 2 if scene.meshes else (1 if "hg" in feats else 0)
    assert [a - b for a, b in zip(after, before)] == [int(i == want) for i in range(3)]
    rad_p, rays_p = trace.trace_plain(*args, **opts)
    torch.cuda.synchronize()
    assert int(rays_k) == int(rays_p)
    assert torch.equal(rad_k, rad_p) and float(rad_p.sum()) > 0


@pytest.mark.parametrize("hg", [False, True])
@pytest.mark.parametrize("nee", [True, False])
def test_bounce_media_kernel_matches_plain(hg, nee):
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused

    tables = pack_tables(_scene("sss", (8, 8)))
    n = 50_000
    t = _random_lanes_cuda(n, 12)
    t["origin"] = t["origin"] * 0.5 + torch.tensor([0.0, 1.2, 0.0], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    width = 5 if hg else 4
    medium = torch.rand((n, width), device="cuda", generator=gen) * torch.tensor(
        [0.3, 0.3, 0.3, 3.0, 1.8][:width], device="cuda")
    if hg:
        medium[:, 4] -= 0.9
    medium = medium * (torch.rand((n, 1), device="cuda", generator=gen) < 0.6)
    feats = frozenset({"volumetric", "hg"} if hg else {"volumetric"})
    args = (tables, t["origin"].contiguous(), t["direction"], t["throughput"], t["sample"].long(),
            t["depth"], t["prev"], medium.contiguous(), 4321)
    counter = "hg_launches" if hg else "vol_launches"
    before = getattr(bounce_fused, counter)
    got = bounce_fused.bounce_fused_cuda(*args, nee=nee, features=feats)
    assert getattr(bounce_fused, counter) == before + 1
    want = bounce_fused.bounce_fused_plain(*args, nee=nee, features=feats)
    torch.cuda.synchronize()
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    assert int((want.next_medium != medium).any(-1).sum()) > 100


# ---- optional surface physics: kernel 1's and kernel 2's kSurf instances
# and kernel 2's deferred-texel variant (chip_smoke.py [surf] holds them at
# full width).  Bit for bit: kernel and plain version run the same functions
# on the card (sinf of the bump's large phases included).


def _surface_scene(name, res):
    from pathtracer_tpu_torch.scene.variants import ggx_ward_scene, striped_scene

    scenes = os.path.join(ROOT, "scenes")
    if name == "ggx_ward":
        desc = parse_scene_text(ggx_ward_scene(), name=name)
    elif name == "striped":
        desc = parse_scene_text(striped_scene(), name=name, scene_dir=scenes)
    else:
        return _scene(name, res)
    return dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cuda")


@pytest.mark.parametrize("name", ["ward", "ggx_ward", "striped"])
def test_trace_surface_kernel_matches_plain(name):
    _need_cuda()
    from pathtracer_tpu_torch.render.features import features_for_materials

    scene = _surface_scene(name, (96, 96))
    feats = frozenset(features_for_materials(scene.materials))
    assert trace.surface_bits(feats)
    n = 96 * 96
    pixel = torch.arange(n, device="cuda")
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(99, pixel))
    args = (*pack_tables(scene), 99, rays.origin, rays.direction, pixel)
    opts = dict(max_depth=8, nee=True, rr=False, rr_start=3, features=feats)
    before = (trace.launches, trace.surf_launches)
    rad_k, rays_k = trace.trace_cuda(*args, **opts)
    assert (trace.launches, trace.surf_launches) == (before[0], before[1] + 1)
    rad_p, rays_p = trace.trace_plain(*args, **opts)
    torch.cuda.synchronize()
    assert int(rays_k) == int(rays_p)
    assert torch.equal(rad_k, rad_p) and float(rad_p.sum()) > 0


CENTRES = {"ggx_ward": (0.0, 2.0, 0.0), "striped": (0.0, 4.0, -1.0),
           "textured_image": (0.0, 2.0, 0.0)}


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("name", ["ggx_ward", "striped", "textured_image"])
def test_bounce_surface_kernel_matches_plain(name, nee):
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused
    from pathtracer_tpu_torch.render.features import features_for_materials

    scene = _surface_scene(name, (8, 8))
    feats = frozenset(features_for_materials(scene.materials))
    tex = scene.textures is not None
    n = 50_000
    t = _random_lanes_cuda(n, 13)
    t["origin"] = (t["origin"] * 0.8 + torch.tensor(CENTRES[name], device="cuda")).contiguous()
    args = (pack_tables(scene), t["origin"], t["direction"], t["throughput"], t["sample"].long(),
            t["depth"], t["prev"], torch.zeros((n, 4), device="cuda"), 4321)
    counter = "tex_launches" if tex else "surf_launches"
    before = getattr(bounce_fused, counter)
    got = bounce_fused.bounce_fused_cuda(*args, nee=nee, features=feats, tex_defer=tex)
    assert getattr(bounce_fused, counter) == before + 1
    want = bounce_fused.bounce_fused_plain(*args, nee=nee, features=feats, tex_defer=tex)
    torch.cuda.synchronize()
    if tex:
        for k, a, b in zip(("u", "v", "slot"), got[1:], want[1:]):
            assert torch.equal(a, b), k
        assert int((want[3] >= 0).sum()) > 1000
        got, want = got[0], want[0]
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


@pytest.mark.parametrize("name", ["ward", "textured", "textured_image"])
def test_surface_render_launches_its_kernels(name):
    """Through ``render``: the megakernel route runs kernel 1s once per
    iteration (textured_image: the scan, kernel 2t once per bounce), the
    pinned engine kernel 2s (2t) once per super-step, and the two agree."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused
    from pathtracer_tpu_torch.render import wavefront

    scene = _scene(name, (64, 48))
    counts = lambda: (trace.surf_launches, bounce_fused.surf_launches,  # noqa: E731
                      bounce_fused.tex_launches)
    tex = scene.textures is not None
    before = counts()
    _, mega, ms = render(scene, 2, RenderConfig(max_depth=4), device="cuda")
    want = [0, 0, 8] if tex else [2, 0, 0]
    assert [a - b for a, b in zip(counts(), before)] == want
    before = counts()
    wavefront.super_steps = 0
    _, pinned, ps = render(scene, 2, RenderConfig(max_depth=4, wavefront=True), device="cuda")
    torch.cuda.synchronize()
    steps = wavefront.super_steps
    assert [a - b for a, b in zip(counts(), before)] == ([0, 0, steps] if tex else [0, steps, 0])
    assert ps["rays_traced"] == ms["rays_traced"]
    close = torch.isclose(pinned, mega, rtol=2e-4, atol=2e-4)
    assert float(close.float().mean()) >= 0.999


# ---- meshes above the in-kernel cap (kernel 2mm, csrc/bounce_merge.cu) and
# image textures on meshes (kernel 2mt): bit for bit (chip_smoke.py
# [bigmesh] holds them at full width)


def _bigmesh(name, res, tmp_path=None):
    from pathtracer_tpu_torch.scene.variants import bigmesh_scene, grid_obj, textured_mesh_scene

    if name == "big":
        text = bigmesh_scene(4)
    else:
        obj = tmp_path / f"{name}.obj"
        obj.write_text(grid_obj(65 if name == "grid65" else 24))
        text = textured_mesh_scene(str(obj))
    desc = parse_scene_text(text, name=name, scene_dir=os.path.join(ROOT, "scenes"))
    return dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cuda")


def _primary_state(scene):
    n = scene.camera.width * scene.camera.height
    pixel = torch.arange(n, device="cuda")
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(99, pixel))
    return (rays.origin, rays.direction, torch.ones((n, 3), device="cuda"), pixel,
            torch.zeros(n, dtype=torch.int32, device="cuda"), torch.zeros(n, device="cuda"),
            torch.zeros((n, 4), device="cuda"))


def _all_equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if dataclasses.is_dataclass(g):
            for f in dataclasses.fields(g):
                assert torch.equal(getattr(g, f.name), getattr(w, f.name)), f.name
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("name", ["big", "grid65"])
def test_merge_kernel_matches_plain(tmp_path, name, nee):
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused
    from pathtracer_tpu_torch.render.features import features_for_materials

    scene = _bigmesh(name, (128, 128), tmp_path)
    tables = [t.contiguous() for t in pack_tables(scene)]
    state = _primary_state(scene)
    tex = scene.textures is not None
    mesh_in, mesh_uv = bounce_fused.merge_planes(scene, state[0], state[1], tables[0], tex)
    kw = dict(nee=nee, features=frozenset(features_for_materials(scene.materials)) | {"glossy"},
              tex_defer=tex, mesh_in=mesh_in, mesh_uv=mesh_uv)
    before = bounce_fused.merge_launches
    got = bounce_fused.bounce_fused_cuda(tables, *state, 11, **kw)
    assert bounce_fused.merge_launches == before + 1
    want = bounce_fused.bounce_fused_plain(tables, *state, 11, **kw)
    torch.cuda.synchronize()
    _all_equal(got, want)
    assert int((mesh_in[0] < 1e29).sum()) > 100


@pytest.mark.parametrize("nee", [True, False])
def test_mesh_tex_kernel_matches_plain(tmp_path, nee):
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused

    scene = _bigmesh("grid24", (128, 128), tmp_path)
    tables = [t.contiguous() for t in pack_tables(scene)]
    state = _primary_state(scene)
    kw = dict(nee=nee, features=frozenset({"glossy", "texture"}), tex_defer=True,
              mesh=scene.mesh_tables)
    before = bounce_fused.mesh_tex_launches
    got = bounce_fused.bounce_fused_cuda(tables, *state, 13, **kw)
    assert bounce_fused.mesh_tex_launches == before + 1
    want = bounce_fused.bounce_fused_plain(tables, *state, 13, **kw)
    torch.cuda.synchronize()
    _all_equal(got, want)
    assert int((want[3] >= 0).sum()) > 100


def test_big_mesh_renders_launch_their_kernels():
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused, mesh
    from pathtracer_tpu_torch.render import wavefront

    scene = _bigmesh("big", (64, 48))
    counts = lambda: (trace.launches, trace.mesh_launches, bounce_fused.merge_launches,  # noqa
                      mesh.nearest_launches, mesh.min_launches)
    before = counts()
    _, mega, ms = render(scene, 2, RenderConfig(max_depth=4), device="cuda")
    assert [a - b for a, b in zip(counts(), before)] == [0, 0, 8, 8, 8]
    before, steps = counts(), wavefront.super_steps
    _, pinned, ps = render(scene, 2, RenderConfig(max_depth=4, wavefront=True), device="cuda")
    steps = wavefront.super_steps - steps
    assert [a - b for a, b in zip(counts(), before)] == [0, 0, steps, steps, steps]
    _, split, ss = render(scene, 2, RenderConfig(max_depth=4, fused=False), device="cuda")
    torch.cuda.synchronize()
    assert ps["rays_traced"] == ms["rays_traced"] == ss["rays_traced"]
    assert float(torch.isclose(pinned, mega, rtol=2e-4, atol=2e-4).float().mean()) >= 0.999
    assert float(torch.isclose(split, mega, rtol=2e-4, atol=2e-4).float().mean()) >= 0.995


def test_merge_wrapper_checks_its_inputs():
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused

    scene = _bigmesh("big", (16, 16))
    tables = [t.contiguous() for t in pack_tables(scene)]
    state = _primary_state(scene)
    mesh_in, _ = bounce_fused.merge_planes(scene, state[0], state[1], tables[0], False)
    with pytest.raises(ValueError, match="mesh_in"):
        bounce_fused.bounce_fused_cuda(tables, *state, 1, nee=True, mesh_in=mesh_in[:7])
    with pytest.raises(ValueError, match="mesh_in"):
        bounce_fused.bounce_fused_cuda(tables, *state, 1, nee=True, mesh_in=mesh_in.T.clone())
    with pytest.raises(ValueError, match="mesh_uv"):
        bounce_fused.bounce_fused_cuda(tables, *state, 1, nee=True, mesh_in=mesh_in,
                                       mesh_uv=torch.zeros((3, 256), device="cuda"))
    with pytest.raises(ValueError, match="exclude"):
        bounce_fused.bounce_fused_cuda(tables, *state, 1, nee=True, mesh_in=mesh_in,
                                       mesh=_scene("smooth_mesh", (8, 8)).mesh_tables)
    with pytest.raises(ValueError, match="CUDA"):
        bounce_fused.bounce_fused_cuda([t.cpu() for t in tables], *(s.cpu() for s in state), 1,
                                       nee=True, mesh_in=mesh_in.cpu())


# ---- kernel 1's persistent schedule and kernel 4 on the same paths: russian
# roulette on, an odd lane count, and kernel 1's grid forced far below the
# resident one (the launcher's block count; 0 takes the resident count).
# The schedule changes which thread runs a path and when, not what the path
# computes: the forced grid's outputs equal the resident grid's bit for bit,
# both meet the plain version's bars above, and kernel 4's radiance equals
# kernel 1's.

PERSISTENT_CASES = {
    "cornell_rr": ("cornell", dict(max_depth=8, nee=True, rr=True, rr_start=3)),
    "mini_no_nee_rr": ("mini", dict(max_depth=6, nee=False, rr=True, rr_start=1)),
    "milky": ("milky", dict(max_depth=8, nee=True, rr=True, rr_start=2)),
    "ward": ("ward", dict(max_depth=8, nee=True, rr=True, rr_start=3)),
    "sss": ("sss", dict(max_depth=8, nee=True, rr=True, rr_start=3)),
    "smooth_mesh": ("smooth_mesh", dict(max_depth=8, nee=True, rr=True, rr_start=3)),
    "fog": ("fog", dict(max_depth=8, nee=True, rr=True, rr_start=3)),
    "fog_mesh_glass": ("fog_mesh_glass", dict(max_depth=8, nee=True, rr=True, rr_start=3)),
}


@pytest.mark.parametrize("case", sorted(PERSISTENT_CASES))
def test_persistent_trace_kernels_match_plain(case):
    _need_cuda()
    from pathtracer_tpu_torch.ops import trace_grad
    from pathtracer_tpu_torch.render.features import features_for_materials

    name, kw = PERSISTENT_CASES[case]
    res = (97, 61)  # 5,917 lanes: odd
    scene = _media_scene(name, res)
    feats = frozenset(features_for_materials(scene.materials))
    n = res[0] * res[1]
    pixel = torch.arange(n, device="cuda")
    sample = 5 * n + pixel
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(31, sample))
    args = (*pack_tables(scene), 31, rays.origin, rays.direction, sample)
    opts = dict(kw, features=feats)
    rad_p, nr_p = trace.trace_plain(*args, mesh=scene.mesh_tables, **opts)
    runs = [trace.trace_cuda(*args, mesh=scene.mesh_tables, blocks=b, **opts) for b in (0, 3)]
    torch.cuda.synchronize()
    for rad_k, nr_k in runs:
        assert int(nr_k) == int(nr_p)
        close = torch.isclose(rad_k, rad_p, rtol=2e-6, atol=2e-6).all(-1)
        assert float(close.float().mean()) >= 0.999 and float(rad_p.sum()) > 0
    assert torch.equal(runs[0][0], runs[1][0])
    if scene.meshes or "hg" in feats:
        return  # kernel 4 takes neither (the lean engine does)
    # kernel 4 (one path per thread) on the same paths
    _, nr_fp, res_p = trace_grad.tfwd_plain(*args, **opts)
    rad_f, nr_f, res_f = trace_grad.tfwd_cuda(*args, **opts)
    torch.cuda.synchronize()
    assert torch.equal(rad_f, runs[0][0]) and int(nr_f) == int(nr_fp) == int(nr_p)
    close = torch.isclose(res_f, res_p, rtol=2e-6, atol=2e-6).all(1)
    assert float(close.float().mean()) >= 0.999
    tail = res_p.shape[1] - 4  # prev_state, alive, gid, nee_add
    assert float(res_p[-1, tail + 1].mean()) < 1.0  # some paths ended early


def test_debug_scan_launches_kernel_2_per_bounce():
    """``RenderConfig(debug=True)`` on the megakernel engine at 64x64, depth
    6, NEE, 3 spp: the per-bounce scan launches kernel 2 once per bounce and
    kernel 1 never; the histogram starts at every lane of every iteration,
    never rises and counts the rays; the accumulator is ``trace.cu``'s
    render of the same seed within 1e-5 relative on 99.9% of entries; and
    against the CPU's debug render (camera rays from torch ops on two
    devices, apart in the last ulp, then six bounces) the histogram within
    0.1% of the lanes and the accumulator at ``chip_smoke.py``'s bar for the
    card against the CPU: 99.5% of entries within 2e-4, sums within 2e-5
    (measured at 2e-6: 97.2% of lanes)."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused

    scene = _scene("cornell", (64, 64))
    cfg = RenderConfig(max_depth=6, nee=True, debug=True, iters_per_launch=2)
    spp, n = 3, 64 * 64
    k1, k2 = trace.launches, bounce_fused.launches
    _, accum, stats = render(scene, spp, cfg, device="cuda")
    torch.cuda.synchronize()
    assert trace.launches == k1 and bounce_fused.launches - k2 == spp * cfg.max_depth
    hist = stats["alive_per_bounce"]
    assert len(hist) == cfg.max_depth and hist[0] == spp * n
    assert all(a >= b for a, b in zip(hist, hist[1:])) and hist[-1] < hist[0]
    assert sum(hist) * 2 == stats["rays_traced"]
    cpu = dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", "cornell.txt")),
                              resolution=(64, 64)).scene_for_frame(0, device="cpu")
    _, want, cpu_stats = render(cpu, spp, cfg, device="cpu")
    assert all(abs(a - b) <= spp * n // 1000 for a, b in zip(cpu_stats["alive_per_bounce"], hist))
    close = torch.isclose(accum.cpu(), want, rtol=2e-4, atol=2e-4)
    assert float(close.float().mean()) >= 0.995
    assert abs(float(accum.double().sum()) - float(want.double().sum())) <= 2e-5 * float(
        want.double().sum())
    _, fused, fused_stats = render(scene, spp, dataclasses.replace(cfg, debug=False),
                                   device="cuda")
    assert trace.launches - k1 == spp and fused_stats["rays_traced"] == stats["rays_traced"]
    near = (accum - fused).abs() <= 1e-5 * (fused.abs() + 1e-3)
    assert float(near.float().mean()) >= 0.999


def test_sharded_render_on_two_shards_of_one_card():
    """``parallel/sharded.render_sharded`` on 2 shards of ``cuda:0`` traces
    the pinned single-device render's samples: the accumulator bit for bit,
    the ray counts equal, kernel 2 once per super-step of each shard."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused
    from pathtracer_tpu_torch.parallel.mesh import make_mesh
    from pathtracer_tpu_torch.parallel.sharded import gather_image, render_sharded
    from pathtracer_tpu_torch.render import wavefront

    scene = _scene("cornell", (64, 48))
    cfg = RenderConfig(wavefront=True, max_depth=6, nee=True, iters_per_launch=2)
    _, whole, st1 = render(scene, 4, cfg, device="cuda")
    mesh = make_mesh([torch.device("cuda", 0)] * 2)
    k2, steps = bounce_fused.launches, wavefront.super_steps
    _, blocks, st2 = render_sharded(scene, 4, cfg, mesh=mesh)
    torch.cuda.synchronize()
    assert bounce_fused.launches - k2 == wavefront.super_steps - steps > 0
    assert all(b.device == torch.device("cuda", 0) for b in blocks)
    assert st1["rays_traced"] == st2["rays_traced"]
    assert torch.equal(gather_image(blocks, mesh), whole)


# ---- kernel 4's packed paths and the lane order of kernel 2's mesh
# instances: bit for bit (chip_smoke.py [grad], [grad:vol], [grad:surf]
# and [mesh], [bigmesh] hold them at full width)

PACKING_CASES = {
    "cornell": ("cornell", dict(max_depth=8, nee=True, rr=False, rr_start=3)),
    "cornell_rr": ("cornell", dict(max_depth=8, nee=True, rr=True, rr_start=2)),
    "milky": ("milky", dict(max_depth=8, nee=True, rr=False, rr_start=3)),
    "ward": ("ward", dict(max_depth=8, nee=True, rr=True, rr_start=2)),
    "surf_vol_mini": ("surf_vol_mini", dict(max_depth=6, nee=True, rr=False, rr_start=3)),
}


@pytest.mark.parametrize("case", sorted(PACKING_CASES))
def test_trace_fwd_packed_paths_bit_equal(case):
    """Kernel 4 with its block's live paths packed into its first warps at
    each bounce (4, 4v, 4s and kVol x kSurf) on 97x61 lanes, not a
    multiple of the block: radiance, the int64 ray count and the whole
    residual stack equal to ``tfwd_plain``'s, and the radiance to the trace
    kernel's."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import trace_grad
    from pathtracer_tpu_torch.render.features import features_for_materials

    name, kw = PACKING_CASES[case]
    scene = _surf_grad_scene(name, (97, 61))
    feats = frozenset(features_for_materials(scene.materials)) - {"hg"}
    tables = pack_tables(scene)
    n, seed = 97 * 61, 23
    sample = torch.arange(n, device="cuda") + 5 * n
    rays = generate_camera_rays(scene.camera, sample - 5 * n, camera_uniforms(seed, sample))
    args = (*tables, seed, rays.origin, rays.direction, sample)
    rad_k, nr_k, res_k = trace_grad.tfwd_cuda(*args, features=feats, **kw)
    rad_t, nr_t = trace.trace_cuda(*args, features=feats, **kw)
    rad_p, nr_p, res_p = trace_grad.tfwd_plain(*args, features=feats, **kw)
    torch.cuda.synchronize()
    assert int(nr_k) == int(nr_t) == int(nr_p) > 0
    assert torch.equal(rad_k, rad_p) and torch.equal(rad_k, rad_t)
    assert torch.equal(res_k, res_p)
    assert float(res_k[-1, res_k.shape[1] - 3].mean()) < 1.0  # some paths ended early


def _mesh_sweep_state(name, tmp_path):
    if name == "2m":
        scene = _scene("smooth_mesh", (8, 8))
        n = 50_001  # not a multiple of the block
        t = _random_lanes_cuda(n, 8)
        t["origin"] = t["origin"] * 0.7 + torch.tensor([0.0, 1.8, 0.0], device="cuda")
        state = (t["origin"], t["direction"], t["throughput"], t["sample"].long(), t["depth"],
                 t["prev"], torch.zeros((n, 4), device="cuda"))
        return scene, state, dict(features=frozenset())
    scene = _bigmesh("grid24", (127, 129), tmp_path)
    return scene, _primary_state(scene), dict(features=frozenset({"glossy", "texture"}),
                                               tex_defer=True)


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("name", ["2m", "2mt"])
def test_bounce_mesh_block_sweep_bit_equal(tmp_path, name, nee):
    """Kernel 2m (smooth_mesh, random lanes around the icosphere, 50,001 of
    them) and 2mt (the vt grid's primary rays at 127x129), whose blocks
    sweep the triangles together (``bounce.cu:block_mesh_sweep``): every
    output plane equal to ``bounce_fused_plain``'s, whose lanes each sweep
    on their own."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused
    from pathtracer_tpu_torch.ops.mesh_tables import mesh_sweep

    scene, state, kw = _mesh_sweep_state(name, tmp_path)
    km = scene.mesh_tables
    tables = [t.contiguous() for t in pack_tables(scene)]
    args = (tables, *state, 19)
    got = bounce_fused.bounce_fused_cuda(*args, nee=nee, mesh=km, **kw)
    want = bounce_fused.bounce_fused_plain(*args, nee=nee, mesh=km, **kw)
    reached = mesh_sweep(km, tables[0], state[0].unbind(-1), state[1].unbind(-1))["reached"]
    torch.cuda.synchronize()
    _all_equal(got, want)
    assert 100 < int((reached > 0).sum()) < state[0].shape[0]


# kernel 2's analytic media and surface instances: 2r-v runs the grouped
# kernel (csrc/bounce.cu:bounce_kernel_grouped, each block's lanes shaded in
# the order of the event their nearest hit gives), the others one lane per
# thread: label, scene, replay planes, vol_nee; "primary" on the camera
# rays, the others after two bounces
GROUPED_CASES = [("2v", "sss", False, True), ("2hg", "sss", False, True),
                 ("2s", "ward", False, True), ("2t", "textured_image", False, True),
                 ("2v-s", "milky_ward", False, True), ("2r-v", "milky", True, True),
                 ("2r-v no vol_nee", "milky", True, False), ("2r-v primary", "milky", True, True),
                 ("2r-s", "ward", True, True), ("2r-v-s", "milky_ward", True, True)]
GROUPED_RES = (233, 217)  # 50,561 lanes: a last block of one lane


def _bits(x):
    return x.view(torch.uint8) if x.dtype == torch.bool else x.view(torch.int32)


@pytest.mark.parametrize("label,name,replay,vol_nee", GROUPED_CASES)
def test_grouped_bounce_matches_plain_after_two_bounces(label, name, replay, vol_nee):
    """Kernel 2's media and surface instances (2v, 2hg, 2s, 2t, kVol x
    kSurf, and the replay instances: 2r-v on the grouped kernel, 2r-s, kVol
    x kSurf) against ``bounce_fused_plain`` on the state after two bounces
    of the primary rays (``bounce_fused_plain``'s own; 2r-v also on the
    primary rays, the scan's bounce 0), at 233x217 (the last block holds
    one lane): every output plane bit for bit, terminated lanes included."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import bounce_fused
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.scene.variants import SCENES_DIR, milky_ward_scene

    if name == "milky_ward":
        desc = parse_scene_text(milky_ward_scene(), name=name, scene_dir=SCENES_DIR)
    else:
        desc = load_scene(os.path.join(ROOT, "scenes", f"{name}.txt"))
    scene = dataclasses.replace(desc, resolution=GROUPED_RES).scene_for_frame(0, device="cuda")
    feats = resolve_features(RenderConfig(nee=True), scene.materials).features
    if label == "2v":
        feats = tuple(f for f in feats if f != "hg")
    feats = frozenset(feats)
    tex = scene.textures is not None
    tables = [t.contiguous() for t in pack_tables(scene)]
    seed = key_to_seed(prng_key(3))
    n = GROUPED_RES[0] * GROUPED_RES[1]
    pixel = torch.arange(n, device="cuda")
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
    o, d = rays.origin, rays.direction
    thr, prev = torch.ones((n, 3), device="cuda"), torch.zeros(n, device="cuda")
    medium = torch.zeros((n, bounce_fused.medium_width(feats)), device="cuda")
    kw = dict(nee=True, features=feats, vol_nee=vol_nee, tex_defer=tex)
    on = torch.ones(n, dtype=torch.bool, device="cuda")
    prior = 0 if label.endswith("primary") else 2
    for dep in range(prior):
        r = bounce_fused.bounce_fused_plain(tables, o, d, thr, pixel, dep, prev, medium, seed, **kw)
        r = r[0] if tex else r
        on = on & ~r.terminate
        a = on[:, None]
        o, d = torch.where(a, r.next_origin, o), torch.where(a, r.next_direction, d)
        thr, prev = torch.where(a, thr * r.throughput_mult, thr), r.was_specular
        medium = r.next_medium
    args = (tables, o, d, thr, pixel, prior, prev, medium.contiguous(), seed)
    got = bounce_fused.bounce_fused_cuda(*args, emit_replay=replay, **kw)
    want = bounce_fused.bounce_fused_plain(*args, emit_replay=replay, **kw)
    torch.cuda.synchronize()
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    fields = ("contrib", "next_origin", "next_direction", "throughput_mult", "terminate",
              "was_specular", "rr_uniform", "next_medium")
    planes = [(f, getattr(got[0], f), getattr(want[0], f)) for f in fields]
    planes += [(f"extra {k}", g, w) for k, (g, w) in enumerate(zip(got[1:], want[1:]))]
    assert len(planes) == 8 + (2 if replay else 0) + (3 if tex else 0)
    differ = {f: int((_bits(g) != _bits(w)).reshape(n, -1).any(-1).sum()) for f, g, w in planes}
    print(f"{label}: {int(on.sum())} of {n} lanes alive; lanes that differ per plane {differ}")
    assert not any(differ.values())


# scene, pixel stride, iteration, jitter: the camera kernel's cases (96x96)
CAMERA_CASES = [("cornell", 1, 0, True), ("cornell", 1, 7, True), ("cornell", 1, 7, False),
                ("cornell", 3, (1 << 32) // (96 * 96) + 2, True), ("glass_dof", 1, 5, True),
                ("glass_dof", 5, (1 << 31) // (96 * 96) + 1, False)]


@pytest.mark.parametrize("name,stride,iteration,jitter", CAMERA_CASES)
def test_camera_kernel_matches_plain(name, stride, iteration, jitter):
    """Kernel ``csrc/camera.cu`` against the plain ops on the card, bit for
    bit on every lane, origin and direction: pinhole and thin lens, a
    strided subset, sample indices past 2^31 and 2^32."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import camera
    from pathtracer_tpu_torch.ops.rng import KeyedSeed, prng_key

    scene = _scene(name, (96, 96))
    n = 96 * 96
    pixel = torch.arange(0, n, stride, device="cuda")
    sample = iteration * n + pixel
    seed = KeyedSeed(prng_key(4321))
    before = camera.launches
    got = camera.camera_rays_cuda(scene.camera, pixel, sample, seed, jitter)
    assert camera.launches == before + 1
    want = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample), jitter=jitter)
    torch.cuda.synchronize()
    assert torch.equal(got.origin, want.origin)
    assert torch.equal(got.direction, want.direction)
    if name == "glass_dof":  # thin lens: the origins spread over the aperture
        assert float(got.origin.std(0).max()) > 0.05
    cfg = RenderConfig(jitter=jitter)
    via = camera.primary_rays(scene.camera, pixel, sample, seed, cfg)
    assert camera.launches == before + 2
    assert torch.equal(via.origin, want.origin) and torch.equal(via.direction, want.direction)


def test_camera_kernel_launches_per_render_iteration_not_in_a_gradient_step():
    """A 4-spp ``render()`` takes the camera kernel once an iteration; a
    gradient step, whose camera fields require grad, takes the plain ops."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import camera
    from pathtracer_tpu_torch.ops.rng import prng_key
    from pathtracer_tpu_torch.render import diff

    scene = _scene("cornell", (64, 48))
    before = camera.launches
    render(scene, 4, RenderConfig(), device="cuda")
    torch.cuda.synchronize()
    assert camera.launches - before == 4
    desc = dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", "cornell.txt")),
                               resolution=(64, 48))
    params, static = diff.params_from_description(desc, 0, device="cuda")
    before = camera.launches
    _, grads, _ = diff.loss_and_grad_rays(params, static, torch.zeros((64 * 48, 3), device="cuda"),
                                          2, prng_key(0), RenderConfig(max_depth=4))
    torch.cuda.synchronize()
    assert camera.launches == before
    assert float(grads.cam_position.abs().sum()) > 0
