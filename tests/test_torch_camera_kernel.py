"""The camera kernel's lanes, built for the host CPU, against the plain ops;
the dispatch of ``ops/camera.primary_rays``; the kernel's per-camera table.

``csrc/camera.cu`` keeps a lane's arithmetic in ``pt::camera_lane``, which
also compiles as plain C++ (``tests/kernel_host_harness.cpp``'s
``host_camera``, no contraction of a*b+c, as ``nvcc -fmad=false``).  Its
lanes are held to ``generate_camera_rays(camera_uniforms(...))`` on CPU
tensors run with the card's two roundings (``_card_roundings``), where
PyTorch's CPU build rounds otherwise:

* ``tensor / number`` (the pixel coordinate over ``w - 1``): PyTorch's
  CUDA kernel multiplies by the number's float32 reciprocal, as the kernel
  does; the CPU divides;
* ``torch.sqrt``: correctly rounded on the card, as the kernel's ``sqrtf``;
  on the CPU, PyTorch computes the square root of a large float32 tensor
  with MKL's vector math, which misses the correctly rounded result in the
  last bit on some lanes (598 of 100,000 random values).

Tolerances, with the reason.  Pinhole lanes are bit-equal to the plain ops
run with the card's roundings.  Against the plain ops as the CPU rounds
them, a direction component may differ by a few ulps (``CPU_ULPS``: the
pixel coordinate one ulp apart moves the image-plane point by up to that
ulp times the half-extent, then the square root; 4 ulps measured here).  Thin-lens lanes
also go through ``sin`` and ``cos``, which the host's libm and PyTorch's
CPU kernels round differently: they are held within ``rtol = atol = 1e-6``
(measured: 9.5e-7 on origins of magnitude about 10, 1.2e-7 on directions).
The card's own plain ops are held bit for bit on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import ctypes
import dataclasses
import os
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import camera
from pathtracer_tpu_torch.ops.camera import (
    FRAME_COLS,
    camera_frame,
    camera_kernel_takes,
    camera_table,
    camera_uniforms,
    generate_camera_rays,
    primary_rays,
)
from pathtracer_tpu_torch.ops.rng import KeyedSeed, prng_key
from pathtracer_tpu_torch.render import diff, integrator, wavefront
from pathtracer_tpu_torch.render.integrator import camera_sample, render
from pathtracer_tpu_torch.scene.parser import load_scene

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "..", "scenes")
ULP = 1.2e-7  # one ulp of a unit direction's components
CPU_ULPS = 8  # the plain ops' CPU roundings against the card's, in ulps (measured: 4)
RES = (96, 80)
N = RES[0] * RES[1]


@pytest.fixture(scope="module")
def host_camera(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler on the host")
    out = str(tmp_path_factory.mktemp("camera_host") / "libcamera_host.so")
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-Wno-unknown-pragmas", "-shared",
         "-fPIC", "-o", out, os.path.join(HERE, "kernel_host_harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    fn = ctypes.CDLL(out).host_camera
    P, L = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [P, ctypes.c_uint, P, P, ctypes.c_int, L, L, ctypes.c_int, P, P]
    return fn


def _scene(name, focal=None):
    desc = dataclasses.replace(load_scene(os.path.join(SCENES, f"{name}.txt")), resolution=RES)
    scene = desc.scene_for_frame(0, device="cpu")
    if focal is not None:
        cam = dataclasses.replace(scene.camera, focal_distance=torch.tensor(float(focal)))
        scene = dataclasses.replace(scene, camera=cam)
    return scene


def _host_rays(fn, cam, pixel, sample, seed, jitter):
    n = pixel.shape[0]
    table = camera_table(cam)
    origin, direction = torch.empty((n, 3)), torch.empty((n, 3))
    fn(table.data_ptr(), seed, pixel.data_ptr(), sample.data_ptr(), n, cam.width, cam.height,
       int(jitter), origin.data_ptr(), direction.data_ptr())
    return origin, direction


_REAL_SQRT = torch.sqrt
_REAL_TRUEDIV = torch.Tensor.__truediv__


def _exact_sqrt(t):
    """The correctly rounded float32 square root (float64's, rounded once more)."""
    return _REAL_SQRT(t.double()).to(t.dtype)


def _reciprocal_div(t, other):
    """``t / other`` as PyTorch's CUDA kernel rounds a float32 tensor over a
    Python number: a product with the number's float32 reciprocal."""
    if isinstance(other, (int, float)) and t.dtype == torch.float32:
        return t * float(np.float32(1.0) / np.float32(other))
    return _REAL_TRUEDIV(t, other)


def _card_roundings(monkeypatch):
    monkeypatch.setattr(torch, "sqrt", _exact_sqrt)
    monkeypatch.setattr(torch.Tensor, "__truediv__", _reciprocal_div)

# scene, focal override, jitter, pixel stride, iteration (n_global = the whole image)
CASES = {
    "pinhole_jitter": ("cornell", None, True, 1, 3),
    "pinhole_no_jitter": ("cornell", None, False, 1, 3),
    "thin_lens_focal_set": ("glass_dof", None, True, 1, 5),
    "thin_lens_focal_unset": ("glass_dof", 0.0, True, 1, 5),
    "strided_subset": ("cornell", None, True, 7, 11),
    "past_2_31": ("cornell", None, True, 1, (1 << 31) // N + 1),
    "past_2_32": ("cornell", None, True, 3, (1 << 32) // N + 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_camera_lanes_match_plain(host_camera, monkeypatch, case):
    name, focal, jitter, stride, iteration = CASES[case]
    scene = _scene(name, focal)
    cam = scene.camera
    pixel = torch.arange(1, N, stride, dtype=torch.int64)  # a strided subset keys globally
    sample = iteration * N + pixel
    seed = KeyedSeed(prng_key(20240))
    u4 = camera_uniforms(seed, sample)
    plain = generate_camera_rays(cam, pixel, u4, jitter=jitter)
    _card_roundings(monkeypatch)
    exact = generate_camera_rays(cam, pixel, u4, jitter=jitter)
    monkeypatch.undo()
    origin, direction = _host_rays(host_camera, cam, pixel, sample, int(seed) & 0xFFFFFFFF, jitter)
    if float(cam.aperture) > 0:
        assert float(origin.std(0).max()) > 0.05  # the origins spread over the aperture
        for got, want in ((origin, exact.origin), (direction, exact.direction),
                          (origin, plain.origin), (direction, plain.direction)):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        return
    assert torch.equal(origin, exact.origin) and torch.equal(direction, exact.direction)
    assert torch.equal(origin, plain.origin)
    assert float((direction - plain.direction).abs().max()) <= CPU_ULPS * ULP
    if iteration * N >= 1 << 31:  # the hash keys the sample index's low 32 bits
        assert int(sample.max()) >= 1 << 31


def _fake_camera(device="cuda", requires_grad=False):
    """What the dispatch rule reads of a camera: each field's device and
    ``requires_grad``."""
    t = SimpleNamespace(device=torch.device(device), requires_grad=requires_grad)
    return SimpleNamespace(**{k: t for k in camera.CAMERA_FIELDS})


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, probe):
        probe.append(camera_kernel_takes(_fake_camera(requires_grad=True), _CUDA_PIX, True))
        return x.clone()

    @staticmethod
    def backward(ctx, g, _):
        return g, None


_CUDA_PIX = SimpleNamespace(device=torch.device("cuda"))


def test_dispatch_rule_case_by_case():
    cuda_cam, pix = _fake_camera(), _CUDA_PIX
    assert camera_kernel_takes(cuda_cam, pix, True)
    # the CPU: the pixels or the camera
    assert not camera_kernel_takes(_fake_camera("cpu"), pix, True)
    assert not camera_kernel_takes(cuda_cam, SimpleNamespace(device=torch.device("cpu")), True)
    assert not camera_kernel_takes(cuda_cam, pix, False)  # threefry's uniforms
    grad_cam = _fake_camera(requires_grad=True)
    assert torch.is_grad_enabled() and not camera_kernel_takes(grad_cam, pix, True)
    with torch.no_grad():
        assert camera_kernel_takes(grad_cam, pix, True)
    probe = []
    _Identity.apply(torch.ones(2, requires_grad=True), probe)
    assert probe == [True]  # grad mode is off inside a Function's forward
    # real CPU tensors: never the kernel, whatever else holds
    scene = _scene("cornell")
    with torch.no_grad():
        assert not camera_kernel_takes(scene.camera, torch.arange(4), True)


@pytest.mark.parametrize("fast_rng", [True, False])
def test_primary_rays_on_the_cpu_are_the_plain_rays(fast_rng):
    scene = _scene("glass_dof")
    cfg = RenderConfig(fast_rng=fast_rng)
    pixel = torch.arange(0, N, 5)
    sample = 9 * N + pixel
    seed = KeyedSeed(prng_key(3))
    before = camera.launches
    want = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample, fast_rng))
    got = primary_rays(scene.camera, pixel, sample, seed, cfg)
    assert torch.equal(got.origin, want.origin) and torch.equal(got.direction, want.direction)
    rays, sample_idx = camera_sample(scene, pixel, 9, seed, cfg, n_global_pixels=N)
    assert torch.equal(sample_idx, sample) and torch.equal(rays.direction, want.direction)
    assert camera.launches == before


def _plain_rays_per_call(cam, pixel, sample, seed, cfg):
    """The rays as every call made them before ``primary_rays``: the plain
    ops with the camera's constants made anew."""
    return generate_camera_rays(cam, pixel, camera_uniforms(seed, sample, cfg.fast_rng),
                                jitter=cfg.jitter)


@pytest.mark.parametrize("engine", [dict(), dict(wavefront=True),
                                    dict(wavefront=True, wavefront_pinned=False,
                                         wavefront_capacity=300)],
                         ids=["megakernel", "pinned", "queue"])
def test_cpu_renders_take_no_kernel_and_keep_their_rays(monkeypatch, engine):
    scene = dataclasses.replace(load_scene(os.path.join(SCENES, "cornell.txt")),
                                resolution=(24, 16)).scene_for_frame(0, device="cpu")
    cfg = RenderConfig(max_depth=3, **engine)
    before = camera.launches
    _, accum, stats = render(scene, 3, cfg, base_key=prng_key(5), device="cpu")
    assert camera.launches == before
    monkeypatch.setattr(integrator, "primary_rays", _plain_rays_per_call)
    monkeypatch.setattr(wavefront, "primary_rays", _plain_rays_per_call)
    _, accum_0, stats_0 = render(scene, 3, cfg, base_key=prng_key(5), device="cpu")
    assert torch.equal(accum, accum_0) and stats == stats_0


def test_cpu_gradient_step_takes_no_kernel():
    desc = dataclasses.replace(load_scene(os.path.join(SCENES, "cornell.txt")),
                               resolution=(16, 16))
    params, static = diff.params_from_description(desc, 0, device="cpu")
    before = camera.launches
    loss, grads, _ = diff.loss_and_grad_rays(params, static, torch.full((256, 3), 0.25), 2,
                                             prng_key(3), RenderConfig(max_depth=3),
                                             device="cpu")
    assert camera.launches == before
    assert torch.isfinite(loss) and float(grads.cam_position.abs().sum()) > 0


def test_camera_table_is_made_once_a_camera():
    """The kernel's table: the frame's fields in order, with no autograd
    history; kept while the camera's tensors are the same objects,
    unchanged in place; made anew for other tensors, after an in-place
    change, and for inference tensors (which keep no version counter)."""
    cam = _scene("glass_dof").camera
    table = camera_table(cam)
    assert table.shape == (FRAME_COLS,) and not table.requires_grad
    assert torch.equal(table, torch.cat([t.reshape(-1) for t in camera_frame(cam)]))
    assert camera_table(cam) is table
    assert camera_table(dataclasses.replace(cam)) is table  # the same tensors
    moved = dataclasses.replace(cam, position=cam.position + 1.0)
    table_moved = camera_table(moved)
    assert table_moved is not table and torch.equal(table_moved[:3], cam.position + 1.0)
    with torch.no_grad():
        moved.position.add_(1.0)
    table_again = camera_table(moved)
    assert table_again is not table_moved and torch.equal(table_again[:3], cam.position + 2.0)
    leaf = dataclasses.replace(cam, view=cam.view.clone().requires_grad_(True))
    assert torch.is_grad_enabled() and not camera_table(leaf).requires_grad
    with torch.inference_mode():
        frozen = dataclasses.replace(cam, position=cam.position.clone())
        assert camera_table(frozen) is not camera_table(frozen)
        assert torch.equal(camera_table(frozen), table)
