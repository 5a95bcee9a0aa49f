"""The benchmark's plain mesh reference (``port_bench/reference/mesh.py``)
against the port's CPU path, and the benchmark's two mesh-era cells at a
tiny size.

* ``render()`` on the CPU (the wavefront engine over ``ops/bounce.
  bounce_physics`` with the scene's in-kernel triangle tables) against the
  reference's ``render_pixels`` on smooth_mesh, on the icosphere with its
  vertices and authored normals jittered from a seed, and on
  ``scene/variants.grid_obj(8)`` (face normals) under materials drawn from a
  seed: equal ray counts and accumulators equal bit for bit.  Both run the
  same float32 operations in the same order; the reference sweeps every
  triangle where the port culls by chunk box, which changes a winner only
  for a hit a rounding outside its box, and none of these renders has one.
* The ``flat`` and ``dropped`` faults of ``port_bench/tests/faults_mesh.py``
  (authored normals dropped; one 32-triangle chunk left out) change the
  accumulator against the reference.
* ``smooth_mesh.render`` and ``cornell.grad_lean`` run through
  ``port_bench/harness/core.run_cell`` at ``port_bench/tests/bench_tiny.py``'s
  sizes read ``correct``; the lean cell's steps run ``render/diff.
  LeanSample``; the mesh cell's window builds no triangle tables
  (``ops.mesh_tables.builds``), and a scene's one build runs inside the
  ``pt.mesh_tables`` span.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import copy
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import RenderConfig, render
from pathtracer_tpu_torch.ops import mesh_tables
from pathtracer_tpu_torch.scene import variants
from pathtracer_tpu_torch.scene.parser import parse_scene_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench.entries import mesh_render  # noqa: E402
from port_bench.harness import cellkit, core  # noqa: E402
from port_bench.reference import mesh as ref_mesh  # noqa: E402
from port_bench.reference import scene as ref_scene  # noqa: E402
from port_bench.tests.faults_mesh import broken_scene  # noqa: E402

W, H = 40, 30
SPP = 2
KEY = (11, 2_147_483_977)
SETTINGS = core.load_cell("smooth_mesh.render")[1]["render"]
ICO = os.path.join(variants.SCENES_DIR, "assets", "ico_smooth.obj")
TINY = {"smooth_mesh.render": (24, 16), "cornell.grad_lean": (20, 14)}  # bench_tiny's sizes


def smooth_mesh_text() -> str:
    return cellkit.scene_text(core.load_cell("smooth_mesh.render")[1])


def jittered_ico(seed: int) -> str:
    """smooth_mesh's icosphere with its vertices moved by up to 2% of its
    radius and its authored normals by up to 0.3, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    with open(ICO) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] in ("v", "vn"):
                amp = 0.01 if parts[0] == "v" else 0.3
                xyz = np.array([float(p) for p in parts[1:4]]) + rng.uniform(-amp, amp, 3)
                line = f"{parts[0]} {xyz[0]:.6f} {xyz[1]:.6f} {xyz[2]:.6f}\n"
            out.append(line)
    return "".join(out)


def random_material(rng) -> str:
    """A non-emissive material of a lobe drawn from ``rng``: Lambert, mirror,
    Phong-glossy or Fresnel glass."""
    rgb = " ".join(f"{c:.3f}" for c in rng.uniform(0.1, 0.9, 3))
    spec = " ".join(f"{c:.3f}" for c in rng.uniform(0.5, 1.0, 3))
    lobe = int(rng.integers(4))
    specex = f"{rng.uniform(5.0, 60.0):.2f}" if lobe == 2 else "0"
    refl, refr = int(lobe in (1, 2)), int(lobe == 3)
    ior = f"{rng.uniform(1.3, 1.7):.3f}" if refr else "0"
    return (f"RGB {rgb}\nSPECEX {specex}\nSPECRGB {spec}\nREFL {refl}\nREFR {refr}\n"
            f"REFRIOR {ior}\nSCATTER 0\nABSCOEFF 0 0 0\nRSCTCOEFF 0\nEMITTANCE 0\n")


def grid_scene(seed: int) -> str:
    """A floor, a sphere and the rippled 8x8 grid (128 triangles, no
    authored normals) under an area light; the floor, sphere and grid take
    materials drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    mats = "".join(f"MATERIAL {i}\n{random_material(rng)}\n" for i in range(3))
    light = ("MATERIAL 3\nRGB 1 1 1\nSPECEX 0\nSPECRGB 0 0 0\nREFL 0\nREFR 0\nREFRIOR 0\n"
             "SCATTER 0\nABSCOEFF 0 0 0\nRSCTCOEFF 0\nEMITTANCE 9\n")
    yaw = rng.uniform(-40.0, 40.0)
    return mats + light + f"""
CAMERA
RES 64 64
FOVY 35
ITERATIONS 4
FILE grid.png
frame 0
EYE 0 2 7
VIEW 0 -.15 -1
UP 0 1 0

OBJECT 0
cube
material 0
frame 0
TRANS 0 -.5 0
ROTAT 0 0 0
SCALE 20 1 20

OBJECT 1
grid.obj
material 2
frame 0
TRANS 0 1.8 0
ROTAT -15 {yaw:.3f} 0
SCALE 4 4 4

OBJECT 2
sphere
material 1
frame 0
TRANS 1.8 .8 1.2
ROTAT 0 0 0
SCALE 1.4 1.4 1.4

OBJECT 3
cube
material 3
frame 0
TRANS 0 8 2
ROTAT 0 0 0
SCALE 6 .3 6
"""


def scene_case(case: str, tmp_path) -> tuple:
    """``(scene text, scene_dir)`` of a test case."""
    if case == "smooth_mesh":
        return smooth_mesh_text(), variants.SCENES_DIR
    kind, seed = case.split(":")
    if kind == "ico":
        (tmp_path / "ico.obj").write_text(jittered_ico(int(seed)))
        return smooth_mesh_text().replace("assets/ico_smooth.obj", "ico.obj"), str(tmp_path)
    (tmp_path / "grid.obj").write_text(variants.grid_obj(8))
    return grid_scene(int(seed)), str(tmp_path)


def program_render(text: str, scene_dir: str, fault=None):
    desc = dataclasses.replace(parse_scene_text(text, scene_dir=scene_dir), resolution=(W, H))
    scene = desc.scene_for_frame(0, device="cpu")
    if fault is not None:
        scene = broken_scene(scene, fault)
    _, acc, stats = render(scene, SPP, RenderConfig(**SETTINGS), base_key=KEY, device="cpu")
    return acc, stats["rays_traced"]


def reference_render(text: str, scene_dir: str):
    sc = ref_mesh.parse(text, (W, H), scene_dir)
    return ref_mesh.render_pixels(sc, ref_scene.leaves(sc, "cpu"), torch.arange(W * H),
                                  range(SPP), KEY, SETTINGS)


@pytest.mark.parametrize("case", ["smooth_mesh", "ico:5", "ico:2147483999", "grid:3",
                                  "grid:4000000007"])
def test_reference_equals_the_programs_cpu_path(case, tmp_path):
    text, scene_dir = scene_case(case, tmp_path)
    acc, rays = program_render(text, scene_dir)
    ref, ref_rays = reference_render(text, scene_dir)
    assert rays == ref_rays
    assert torch.equal(acc, ref), float((acc - ref).abs().max())


def test_reference_reads_the_obj_as_the_program_does():
    """Same triangles and unit normals (the reference's in Morton order)."""
    from pathtracer_tpu_torch.scene.obj import load_obj_full

    data = load_obj_full(ICO)
    mine = ref_mesh.read_obj(ICO)
    assert torch.equal(mine["verts"], torch.from_numpy(data.verts))
    assert torch.equal(mine["norm"], torch.from_numpy(data.norm))
    verts = torch.from_numpy(data.verts)
    cent = (verts[:, 0] + verts[:, 1] + verts[:, 2]) / 3.0
    want = torch.argsort(mesh_tables.morton3(cent), stable=True)
    assert torch.equal(ref_mesh.morton_order(verts), want)


@pytest.mark.parametrize("fault", ["flat", "dropped"])
def test_mesh_faults_fail_the_comparison(fault, tmp_path):
    text, scene_dir = scene_case("smooth_mesh", tmp_path)
    acc, _ = program_render(text, scene_dir, fault)
    ref, _ = reference_render(text, scene_dir)
    assert cellkit.max_gap(acc, ref) > 0.05


def tiny_cell(name: str) -> tuple:
    wl, cfg = core.load_cell(name)
    wl = copy.deepcopy(wl)
    w, h = TINY[name]
    wl["traffic"].update(width=w, height=h)
    wl["trace_units"] = 2
    if "pixels" in wl["check"]:
        wl["check"]["pixels"] = 64
    return wl, cfg


@pytest.mark.parametrize("cell", ["smooth_mesh.render", "cornell.grad_lean"])
def test_new_cells_are_correct_at_a_tiny_size(cell):
    wl, cfg = tiny_cell(cell)
    line = core.run_cell(wl, cfg, 2_147_483_999, 0.2, False, device="cpu")
    assert line["correct"], line["checks"]


def test_lean_cell_runs_the_lean_engine(monkeypatch):
    """The cell's ``render`` object (``grad_fused`` off) puts every step on
    ``render/diff.LeanSample``; ``grad_lean`` alone would leave the
    full-depth engine (kernels 4 and 5) in place."""
    from pathtracer_tpu_torch.render import diff

    calls = []
    apply = diff.LeanSample.apply
    monkeypatch.setattr(diff.LeanSample, "apply", lambda *a: calls.append(1) or apply(*a))
    wl, cfg = tiny_cell("cornell.grad_lean")
    assert wl["render"] == {"grad_fused": False}
    line = core.run_cell(wl, cfg, 5, 0.0, False, device="cpu")
    assert line["correct"] and len(calls) >= line["attempted"] + int(wl["traffic"]["checked_steps"])


def test_mesh_cell_window_builds_no_tables():
    wl, cfg = tiny_cell("smooth_mesh.render")
    cell = mesh_render.Cell(wl, cfg, 7, torch.device("cpu"))
    before = mesh_tables.builds
    cell.setup()
    assert mesh_tables.builds == before + 1
    for _ in range(2):
        cell.unit(lambda name: torch.profiler.record_function(name))
    counters = cell.outputs()["counters"]
    assert counters["ops.mesh_tables.builds"] == 0 and counters["ops.mesh_tables.triangles"] == 0


def test_mesh_tables_build_inside_its_span(tmp_path):
    desc = parse_scene_text(smooth_mesh_text(), scene_dir=variants.SCENES_DIR)
    scene = desc.scene_for_frame(0, device="cpu")
    before = (mesh_tables.builds, mesh_tables.triangles)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        km = scene.mesh_tables
        again = scene.mesh_tables
    assert km is again
    assert (mesh_tables.builds, mesh_tables.triangles) == (before[0] + 1, before[1] + 320)
    names = [e.name for e in prof.events()]
    assert names.count("pt.mesh_tables") == 1
