"""The mesh-era parts of the benchmark: the plain mesh reference stays
independent of the program, the frozen mesh counts are the smoke script's,
kernel 1m's roofline share reads what a traced run gives it, and the lean
cell runs ``grad``'s step and check under a traffic name of its own.

The mesh cells' correctness, the reference against the program's CPU path
and the planted mesh faults are held in the repository's Tier-1 tests
(``tests/test_torch_mesh_reference.py``)."""

import copy
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from port_bench.harness import core
from port_bench.harness.profile import TraceData
from port_bench.tests.test_bench_imports import FORBIDDEN, PROGRAM
from port_bench.yardstick import roofline, roofline_mesh

MESH_READER = "roofline_pct.trace_mesh"


def test_mesh_reference_and_yardstick_load_nothing_of_the_program_or_jax():
    """Imported in a fresh process, with everything they import in turn."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import port_bench.reference.mesh, port_bench.yardstick.roofline_mesh;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(sys.argv[2:])))")
    out = subprocess.run([sys.executable, "-c", code, core.ROOT, PROGRAM, *FORBIDDEN],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_frozen_mesh_counts_are_the_smoke_scripts():
    spec = importlib.util.spec_from_file_location("chip_smoke_mesh_constants",
                                                  os.path.join(core.ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in ("OPS_MESH_RAY", "OPS_TO_OBJECT", "OPS_MT"):
        assert getattr(roofline_mesh, name) == getattr(smoke, name), name


def test_mesh_bound_counts_the_analytic_geoms_and_one_triangle():
    types = [1, 2, 1, 1]  # smooth_mesh: three cubes and the mesh
    lb, lanes = 10_000_000, 1_000_000
    got = roofline_mesh.trace_mesh_bound_s(2 * lb, lanes, 1, types, 4, True, [(320, True)])
    per = (3 * (roofline.OPS_TO_OBJECT + roofline.OPS_CUBE) + roofline_mesh.OPS_MESH_RAY
           + roofline_mesh.OPS_MT + roofline_mesh.OPS_MESH_NORMAL + roofline.OPS_SHADE)
    assert got == pytest.approx(lb * per / roofline.FP32_OPS_PER_S, rel=1e-12)
    nbytes = lanes * 40 + roofline.table_bytes(4, 4) + 4 * 320 * 21
    one = roofline_mesh.trace_mesh_bound_s(2, lanes, 1, types, 4, True, [(320, True)])
    assert one == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S, rel=1e-12)


@pytest.fixture(scope="module")
def traced_context():
    """A tiny CPU run's context of two frames and the seconds they took."""
    import time

    from port_bench.entries import mesh_render

    wl, cfg = core.load_cell("smooth_mesh.render")
    wl = copy.deepcopy(wl)
    wl["traffic"].update(width=24, height=16)
    cell = mesh_render.Cell(wl, cfg, 5, torch.device("cpu"))
    cell.setup()
    t0 = time.perf_counter()
    for _ in range(2):
        cell.unit(lambda name: torch.profiler.record_function(name))
    return cell.trace_context(2), time.perf_counter() - t0


def test_mesh_roofline_reads_below_100_on_a_tiny_run(traced_context):
    """The stretch's seconds put on one ``trace_kernel``: what the CPU took
    for the paths is far above their least time on the card."""
    context, seconds = traced_context
    assert context["mesh_tris"] == [(320, True)] and context["geom_types"] == [1, 2, 1, 1]
    t = TraceData([(0.0, seconds, "void trace_kernel<true>(float*)")], [], [], [], context,
                  window_s=seconds)
    value = core.reader("metrics", MESH_READER).value(t)
    assert 0.0 < value < 100.0


def test_mesh_roofline_reads_none_without_a_trace_kernel(traced_context):
    context, seconds = traced_context
    t = TraceData([(0.0, seconds, "bounce_kernel")], [], [], [], context, window_s=seconds)
    assert core.reader("metrics", MESH_READER).value(t) is None
    analytic = dict(context, mesh_tris=[])
    t = TraceData([(0.0, seconds, "trace_kernel")], [], [], [], analytic, window_s=seconds)
    assert core.reader("metrics", MESH_READER).value(t) is None


def test_mesh_config_is_its_scene_file():
    wl, cfg = core.load_cell("smooth_mesh.render")
    assert wl["entry"] == "mesh_render" and cfg["scene_file"] == "scenes/smooth_mesh.txt"
    with open(os.path.join(core.ROOT, cfg["scene_file"])) as f:
        assert f.read().splitlines() == cfg["scene"]


def test_every_pair_of_config_and_traffic_is_one_cell():
    bench = core.load_json(core.ROOT, "BENCHMARK.json")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs)), pairs


def test_lean_cell_is_grads_step_and_check_under_its_own_traffic():
    from port_bench.entries import grad, grad_lean

    wl, cfg = core.load_cell("cornell.grad_lean")
    assert wl["entry"] == "grad_lean" and wl["render"] == {"grad_fused": False}
    for name in ("Cell", "check", "compare", "program_calls", "reference_outputs"):
        assert getattr(grad_lean, name) is getattr(grad, name)
