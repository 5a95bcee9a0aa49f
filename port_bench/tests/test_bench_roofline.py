"""The frozen yardstick gives the smoke script's bounds for the same rays.

``chip_smoke.py`` computes the Cornell bounds of kernel 1 (``[time]``) and
of kernels 4 and 5 (``[grad:time]``) from the same constants; the frozen
copy must give the same least times, so that the roofline shares read the
same work as the kernel table of PERF.md."""

import importlib.util
import os

import pytest

from port_bench.harness import core
from port_bench.reference import scene as ref_scene
from port_bench.harness import cellkit
from port_bench.yardstick import roofline as y


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_constants",
                                                  os.path.join(core.ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cornell():
    _, cfg = core.load_cell("cornell.render")
    return ref_scene.parse(cellkit.scene_text(cfg), (800, 800))


def test_constants_are_the_smoke_scripts(smoke):
    for name in ("HBM_BYTES_PER_S", "FP32_OPS_PER_S", "FP64_OPS_PER_S", "OPS_TO_OBJECT",
                 "OPS_SPHERE", "OPS_CUBE", "OPS_SHADE", "OPS_BWD_ADJOINT", "OPS_VOL",
                 "OPS_BWD_VOL"):
        assert getattr(y, name) == getattr(smoke, name), name


@pytest.mark.parametrize("rays", [6_838_272, 7_000_000])
def test_kernel1_bound_is_the_smoke_scripts(smoke, cornell, rays):
    """chip_smoke.py's [time] bound: 640,000 lanes, one launch."""
    n, types = 640_000, cornell["types"]
    sweep = sum(smoke.OPS_TO_OBJECT + (smoke.OPS_SPHERE if t == 0 else smoke.OPS_CUBE)
                for t in types)
    ops = rays // 2 * (sweep + smoke.OPS_SHADE)
    tables = 4 * (14 * len(types) + 28 * 7 + 19 * len(types) + 2)
    want = max((n * 40 + tables) / smoke.HBM_BYTES_PER_S, ops / smoke.FP32_OPS_PER_S)
    got = y.trace_bound_s(rays, n, 1, types, 7, True, False)
    assert got == pytest.approx(want, rel=1e-12)
    if rays == 6_838_272:  # 5.3424 bounces a lane: the kernel table's 0.0495 ms
        assert round(got * 1e3, 4) == 0.0496


def test_trace_grad_bound_is_the_smoke_scripts(smoke, cornell):
    """chip_smoke.py's [grad:time] forward and adjoint bounds, summed."""
    n, rays, depth, types = 640_000, 6_838_272, 8, cornell["types"]
    lb = rays // 2
    tables = 4 * (14 * len(types) + 28 * 7 + 19 * len(types) + 2)
    sweep = sum(smoke.OPS_TO_OBJECT + (smoke.OPS_SPHERE if t == 0 else smoke.OPS_CUBE)
                for t in types)
    f = max(lb * (sweep + smoke.OPS_SHADE) / smoke.FP32_OPS_PER_S,
            (n * 40 + depth * 13 * n * 4 + tables) / smoke.HBM_BYTES_PER_S)
    b_bytes = depth * n * 4 + lb * 12 * 4 + n * 40 + tables + tables
    b, _ = smoke.adjoint_bound(lb * (smoke.OPS_TO_OBJECT + min(smoke.OPS_SPHERE, smoke.OPS_CUBE)
                                     + smoke.OPS_SHADE), lb * smoke.OPS_BWD_ADJOINT, b_bytes)
    got = y.trace_grad_bound_s(rays, n, 1, depth, types, 7, True, False)
    assert got == pytest.approx(f + b / 1e3, rel=1e-12)
