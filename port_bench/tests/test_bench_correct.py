"""``correct`` comes out true for the program and false for the control
and for each fault the cells can have, at a tiny size on the CPU.

The control is the plain reference computed in bfloat16, one step below
the configuration's float32, put in the program's place.  The faults break
the timed path underneath a whole run (set-up, window, check), with the
harness's look for a card skipped: a step that returns its state unchanged,
half of the batch left out (the mean taken over the rest), and an answer
altered where it is produced.  The cells run on one chip, so no exchange
between chips can be left out."""

import importlib

import pytest
import torch

from port_bench.harness import cellkit, core
from port_bench.tests.faults import grad_fault, render_fault
from port_bench.tests.bench_tiny import run_tiny, tiny_cell

SEED = 2_147_483_999


@pytest.mark.parametrize("cell", ["cornell.render", "milky.render", "cornell.grad", "milky.grad"])
def test_program_is_correct(cell):
    assert run_tiny(cell, SEED)["correct"]


@pytest.mark.parametrize("cell", ["cornell.render", "milky.grad"])
def test_control_is_not_correct(cell):
    wl, cfg = tiny_cell(cell)
    entry = importlib.import_module(f"port_bench.entries.{wl['entry']}")
    dev = torch.device("cpu")
    got = entry.reference_outputs(wl, cfg, SEED, dev, dt=torch.bfloat16, frames=3)
    ref = entry.reference_outputs(wl, cfg, SEED, dev, frames=3)
    numbers = entry.compare(got, ref)
    checks = cellkit.checks(numbers, wl["check"]["limits"])
    assert not all(c["value"] <= c["limit"] for c in checks.values()), numbers


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "object"])
def test_render_faults_are_not_correct(kind):
    assert not run_tiny("cornell.render", SEED, program=render_fault(kind))["correct"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_grad_faults_are_not_correct(kind):
    line = run_tiny("cornell.grad", SEED, program=grad_fault(kind))
    assert not line["correct"], line["checks"]


def test_workload_render_settings_reach_program_and_reference():
    """A cell's own ``render`` object (here a shallower depth) is what the
    program runs with and what the reference follows."""
    from pathtracer_tpu_torch.render.integrator import render

    seen = []

    def spy(scene, spp, cfg, **kw):
        seen.append(cfg.max_depth)
        return render(scene, spp, cfg, **kw)

    wl, cfg = tiny_cell("cornell.render")
    wl["render"] = {"max_depth": 2}
    line = core.run_cell(wl, cfg, SEED, 0.2, False, device="cpu", program={"render": spy})
    assert seen and set(seen) == {2} and line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["cornell.render", "cornell.grad"])
def test_traced_run_on_the_cpu(cell):
    """The three stretches are taken and the line carries what they say."""
    line = run_tiny(cell, SEED, trace=True)
    assert line["correct"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["stretches"]) == {"untraced", "device_only", "with_host_ops"}
    assert all(s["window_s"] > 0 and s["units"] == 2 for s in line["stretches"].values())
    assert line["device"]["window_s"] == line["stretches"]["device_only"]["window_s"]
    assert list(line)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cornell.render", "milky.grad"])
def test_cell_is_correct_on_the_card(cell):
    """The whole run on the card at 256x256, the kernels built or loaded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wl, cfg = tiny_cell(cell)
    wl["traffic"].update(width=256, height=256)
    line = core.run_cell(wl, cfg, SEED, 1.0, False, device="cuda")
    assert line["correct"], line["checks"]
