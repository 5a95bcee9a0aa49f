"""The benchmark's files: every name and unit keeps to the contract's
characters, every cell, configuration and metric named in BENCHMARK.json
has its file, and a cell added as a file is found without an edit."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from port_bench.harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = core.load_json(core.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(core.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                         + BENCH["per_layer"], ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    wl, cfg = core.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["name"] == cell and wl["config"] == entry["config"] == cfg["name"]
    assert wl["entry"] == entry["traffic"]
    assert os.path.exists(os.path.join(core.HERE, "entries", f"{wl['entry']}.py"))
    assert set(wl["check"]["limits"]) and all(v >= 0 for v in wl["check"]["limits"].values())
    e2e, layer = core.cell_metrics(BENCH, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = core.load_json(core.ROOT, cfg["file"])
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert {"max_depth", "nee", "jitter", "vol_nee"} <= set(data["render"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers_load(metric):
    kind = "e2e" if metric in BENCH["end_to_end"] else "metrics"
    assert callable(core.reader(kind, metric["name"]).value)
    if kind == "metrics":
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("name,file", [("idle_pct.render", "idle_pct.py"),
                                       ("idle_pct.grad", "idle_pct.py"),
                                       ("roofline_pct.trace", "roofline_pct.trace.py"),
                                       ("roofline_pct.trace_grad", "roofline_pct.trace_grad.py")])
def test_reader_is_found_by_name_or_its_shared_file(name, file):
    assert os.path.basename(core.reader("metrics", name).__file__) == file


def test_a_metric_without_a_reader_is_refused():
    with pytest.raises(FileNotFoundError):
        core.reader("metrics", "no_such_metric.render")


def test_workload_render_object_merges_over_the_config():
    from port_bench.harness import cellkit

    wl, cfg = core.load_cell("cornell.grad")
    assert cellkit.render_settings(wl, cfg) == cfg["render"]
    wl = dict(wl, render={"grad_lean": True, "max_depth": 3})
    got = cellkit.render_settings(wl, cfg)
    assert got["grad_lean"] is True and got["max_depth"] == 3 and got["nee"] == cfg["render"]["nee"]
    assert cfg["render"]["max_depth"] == 8


def test_a_cell_added_as_files_is_found(tmp_path):
    """Copy the benchmark, add a workload file and its BENCHMARK.json entry,
    and run it there on the CPU: nothing else is edited."""
    shutil.copytree(core.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    wl = core.load_json(core.HERE, "workloads", "cornell.render.json")
    wl.update(name="cornell.small", traffic=dict(wl["traffic"], width=16, height=12))
    wl["check"]["pixels"] = 32
    (tmp_path / "port_bench" / "workloads" / "cornell.small.json").write_text(json.dumps(wl))
    bench["workloads"].append({"name": "cornell.small", "config": "cornell", "traffic": "render",
                               "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cornell.render" in m.get("workloads", []):
            m["workloads"].append("cornell.small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
            "from port_bench.harness import core; assert core.ROOT == sys.argv[1];"
            "wl, cfg = core.load_cell('cornell.small');"
            "print(json.dumps(core.run_cell(wl, cfg, 5, 0.1, False, device='cpu')))")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), core.ROOT],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and {"render_msamples_s", "frame_ms_p95", "setup_s"} <= set(
        line["metrics"])


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    """Decided inside the test: on a host with a card the run is not tried."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(core.HERE, "run.py"), "--workload",
                          "cornell.render", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
