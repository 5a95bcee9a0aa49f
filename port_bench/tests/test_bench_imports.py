"""No module of the benchmark imports JAX or the JAX package, the reference
and the yardstick import nothing of the program, and a run's process holds
none of the forbidden modules once it is done."""

import ast
import os
import subprocess
import sys

import pytest

from port_bench.harness import core

FORBIDDEN = set(core.FORBIDDEN_MODULES)
PROGRAM = "pathtracer_tpu_torch"


def modules_under(*parts):
    base = os.path.join(core.HERE, *parts)
    for dirpath, _, files in os.walk(base):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_tops(path: str) -> set:
    """Top-level names of every module ``path`` imports (the part before
    the first dot, compared whole)."""
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", list(modules_under()), ids=lambda p: os.path.relpath(p, core.HERE))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", list(modules_under("reference")) + list(modules_under("yardstick")),
                         ids=lambda p: os.path.relpath(p, core.HERE))
def test_reference_and_yardstick_import_nothing_of_the_program(path):
    assert PROGRAM not in imported_tops(path)


def test_whole_name_compare():
    """The port's name begins with the JAX package's: only whole names count."""
    assert PROGRAM.startswith("pathtracer_tpu") and PROGRAM not in FORBIDDEN
    assert "pathtracer_tpu" in FORBIDDEN


def test_a_run_loads_no_forbidden_module():
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "from port_bench.tests.bench_tiny import run_tiny;"
            "line = run_tiny('cornell.render', 3);"
            "from port_bench.harness import core;"
            "print(json.dumps([line['correct'], core.forbidden_loaded()]))")
    out = subprocess.run([sys.executable, "-c", code, core.ROOT], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"
