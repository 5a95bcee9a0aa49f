"""The adjoint kernels 3, 5, 3v and 5v with the kSurf instances' derivative
conventions (``kExact`` in ``csrc/bounce_adj.cuh``), against the
checkout's own, on one card:

    python -m pathtracer_tpu_torch.tools.exact_adjoint

Copies the package, ``scenes/`` and ``chip_smoke.py`` twice under
``build/exact_adjoint/``: ``as_is``, and ``exact``, whose adjoint takes
``kExact``'s conventions in every instance.  Runs ``chip_smoke.py``'s
``[grad]``, ``[grad:perbounce]`` / ``[grad:lean]`` and ``[grad:vol]``
phases in each copy (``as_is``, ``exact``, ``as_is``, one process each) and
prints their lanes against the float64 references, the instances'
registers and the kernels' times.  The phases' checks print instead of
exiting, so that ``exact``'s registers are reported where they miss
Cornell's pins.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HEADER = os.path.join("pathtracer_tpu_torch", "csrc", "bounce_adj.cuh")

PHASES = """
import os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.scene.parser import load_scene
cs.check = lambda ok, msg: None if ok else print("CHECK FAILED:", msg, flush=True)
reports = _build.build_all()
dev, out = torch.device("cuda"), os.path.join("build", "out")
os.makedirs(out, exist_ok=True)
desc = load_scene(os.path.join("scenes", "cornell.txt"))
loss, grads, k1 = cs.grad_phase(desc, dev, sys.argv[1], out)
k2 = cs.grad_engines_phase(desc, dev, sys.argv[1], out, loss, grads)
k3 = cs.grad_vol_phase(dev, sys.argv[1], out, reports)
for e in k1 + k2 + k3:
    print(f"[exact] kernel {e['name']}: {e['ms']:.4f} ms, max abs err {e['max_abs_err']:.4g}")
"""

SHOWN = ("[grad:check]", "[grad:vol:regs]", "[exact]", "CHECK FAILED")


def copy_checkout(dest: str, exact: bool) -> None:
    """The package, the scenes and the smoke script at ``dest``; with
    ``exact`` every kExact choice in the adjoint header taken."""
    shutil.rmtree(dest, ignore_errors=True)
    for name in ("pathtracer_tpu_torch", "scenes"):
        shutil.copytree(os.path.join(ROOT, name), os.path.join(dest, name),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dest)
    if exact:
        path = os.path.join(dest, HEADER)
        with open(path) as f:
            src = f.read()
        edited = src.replace("kExact ?", "true ?").replace("if constexpr (kExact)",
                                                           "if constexpr (true)")
        if edited.count("true ?") != src.count("kExact ?") or edited == src:
            raise RuntimeError(f"{HEADER}: no kExact choice to take")
        with open(path, "w") as f:
            f.write(edited)


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
    base = os.path.join(ROOT, "build", "exact_adjoint")
    for variant in ("as_is", "exact"):
        copy_checkout(os.path.join(base, variant), variant == "exact")
    rc = 0
    for variant in ("as_is", "exact", "as_is"):
        run = subprocess.run([sys.executable, "-c", PHASES, card], cwd=os.path.join(base, variant),
                             capture_output=True, text=True, timeout=1200)
        rc = rc or run.returncode
        print(f"== {variant}: exit {run.returncode}")
        for line in run.stdout.splitlines():
            if line.startswith(SHOWN):
                print(line[:400])
        if run.returncode:
            print(run.stderr[-3000:])
    return rc


if __name__ == "__main__":
    sys.exit(main())
