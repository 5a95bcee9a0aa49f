"""The adjoint kernels 3, 5, 3v and 5v with the kSurf instances' derivative
conventions (``kExact`` in ``csrc/bounce_adj.cuh``), against the
checkout's own, on one card:

    python -m pathtracer_tpu_torch.tools.exact_adjoint

Copies the package, ``scenes/`` and ``chip_smoke.py`` twice under
``build/exact_adjoint/``: ``as_is``, and ``exact``, whose adjoint takes
``kExact``'s conventions in every instance.  Runs ``chip_smoke.py``'s
``[grad]``, ``[grad:perbounce]`` / ``[grad:lean]`` and ``[grad:vol]``
phases in each copy (``as_is``, ``exact``, ``as_is``, one process each,
``tools/in_turns``) and prints their lanes against the float64 references,
the instances' registers, the kernels' times and the reverse kernels'
bodies and row sums.  The phases' checks print instead of exiting, so that
``exact``'s registers are reported where they miss Cornell's pins.  Needs a
card and ``nvcc``.
"""

from __future__ import annotations

import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HEADER = os.path.join("pathtracer_tpu_torch", "csrc", "bounce_adj.cuh")

SHOWN = ("[grad:check]", "[grad:time]", "[grad:perbounce:time]", "[grad:vol:time]",
         "[grad:vol:regs]", "[exact]", "CHECK FAILED")


def phases(card: str) -> None:
    """In a copy: the gradient phases of its ``chip_smoke.py``, their checks
    printed instead of exiting, and each kernel's time and error."""
    import torch

    import chip_smoke as cs
    from pathtracer_tpu_torch.ops import _build
    from pathtracer_tpu_torch.scene.parser import load_scene

    cs.check = lambda ok, msg: None if ok else print("CHECK FAILED:", msg, flush=True)
    reports = _build.build_all()
    dev, out = torch.device("cuda"), os.path.join("build", "out")
    os.makedirs(out, exist_ok=True)
    desc = load_scene(os.path.join("scenes", "cornell.txt"))
    loss, grads, k1 = cs.grad_phase(desc, dev, card, out)
    k2 = cs.grad_engines_phase(desc, dev, card, out, loss, grads)
    k3 = cs.grad_vol_phase(dev, card, out, reports)
    for e in k1 + k2 + k3:
        print(f"[exact] kernel {e['name']}: {e['ms']:.4f} ms, max abs err {e['max_abs_err']:.4g}")


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
    from pathtracer_tpu_torch.tools.in_turns import card, run_in_turns

    line = card()
    print(line)
    base = os.path.join(ROOT, "build", "exact_adjoint")
    for variant in ("as_is", "exact"):
        copy_checkout(os.path.join(base, variant), variant == "exact")
    return run_in_turns([(v, os.path.join(base, v)) for v in ("as_is", "exact", "as_is")],
                        __file__, "phases", [line], shown=SHOWN, timeout=1200)


if __name__ == "__main__":
    sys.exit(main())
