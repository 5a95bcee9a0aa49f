"""Readings that the limits of a cell whose entry ``tests/faults.py`` does
not know are set from, on the card: ``mesh_render`` and ``grad_lean``.

    python3 port_bench/calibrate_mesh.py --workload smooth_mesh.render --seeds 1,2,3 \
        --seconds 3 [--control-seeds 4,5,6] [--faults flat,object,half,dropped \
        --fault-seeds 7,8] [--out FILE]

``calibrate.py`` takes the program's readings and the control's (the
reference in bfloat16, through the entry's ``reference_outputs`` and
``compare``); the faults are ``tests/faults_mesh.py``'s for ``mesh_render``
and ``tests/faults.py``'s ``grad`` faults for ``grad_lean``, each planted in
the timed path of a run (``core.run_cell(..., program=...)``) for each of
``--fault-seeds``.  One JSON line per reading; ``--out`` keeps them too.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    from port_bench import calibrate
    from port_bench.harness import core
    from port_bench.tests.faults import grad_fault
    from port_bench.tests.faults_mesh import mesh_render_fault

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--faults", default="", help="e.g. flat,object,half,dropped")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args, rest = ap.parse_known_args(argv)
    common = ["--workload", args.workload, "--seconds", str(args.seconds)]
    if args.out:
        common += ["--out", args.out]
    code = calibrate.main(common + rest)
    if code:
        return code
    wl, cfg = core.load_cell(args.workload)
    fault = {"mesh_render": mesh_render_fault, "grad_lean": grad_fault}[wl["entry"]]
    lines = []
    for kind in [k for k in args.faults.split(",") if k]:
        for s in [int(x) for x in args.fault_seeds.split(",") if x]:
            line = core.run_cell(wl, cfg, s, args.seconds, False, program=fault(kind))
            lines.append({"kind": f"fault:{kind}", "seed": s,
                          "numbers": {k: v["value"] for k, v in line["checks"].items()}})
            print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
