"""Readings that the check's limits are set from, on the card.

    python3 port_bench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 3 \
        [--control-seeds 4,5,6] [--out FILE]

For each of ``--seeds`` one run of the cell (set-up, a ``--seconds``
window, the check) in this process, printing each number compared; for each
of ``--control-seeds`` the control: the plain reference computed in
bfloat16 put in the program's place (at the cell's own size, with the frame
count of the last run), held to the float32 reference by the same
comparison; for each of ``--faults`` (``tests/faults.py``) and each of
``--fault-seeds`` a run with that fault planted in the timed path.  One
JSON line per reading; ``--out`` keeps them too.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import importlib

    import torch

    from port_bench.harness import core

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="planted faults to read, e.g. half,altered")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    wl, cfg = core.load_cell(args.workload)
    entry = importlib.import_module(f"port_bench.entries.{wl['entry']}")
    dev = torch.device("cuda")
    lines, frames = [], 1
    for s in [int(x) for x in args.seeds.split(",") if x]:
        line = core.run_cell(wl, cfg, s, args.seconds, False)
        frames = line["attempted"]
        lines.append({"kind": "program", "seed": s, "attempted": frames,
                      "numbers": {k: v["value"] for k, v in line["checks"].items()},
                      "metrics": {k: v["value"] for k, v in line["metrics"].items()}})
        print(json.dumps(lines[-1]), flush=True)
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        got = entry.reference_outputs(wl, cfg, s, dev, dt=torch.bfloat16, frames=frames)
        ref = entry.reference_outputs(wl, cfg, s, dev, frames=frames)
        lines.append({"kind": "control", "seed": s, "frames": frames,
                      "numbers": entry.compare(got, ref)})
        print(json.dumps(lines[-1]), flush=True)
        del got, ref
        torch.cuda.empty_cache()
    for kind in [k for k in args.faults.split(",") if k]:
        from port_bench.tests import faults

        program = getattr(faults, f"{wl['entry']}_fault")(kind)
        for s in [int(x) for x in args.fault_seeds.split(",") if x]:
            line = core.run_cell(wl, cfg, s, args.seconds, False, program=program)
            lines.append({"kind": f"fault:{kind}", "seed": s,
                          "numbers": {k: v["value"] for k, v in line["checks"].items()}})
            print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
