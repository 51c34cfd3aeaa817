"""Readings of a cell's compared numbers, for the program and for its
lower-precision control, on the card at the cell's own size:

    python3 portbench/controls.py --workload <name> --seeds 1,2,3 --seconds 10 [--control]

Each seed runs the cell once (a short window at the cell's own load) and
prints one JSON line of its compared numbers.  ``--control`` switches on
the program's lower-precision path that the configuration names
(``control_env``, or the RAG configuration's int8 decoder); the benchmark's
own runs never do.  ``limits/<workload>.json`` holds limits set between
the program's highest reading and the control's lowest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)  # the checkout, not portbench/

from portbench import harness  # noqa: E402


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    root = harness.HERE.parent
    bench = harness.load_json(root / "BENCHMARK.json")
    workload = next(w for w in bench["workloads"] if w["name"] == args.workload)
    os.environ.update(harness.cache_env(root))
    import torch

    if not torch.cuda.is_available():
        print("controls are read on the card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(bench, workload, seed, args.seconds, False, control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "readings": {**{c["name"]: c["value"] for c in res["checks"]}, **res["readings"]},
                          "window": res["diagnostics"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
