"""Readings for the limits of a cell's check, on the card.

    python3 portbench/control.py --workload <cell> --program-seeds 1,2,... \\
        --control-seeds 101,102,103 [--control tf32,kmeans_early] [--seconds 2]

Runs the cell in this one process once per seed, at its own sizes, with a
short window: with the program's answers for each program seed (the
lower readings: what sound runs read), and with each control's in their
place for each control seed (the upper readings).  The controls are the
reference's ``CONTROLS``: ``tf32``, the reference in the precision below
the configuration's (one TF32 pass), and for an index ``kmeans_early``,
the reference's own build stopped after its first Lloyd step.  Prints one
JSON line a run with every number the check compares; the limits in
``workloads/<cell>.json`` are set from them.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control", default="tf32", help="controls to run, comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    runs = [(int(s), None) for s in args.program_seeds.split(",") if s]
    runs += [(int(s), kind) for kind in args.control.split(",") if kind
             for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        res = harness.run_cell(spec, seed, args.seconds, False, "cuda", time.monotonic(),
                               control=control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": control or "program",
                          "correct": res["correct"], "metrics": res["metrics"],
                          "compared": {k: v["value"] for k, v in res["compared"].items()},
                          "checked": res["notes"]["checked"]}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
