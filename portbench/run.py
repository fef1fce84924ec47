"""Run one cell of the benchmark of ``raft_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's set-up (kernel libraries, data
from the seed, the index, warm-up) is timed as ``setup_s``; then the
cell's traffic runs for ``--seconds``; then the answers are checked
against the plain reference.  The last line of standard output is the
result as JSON; the numbers compared are the last lines of standard
error.  With ``--trace 1`` the window runs under ``torch.profiler`` and
the result carries the per-layer metrics instead of the end-to-end ones.

Exits 2 without the CUDA cards the cell asks for, and 3 if JAX or the
JAX package was loaded; neither prints a result.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

T_START = harness.process_start()


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print("portbench: the cell needs %d CUDA card(s); this machine has %d"
              % (spec["chips"], torch.cuda.device_count() if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                              T_START)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print("portbench: the run loaded %s" % ", ".join(loaded), file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
