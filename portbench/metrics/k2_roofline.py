"""k2_roofline: K2's least time at the published peaks as a share of
its device time in the window.

K2 is ``select_tile`` (``raft_tpu_torch/ops/csrc/select_tile.cu``: the
kernels ``select_rows``, ``wide_bound``, ``wide_filter`` and
``wide_select``).  The widths K2 selects over are the program's own
design (how it splits a probe and a merge), so every launch's shape comes
from the program's cost inventory (the ``select_tile`` entries, keyed
``(m, w, k)``); its comparisons and bytes from the frozen
``select_cost`` (a comparison at the FP32 rate); the time from the
trace, summed over K2's kernels.  Returns None only where no K2 kernel
ran in the window; where one ran and the inventory counted no launch, it
raises, and the run fails."""

import ast

from portbench.frozen import cost, peaks
from portbench.trace import SELECT_KERNEL


def read(ctx):
    kernels = ctx.trace.kernels(SELECT_KERNEL)
    if not kernels:
        return None
    shapes = ctx.launches.get("select_tile", {})
    if not shapes:
        raise RuntimeError("k2_roofline: %d K2 kernels ran in the window, but the program's "
                           "inventory counted no select_tile launch" % len(kernels))
    ops_s = bytes_s = 0.0
    for key, n in shapes.items():
        m, w, k = ast.literal_eval(key)[:3]
        o, b = peaks.least_seconds(*cost.select_cost(m, w, k), peaks.FP32_FLOPS)
        ops_s, bytes_s = ops_s + n * o, bytes_s + n * b
    return peaks.roofline(ops_s, bytes_s, sum(k[2] for k in kernels))
