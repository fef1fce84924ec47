"""k1_roofline: K1's least time at the published peaks as a share of
its device time in the window.

K1 is ``knn_tile_kernel`` in mode 0 (``raft_tpu_torch/ops/csrc``).  The
work is what the inputs need, counted by the benchmark: each pool batch's
queries against every index row, times the calls the window made of it,
whatever launches the program splits a call into.  Operations and bytes
come from the frozen ``knn_cost``; at "highest" a multiply-add takes
three TF32 passes.  The time is the trace's, summed over K1's kernels.
Returns None only where no K1 kernel ran in the window."""

from portbench.frozen import cost, peaks
from portbench.trace import tile_kernel


def read(ctx):
    kernels = ctx.trace.kernels(tile_kernel(0))
    if not kernels:
        return None
    rows, d = int(ctx.config["rows"]), int(ctx.config["dim"])
    precision = ctx.config["precision"]
    rate = peaks.TF32_FLOPS if precision == "highest" else peaks.BF16_FLOPS
    ops_s = bytes_s = 0.0
    for q, calls in zip(ctx.work["pool"], ctx.work["calls"]):
        ops, nbytes = cost.knn_cost(q.shape[0], rows, d, ctx.k)
        o, b = peaks.least_seconds(ops * cost.TENSOR_PASSES[precision], nbytes, rate)
        ops_s, bytes_s = ops_s + calls * o, bytes_s + calls * b
    return peaks.roofline(ops_s, bytes_s, sum(k[2] for k in kernels))
