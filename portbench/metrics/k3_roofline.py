"""k3_roofline: K3's least time at the published peaks as a share of
its device time in the window.

K3 is ``knn_tile_kernel`` in mode 2 (``raft_tpu_torch/ops/csrc``).  The
work is what the inputs need, counted by the benchmark: each pool batch's
probe (its own float32 probe of the index's centroids), the index's list
sizes, and how many times the window searched each batch.  Operations
and bytes come from the frozen ``ivf_scan_cost``; at "highest" a
multiply-add takes three TF32 passes.  The time is the trace's, summed
over K3's kernels.  Returns None only where no K3 kernel ran in the
window."""

import torch

from portbench.frozen import cost, peaks
from portbench.trace import tile_kernel


def read(ctx):
    kernels = ctx.trace.kernels(tile_kernel(2))
    if not kernels:
        return None
    index = ctx.system.index
    cent = index.centroids.to(torch.float32)
    sizes = index.list_sizes.to(torch.int64)
    slots = (index.cent_slots >= 0).sum(dim=1).to(torch.int64)
    nprobe = int(ctx.config["nprobe"])
    ops_s = bytes_s = 0.0
    for q, calls in zip(ctx.work["pool"], ctx.work["calls"]):
        if not calls:
            continue
        dist = (q * q).sum(1)[:, None] + (cent * cent).sum(1)[None, :] - 2.0 * (q @ cent.T)
        probed = torch.topk(dist, nprobe, dim=1, largest=False).indices
        distinct = torch.unique(probed)
        ops, nbytes = cost.ivf_scan_cost(q.shape[0], q.shape[1], ctx.k,
                                         int(slots[probed].sum()), int(sizes[probed].sum()),
                                         int(sizes[distinct].sum()))
        o, b = peaks.least_seconds(ops * cost.TENSOR_PASSES["highest"], nbytes,
                                   peaks.TF32_FLOPS)
        ops_s, bytes_s = ops_s + calls * o, bytes_s + calls * b
    return peaks.roofline(ops_s, bytes_s, sum(k[2] for k in kernels))
