"""pq_scan_roofline: the least time of the IVF-PQ search's ADC work at the
published peaks as a share of the device time under the program's
``ivf_pq_search.tables`` and ``ivf_pq_search.scan`` ranges in the window.

The work is what the inputs need, counted by the benchmark
(``frozen/pq_cost.py``), as ``k3_roofline`` counts K3's: each pool
batch's own float32 probe of the index's centroids, the index's list
sizes, and how many times the window searched the batch; the operations
at the FP32 rate.  It reads the same work whatever implements it.
Returns None only where neither range ran anything in the window."""

import torch

from portbench import spans
from portbench.frozen import peaks, pq_cost


def read(ctx):
    if ctx.trace is None:
        return None
    spent = spans.seconds(ctx.trace, "ivf_pq_search.tables") + spans.seconds(
        ctx.trace, "ivf_pq_search.scan")
    if spent <= 0.0:
        return None
    index, config = ctx.system.index, ctx.config
    cent = index.centroids.to(torch.float32)
    sizes = index.list_sizes.to(torch.int64)
    n_sub, ksub = index.codebooks.shape[:2]
    nprobe = int(config["nprobe"])
    kk = ctx.k * int(config["refine_ratio"])
    ops_s = bytes_s = 0.0
    for q, calls in zip(ctx.work["pool"], ctx.work["calls"]):
        if not calls:
            continue
        dist = (q * q).sum(1)[:, None] + (cent * cent).sum(1)[None, :] - 2.0 * (q @ cent.T)
        probed = torch.topk(dist, nprobe, dim=1, largest=False).indices
        ops, nbytes = pq_cost.adc_cost(q.shape[0], q.shape[1], ksub, n_sub,
                                       int(config["pq_bits"]), nprobe, kk,
                                       int(sizes[probed].sum()),
                                       int(sizes[torch.unique(probed)].sum()))
        o, b = peaks.least_seconds(ops, nbytes, peaks.FP32_FLOPS)
        ops_s, bytes_s = ops_s + calls * o, bytes_s + calls * b
    return peaks.roofline(ops_s, bytes_s, spent)
