"""pq.refine_pct: device time of the operations launched inside the
``ivf_pq_search.refine`` range (``raft_tpu_torch/spatial/ann.py``: the
exact re-rank of each chunk's ADC candidates against the stored vectors)
as a share of the device's busy time in the window.  None where the
range ran nothing in the window."""

from portbench import spans


def read(ctx):
    return spans.busy_pct(ctx.trace, "ivf_pq_search.refine")
