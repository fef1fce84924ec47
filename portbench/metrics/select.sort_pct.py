"""select.sort_pct: device time of the operations launched inside the
``select_k.sort`` range (``raft_tpu_torch/spatial/select_k.py``: every
select that takes the stable sort, as a running select past K2's k does)
as a share of the device's busy time in the window.  None where no
sorting select ran in the window."""

from portbench import spans


def read(ctx):
    return spans.busy_pct(ctx.trace, "select_k.sort")
