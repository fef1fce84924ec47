"""ivf.work_list_pct: device time of the operations launched inside the
``fused_ivf_scan.work_list`` range (``raft_tpu_torch/ops/ivf_tile.py``:
inverting the scan lists into K3's work list) as a share of the device's
busy time in the window."""

from portbench.trace import DEVICE_CATS


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    busy = t.busy_s()
    under = t.under_range("fused_ivf_scan.work_list", t.kernels(cats=DEVICE_CATS))
    if busy <= 0.0 or not under:
        return None
    return 100.0 * sum(k[2] for k in under) / busy
