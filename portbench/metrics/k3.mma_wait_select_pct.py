"""k3.mma_wait_select_pct: the share of the multiplying warpgroup's cycles
in K3 (`knn_tile_kernel` in mode 2, the IVF-Flat work-list scan) spent
waiting for the selection to free a distance tile: the `dist_empty`
mbarrier waits before the epilogue; high where the selection sets the
pace.

Read from the kernel's phase counters after the window, on timed calls
of the pool batches (``portbench/phases.py``): the cycles of the role's
four warps from its start to its exit, summed over every block. The
notes hold every role's phase shares and cycles, the timed calls' device
seconds, the timed library's build, and the cost of timing: the timed
call's device time over the window's kernel time per call. Returns None
where the kernel did not run in the window, or where the program has no
phase counters."""

from portbench import phases


def read(ctx):
    return phases.read(ctx, mode=2, phase="wait_select")
