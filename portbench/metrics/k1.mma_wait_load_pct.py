"""k1.mma_wait_load_pct: the share of the multiplying warpgroup's cycles in
K1 (`knn_tile_kernel` in mode 0, the brute-force tile) spent waiting for
the TMA ring: the `full[slot]` mbarrier waits before each index box's
fragments load; high where the ring (the loads) sets the pace.

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
    return phases.read(ctx, mode=0, phase="wait_load")
