"""k1.wave_fill_pct: the share of the block slots of K1's waves that its
blocks fill, in percent.

K1's blocks run one to an SM, so a launch of b blocks on s SMs takes
ceil(b / s) waves and fills b of their ceil(b / s) * s slots; a slot left
empty is an SM idle while the wave's other blocks run.  Read after the
window from the program's own counters, ``WAVE_COUNTERS`` in
``raft_tpu_torch.ops.knn_tile`` (blocks launched, and the slots of the
waves they took), summed over every K1 launch of the run: every K1 launch
of a brute-force cell has the cell's one shape, so the run's share is the
window's.  Returns None where K1 did not run in the window and where the
program has no such counters (it predates them); raises where K1 ran and
the counters read nothing."""

from portbench.trace import tile_kernel


def read(ctx):
    if not ctx.trace.kernels(tile_kernel(0)):
        return None
    try:
        from raft_tpu_torch.ops.knn_tile import WAVE_COUNTERS
    except ImportError:
        return None
    from raft_tpu_torch.core import tracing
    blocks, slots = (tracing.get_counter(name) for name in WAVE_COUNTERS)
    if blocks <= 0 or slots <= 0:
        raise RuntimeError("K1 ran in the window, but its wave counters read %d blocks in "
                           "%d slots" % (blocks, slots))
    return {"value": 100.0 * blocks / slots, "blocks": blocks, "wave_slots": slots}
