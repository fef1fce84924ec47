"""pq.scan_pct: device time of the operations launched inside the
``ivf_pq_search.scan`` range (``raft_tpu_torch/spatial/ann.py``: each
chunk's scan lists and its step loop, table reads, code gathers, sums
and the running select) as a share of the device's busy time in the
window.  None where the range ran nothing in the window.

The notes carry the search's counters as the program counted them over
the whole run, warm-up included (every call of the cell has its one
shape): chunks, scan steps launched and bytes of tables built, and the
steps and table bytes a chunk."""

from portbench import spans


def read(ctx):
    pct = spans.busy_pct(ctx.trace, "ivf_pq_search.scan")
    if pct is None:
        return None
    out = {"value": pct}
    try:
        from raft_tpu_torch.spatial.ann import PQ_COUNTERS
    except ImportError:
        return out
    from raft_tpu_torch.core import tracing
    chunks, steps, table_bytes = (tracing.get_counter(name) for name in PQ_COUNTERS)
    out.update(chunks=chunks, steps=steps, table_bytes=table_bytes)
    if chunks:
        out.update(steps_per_chunk=steps / chunks, table_bytes_per_chunk=table_bytes / chunks)
    return out
