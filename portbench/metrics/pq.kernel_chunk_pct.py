"""pq.kernel_chunk_pct: the share of the IVF-PQ search's chunks that a
kernel route scanned (K7, or its wide route for rows whose codebook
outgrows shared memory), in percent, so that a call falling quietly to
the step scan shows.

Read after the window from the program's own counters
(``raft_tpu_torch.spatial.ann``: ``PQ_COUNTERS[0]``, every chunk
searched, and ``PQ_KERNEL_CHUNKS``, those a kernel route scanned), summed
over the run: every call of a cell has its one shape, so the run's share
is the window's.  The notes carry the wide route's chunks where the
program counts them.  Returns None where no chunk was counted, and where
the program has no such counters (it predates them)."""


def read(ctx):
    try:
        from raft_tpu_torch.spatial.ann import PQ_COUNTERS, PQ_KERNEL_CHUNKS
    except ImportError:
        return None
    from raft_tpu_torch.core import tracing
    chunks = tracing.get_counter(PQ_COUNTERS[0])
    if chunks <= 0:
        return None
    kernel = tracing.get_counter(PQ_KERNEL_CHUNKS)
    out = {"value": 100.0 * kernel / chunks, "chunks": chunks, "kernel_chunks": kernel}
    try:
        from raft_tpu_torch.spatial.ann import PQ_WIDE_CHUNKS
    except ImportError:
        return out
    out["wide_chunks"] = tracing.get_counter(PQ_WIDE_CHUNKS)
    return out
