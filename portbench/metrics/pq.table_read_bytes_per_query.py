"""pq.table_read_bytes_per_query: the device-memory bytes that the IVF-PQ
wide route's table construction reads, a query (the codebooks for each
query's own terms, each probed list's terms, the rows and centroids of
the residual norms), as the program models them.

Read after the window from the program's own counters
(``raft_tpu_torch.spatial.ann.PQ_TABLE_READS``: the bytes, a model worked
out from each launch's geometry and not measured, and the queries of
those launches), one over the other, so that the warm-up's calls, of the
cell's one shape, cancel.  At one shape it reads the same on every run.
Returns None where the wide route counted no query, and where the
program has no such counters (it predates them)."""


def read(ctx):
    try:
        from raft_tpu_torch.spatial.ann import PQ_TABLE_READS
    except ImportError:
        return None
    from raft_tpu_torch.core import tracing
    nbytes, queries = (tracing.get_counter(name) for name in PQ_TABLE_READS)
    if queries <= 0:
        return None
    return {"value": nbytes / queries, "table_read_bytes": nbytes, "queries": queries}
