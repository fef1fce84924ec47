"""K7: the IVF-PQ ADC scan, ``csrc/pq_scan.cu``.

Replaces no Pallas kernel: the JAX package scans PQ codes in its XLA
loop (``raft_tpu/spatial/ann.py``, the ``"gather"`` ADC), and so did the
port, as torch ops.  The function, the same for the kernel and its plain
version: for each query, the squared ADC distance of every stored row of
its ``nprobe`` probed lists (the sum over the M subspaces of the table of
the query's residual to the row's list centroid, looked up by the row's
codes) and the ``kk`` smallest, ascending, with global int32 ids;
vacant rows (id < 0) are skipped and unfilled results are (+inf, -1).

- :func:`ivf_pq_scan` launches the kernel on CUDA tensors: one 512-thread
  block an SM takes one query at a time and keeps the codebooks, the
  (query, probe) table, the query's running top-kk and its candidates in
  shared memory, so that the codes are read once and nothing else
  reaches device memory (``csrc/pq_scan.cu`` says what bounds it).  It
  takes the codes as uint8 rows of 16, 32 or 64 bytes
  (:func:`narrow_codes`); ties go to the smaller id.  The table is laid
  out so that an entry's shared-memory bank is set by its subspace, and
  each lane of a warp walks its row's subspaces in its own order, so
  that every table read of a warp falls in 32 banks (the rule is
  ``csrc/pq_layout.cuh``, which the kernel includes and the CPU tests
  compile on the host).  At the sift1m_ivfpq cell's shape on an H100
  that took the kernel from 28.1 to 24.0 ms a call, with fewer
  instructions a lookup as well as fewer bank passes; the code rows'
  loads through L1 are the next bound, as ``csrc/pq_scan.cu`` says.
- :func:`ivf_pq_scan_plain` is the step loop of ``spatial/ann.py``: the
  tables of a chunk of queries by one batched product
  (``ann._pq_tables``, the expanded form), then one step a probed slot,
  its table values gathered by the codes, summed, and merged into the
  running top-kk by ``select_k`` (ties to the earlier step).  It is the
  route of every CPU call, and of a CUDA call the kernel does not take.

:func:`takes` is the kernel's legality rule, from what a call can
observe: CUDA float32 queries, centroids and codebooks, M <= 64, a
power-of-two codebook of at most 256 codewords, d <= 512, kk <= 512, and
the shared memory (:func:`smem_bytes`) within Hopper's 227 KB.  The two
versions sum in another order and build their tables in another form
(direct differences in the kernel), so distances agree to float32
rounding and ids up to ADC ties.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import inventory, tracing
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _build, cost

# csrc/pq_scan.cu: the largest kk, subspaces and depth a launch takes, the
# code row widths it is built for, the entries of its sort area (top list
# and candidate buffer), and the dynamic shared memory a Hopper block may opt into (227 KB, less
# the kernel's static shared variables)
MAX_KK = 512
MAX_M = 64
MAX_D = 512
CODE_BYTES = (16, 32, 64)
SORT_AREA = 2048
SMEM_LIMIT = 232_448 - 64
TABLE_FLOATS = 64 * 256


def smem_bytes(d: int, ksub: int, nprobe: int, max_slots: int) -> int:
    """Dynamic shared memory of a launch (``smem_bytes`` in the source):
    the sort area's 2,048 8-byte keys, the codebooks, the table, the
    query and its residual, and each probe's row count and slots."""
    return (8 * SORT_AREA + 4 * (d * ksub + TABLE_FLOATS + 2 * d)
            + 4 * nprobe * (1 + max_slots))


def code_bytes(M: int) -> int:
    """Bytes of a narrowed code row: M rounded up to a width the kernel
    is built for."""
    return next(b for b in CODE_BYTES if M <= b)


def fits(d: int, M: int, ksub: int, kk: int, nprobe: int, max_slots: int) -> bool:
    """The shapes the kernel is built for (module doc)."""
    return (M <= MAX_M and ksub & (ksub - 1) == 0 and ksub <= 256 and d <= MAX_D
            and 0 < kk <= MAX_KK and smem_bytes(d, ksub, nprobe, max_slots) <= SMEM_LIMIT)


def takes(queries: torch.Tensor, centroids: torch.Tensor, codebooks: torch.Tensor, kk: int,
          nprobe: int, max_slots: int) -> bool:
    """The legality rule (module doc): whether :func:`ivf_pq_scan` takes
    a call with these operands."""
    M, ksub, _ = codebooks.shape
    return (queries.device.type == "cuda"
            and all(t.dtype == torch.float32 for t in (queries, centroids, codebooks))
            and fits(queries.shape[1], M, ksub, kk, nprobe, max_slots))


def narrow_codes(slot_codes: torch.Tensor) -> torch.Tensor:
    """The index's (S, cap, M) codes as the kernel reads them: (S * cap,
    :func:`code_bytes`) uint8 rows, zero past M.  The codes are k-means
    labels below the codebook size, 256 at most."""
    S, cap, M = slot_codes.shape
    width = code_bytes(M)
    if width == M:
        return slot_codes.reshape(S * cap, M).to(torch.uint8)
    out = torch.zeros((S * cap, width), dtype=torch.uint8, device=slot_codes.device)
    out[:, :M] = slot_codes.reshape(S * cap, M)
    return out


def ivf_pq_scan_plain(queries: torch.Tensor, centroids: torch.Tensor, codebooks: torch.Tensor,
                      codes: torch.Tensor, slot_ids: torch.Tensor, cent_slots: torch.Tensor,
                      probes: torch.Tensor, kk: int, n_live: Optional[int] = None,
                      select_impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (module doc): the tables in the range
    ``ivf_pq_search.tables``, the step loop in ``ivf_pq_search.scan``.
    ``codes`` (S, cap, >= M) of any integer type (the first M of a row
    are its codes); ``n_live`` the steps to run, at least the most probed
    slots of any query (counted here where None); ``select_impl`` the
    running select's route."""
    from raft_tpu_torch.spatial.ann import D, _pq_tables, _probe_compact, _scan_steps

    M = codebooks.shape[0]
    with tracing.annotate("ivf_pq_search.tables"):
        lut_all = _pq_tables(queries, centroids, codebooks, probes)
    rowsel = torch.arange(queries.shape[0], device=queries.device)

    def step_dist(slx, pjx):
        lut = lut_all[rowsel, pjx]                         # (nq, M, ksub)
        step = codes[slx][:, :, :M]                        # (nq, cap, M)
        dist = torch.gather(lut, 2, step.transpose(1, 2).long()).sum(dim=1)
        return dist, slot_ids[slx]

    with tracing.annotate("ivf_pq_search.scan"):
        slots, prank, live = _probe_compact(queries, centroids, cent_slots, probes.shape[1],
                                            probes, ranks=True)
        steps = int(live) if n_live is None else n_live
        return _scan_steps(queries, slots, prank, steps, step_dist, kk, D.L2Expanded,
                           select_impl)


def ivf_pq_scan(queries: torch.Tensor, centroids: torch.Tensor, codebooks: torch.Tensor,
                codes: torch.Tensor, slot_ids: torch.Tensor, cent_slots: torch.Tensor,
                probes: torch.Tensor, kk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kk nearest rows by ADC of each query's probed lists (module
    doc).  queries (nq, d) float32; centroids (nlist, d) float32;
    codebooks (M, ksub, dsub) float32; codes the :func:`narrow_codes` of
    the index's (S, cap, M) codes; slot_ids (S, cap) int32, -1 vacant;
    cent_slots (nlist, max_slots) int32, -1 padded; probes (nq, nprobe)
    int32 list ids.  Returns (nq, kk) float32 squared distances ascending
    and int32 ids.  CUDA tensors launch the kernel (a call it does not
    take raises); CPU tensors take :func:`ivf_pq_scan_plain`."""
    if queries.device.type == "cpu":
        S, cap = slot_ids.shape
        return ivf_pq_scan_plain(queries, centroids, codebooks, codes.reshape(S, cap, -1),
                                 slot_ids, cent_slots, probes, kk)
    _build.load("pq_scan")      # built or loaded before any work on the device
    nq, d = queries.shape
    M, ksub, dsub = codebooks.shape
    S, cap = slot_ids.shape
    nlist, max_slots = cent_slots.shape
    nprobe = probes.shape[1]
    expects(takes(queries, centroids, codebooks, kk, nprobe, max_slots),
            "ivf_pq_scan: the kernel does not take d=%d M=%d ksub=%d kk=%d nprobe=%d "
            "max_slots=%d (%s queries)", d, M, ksub, kk, nprobe, max_slots, queries.dtype)
    expects(centroids.shape[1] == d and M * dsub == d,
            "ivf_pq_scan: centroids and codebooks must span d=%d", d)
    expects(codes.dtype == torch.uint8 and tuple(codes.shape) == (S * cap, code_bytes(M)),
            "ivf_pq_scan: codes must be narrow_codes' (%d, %d) uint8", S * cap, code_bytes(M))
    expects(slot_ids.dtype == torch.int32 and cent_slots.dtype == torch.int32
            and probes.dtype == torch.int32 and probes.shape[0] == nq,
            "ivf_pq_scan: int32 ids, slots and (nq, nprobe) probes required")
    expects(S * cap < 2**31, "ivf_pq_scan: store rows overflow int32")
    dev = queries.device
    expects(all(t.device == dev for t in (centroids, codebooks, codes, slot_ids, cent_slots,
                                          probes)),
            "ivf_pq_scan: inputs on different devices")
    out_d = torch.empty((nq, kk), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, kk), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_i
    args = [t.contiguous() for t in (queries, centroids, codebooks, codes, slot_ids, cent_slots,
                                     probes)]
    next_query = torch.zeros(1, dtype=torch.int32, device=dev)
    _build.launch("pq_scan", dev, (*args, nq, d, M, ksub, dsub, cap, max_slots, nlist, nprobe, kk,
                                   codes.shape[1], next_query, out_d, out_i),
                  "ivf_pq_scan", (nq, d, M, ksub, nprobe, kk, S, cap), lambda: (
                      *scan_cost(slot_ids, cent_slots, probes, d, ksub, M, kk),
                      inventory.footprint(args, (out_d, out_i))))
    return out_d, out_i


def scan_cost(slot_ids: torch.Tensor, cent_slots: torch.Tensor, probes: torch.Tensor, d: int,
              ksub: int, M: int, kk: int) -> Tuple[float, float]:
    """:func:`raft_tpu_torch.ops.cost.pq_scan_cost` of a launch: the
    stored rows of each query's probed lists, and of the distinct lists.
    Reads the counts from the device."""
    stored = torch.cat([(slot_ids >= 0).sum(dim=1),
                        torch.zeros(1, dtype=torch.int64, device=slot_ids.device)])
    per_list = stored[cent_slots.long()].sum(dim=1)          # a -1 slot reads the 0 appended
    probed = probes.long()
    return cost.pq_scan_cost(probes.shape[0], d, ksub, M, probes.shape[1], kk,
                             int(per_list[probed].sum()), int(per_list[torch.unique(probed)].sum()))
