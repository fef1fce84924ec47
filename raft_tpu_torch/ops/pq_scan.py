"""K7: the IVF-PQ ADC scan, ``csrc/pq_scan.cu``, and its wide-row route,
``csrc/pq_scan_wide.cu``.

Replaces no Pallas kernel: the JAX package scans PQ codes in its XLA
loop (``raft_tpu/spatial/ann.py``, the ``"gather"`` ADC), and so did the
port, as torch ops.  The function, the same for both routes and their
plain version: for each query, the squared ADC distance of every stored
row of its ``nprobe`` probed lists (the sum over the M subspaces of the
table of the query's residual to the row's list centroid, looked up by
the row's codes) and the ``kk`` smallest, ascending, with global int32
ids; vacant rows (id < 0) are skipped and unfilled results are (+inf,
-1).  Both routes take the codes as uint8 rows (:func:`narrow_codes`;
chunk-major on the wide route) and break ties to the smaller id.

- :func:`ivf_pq_scan` launches K7 on CUDA tensors: one 512-thread block
  an SM takes one query at a time and keeps the codebooks, the (query,
  probe) table (direct differences), the query's running top-kk and its
  candidates in shared memory, so that the codes are read once and
  nothing else reaches device memory (``csrc/pq_scan.cu`` says what
  bounds it).  Its code rows are 16, 32 or 64 bytes.  The table is laid
  out so that an entry's shared-memory bank is set by its subspace, and
  each lane of a warp walks its row's subspaces in its own order, so that
  every table read of a warp falls in 32 banks (the rule is
  ``csrc/pq_layout.cuh``, which the kernels include and the CPU tests
  compile on the host).  At the sift1m_ivfpq cell's shape on an H100
  that took the kernel from 28.1 to 24.0 ms a call, with fewer
  instructions a lookup as well as fewer bank passes; the code rows'
  loads through L1 are the next bound, as ``csrc/pq_scan.cu`` says.
- :func:`ivf_pq_scan_wide` launches the wide route, for rows whose
  codebook does not fit in shared memory beside K7's table (gist-960's
  M 96 x 256 codewords of 10 dimensions is 983 KB): each table entry in
  the expanded form, a list's terms ``|w|^2 + 2 c.w`` made once an index
  for every list in device memory (:func:`wide_terms`), a query's
  ``-2 q.w`` once a query in shared memory, ``|q - c|^2`` a subspace once
  a (query, probe); the table read in 32 banks by the same rule, on rows
  of 32, 64 or 96 bytes (``csrc/pq_scan_wide.cu``).
- :func:`ivf_pq_scan_plain` is the step loop of ``spatial/ann.py``: the
  tables of a chunk of queries by one batched product
  (``ann._pq_tables``, the expanded form), then one step a probed slot,
  its table values gathered by the codes, summed, and merged into the
  running top-kk by ``select_k`` (ties to the earlier step).  It is the
  route of every CPU call, and of a CUDA call neither kernel takes.

The legality rules, from what a call can observe: :func:`takes` (K7) and
:func:`takes_wide` (the wide route) need CUDA float32 queries, centroids
and codebooks and kk <= 512.  K7 (:func:`fits`) takes M <= 64, a
power-of-two codebook of at most 256 codewords, d <= 512, and its shared
memory (:func:`smem_bytes`: the whole codebook, d x ksub floats, beside
a 64 KB table, the sort area and each probe's slots) within Hopper's
227 KB: at 256 codewords d <= 145 at most.  The wide route
(:func:`fits_wide`) takes M <= 96, at most 256 codewords of any
dimension, any d, and its shared memory (:func:`smem_bytes_wide`: two
tables of ksub x 32, 64 or 96 floats, the sort area and each probe's
slots) within 227 KB: at M 96 and 256 codewords nprobe x (1 + slots a
list) <= 4,752, more than K7 admits at d 128.  The search prefers K7
where both fit.  Neither takes M above 96, more than 256 codewords, kk
above 512, probes whose slot lists outgrow the shared memory, float64 or
half queries, or CPU tensors: those go to the step scan.  The routes
sum in another order and build their tables in another form (direct
differences in K7, the expanded form in the wide route and the plain
version), so distances agree to float32 rounding and ids up to ADC ties.
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
# csrc/pq_scan_wide.cu: the most subspaces, the code row widths and the
# most codewords of the wide route (its kk and sort area are K7's)
MAX_M_WIDE = 96
WIDE_CODE_BYTES = (32, 64, 96)
MAX_KSUB_WIDE = 256


def smem_bytes(d: int, ksub: int, nprobe: int, max_slots: int) -> int:
    """Dynamic shared memory of a launch (``smem_bytes`` in the source):
    the sort area's 2,048 8-byte keys, the codebooks, the table, the
    query and its residual, and each probe's row count and slots."""
    return (8 * SORT_AREA + 4 * (d * ksub + TABLE_FLOATS + 2 * d)
            + 4 * nprobe * (1 + max_slots))


def smem_bytes_wide(M: int, ksub: int, nprobe: int, max_slots: int) -> int:
    """Dynamic shared memory of a wide launch (``smem_bytes`` in
    ``csrc/pq_scan_wide.cu``): the sort area, the table and the query's
    terms (ksub rows of the code row's width in floats each), the residual
    norms, and each probe's row count and slots."""
    w = code_bytes(M, wide=True)
    return 8 * SORT_AREA + 4 * (2 * ksub * w + w) + 4 * nprobe * (1 + max_slots)


def code_bytes(M: int, wide: bool = False) -> int:
    """Bytes of a narrowed code row: M rounded up to a width K7 (the wide
    route with ``wide``) is built for."""
    widths = WIDE_CODE_BYTES if wide else CODE_BYTES
    expects(0 < M <= widths[-1], "code_bytes: M=%d subspaces outgrow the widest %scode row, "
            "%d bytes", M, "wide " if wide else "", widths[-1])
    return next(b for b in widths if M <= b)


def fits(d: int, M: int, ksub: int, kk: int, nprobe: int, max_slots: int) -> bool:
    """The shapes the kernel is built for (module doc)."""
    return (M <= MAX_M and ksub & (ksub - 1) == 0 and ksub <= 256 and d <= MAX_D
            and 0 < kk <= MAX_KK and smem_bytes(d, ksub, nprobe, max_slots) <= SMEM_LIMIT)


def fits_wide(M: int, ksub: int, kk: int, nprobe: int, max_slots: int) -> bool:
    """The shapes the wide route is built for (module doc)."""
    return (0 < M <= MAX_M_WIDE and 0 < ksub <= MAX_KSUB_WIDE and 0 < kk <= MAX_KK
            and smem_bytes_wide(M, ksub, nprobe, max_slots) <= SMEM_LIMIT)


def _cuda_float32(queries, centroids, codebooks) -> bool:
    return (queries.device.type == "cuda"
            and all(t.dtype == torch.float32 for t in (queries, centroids, codebooks)))


def takes(queries: torch.Tensor, centroids: torch.Tensor, codebooks: torch.Tensor, kk: int,
          nprobe: int, max_slots: int) -> bool:
    """K7's legality rule (module doc): whether :func:`ivf_pq_scan` takes
    a call with these operands."""
    M, ksub, _ = codebooks.shape
    return (_cuda_float32(queries, centroids, codebooks)
            and fits(queries.shape[1], M, ksub, kk, nprobe, max_slots))


def takes_wide(queries: torch.Tensor, centroids: torch.Tensor, codebooks: torch.Tensor, kk: int,
               nprobe: int, max_slots: int) -> bool:
    """The wide route's legality rule (module doc): whether
    :func:`ivf_pq_scan_wide` takes a call with these operands."""
    M, ksub, _ = codebooks.shape
    return (_cuda_float32(queries, centroids, codebooks)
            and fits_wide(M, ksub, kk, nprobe, max_slots))


def narrow_codes(slot_codes: torch.Tensor, wide: bool = False) -> torch.Tensor:
    """The index's (S, cap, M) codes as K7 reads them: (S * cap,
    :func:`code_bytes`) uint8 rows, zero past M.  With ``wide``, as the
    wide route reads them: the same rows chunk-major, (code_bytes / 16, S
    * cap, 16), a row's 16-byte chunks a plane apart (:func:`code_rows`
    undoes it).  The codes are k-means labels below the codebook size, 256
    at most."""
    S, cap, M = slot_codes.shape
    width = code_bytes(M, wide)
    rows = slot_codes.reshape(S * cap, M)
    if wide and width == M:     # one copy, narrowing and transposing at once
        out = torch.empty((width // 16, S * cap, 16), dtype=torch.uint8, device=rows.device)
        return out.copy_(rows.reshape(S * cap, width // 16, 16).transpose(0, 1))
    if width == M:
        return rows.to(torch.uint8)
    out = torch.zeros((S * cap, width), dtype=torch.uint8, device=rows.device)
    out[:, :M] = rows
    if wide:
        return out.reshape(S * cap, width // 16, 16).transpose(0, 1).contiguous()
    return out


def code_rows(codes: torch.Tensor) -> torch.Tensor:
    """:func:`narrow_codes`' codes, K7's or the wide route's, as (S * cap,
    code_bytes) rows."""
    if codes.ndim == 3:
        return codes.transpose(0, 1).reshape(codes.shape[1], -1)
    return codes


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
    and int32 ids.  CUDA tensors launch K7 (a call it does not take
    raises); CPU tensors take :func:`ivf_pq_scan_plain`."""
    return _scan("pq_scan", queries, centroids, codebooks, codes, slot_ids, cent_slots, probes,
                 kk)


def ivf_pq_scan_wide(queries: torch.Tensor, centroids: torch.Tensor, codebooks: torch.Tensor,
                     codes: torch.Tensor, terms: torch.Tensor, slot_ids: torch.Tensor,
                     cent_slots: torch.Tensor, probes: torch.Tensor,
                     kk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """As :func:`ivf_pq_scan`, on the wide route (module doc): codes the
    ``narrow_codes(..., wide=True)`` of the index's codes, terms the
    :func:`wide_terms` of its centroids and codebooks (which CPU tensors
    do not read)."""
    return _scan("pq_scan_wide", queries, centroids, codebooks, codes, slot_ids, cent_slots,
                 probes, kk, terms)


def wide_terms(centroids: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """The wide route's list terms of an index, ``|w|^2 + 2 c_m.w`` for
    every list, codeword and subspace.  They depend on the centroids
    (nlist, d) and codebooks (M, ksub, dsub) alone, so a search makes
    them once an index (``spatial/ann.py``).  CUDA tensors launch the
    terms kernel of ``csrc/pq_scan_wide.cu``: (nlist, ksub, code_bytes)
    float32 (:func:`code_bytes` with ``wide``), a subspace at its column
    of the table's layout, 0 past M.  CPU tensors give them plainly,
    (nlist, ksub, M)."""
    M, ksub, dsub = codebooks.shape
    nlist, d = centroids.shape
    expects(M * dsub == d, "wide_terms: centroids and codebooks must span d=%d", d)
    if centroids.device.type == "cpu":
        cw = torch.einsum("lmi,mji->ljm", centroids.reshape(nlist, M, dsub), codebooks)
        return (codebooks * codebooks).sum(dim=-1).T[None] + 2.0 * cw
    _build.load("pq_scan_wide")     # built or loaded before any work on the device
    expects(centroids.dtype == codebooks.dtype == torch.float32
            and codebooks.device == centroids.device and 0 < ksub <= MAX_KSUB_WIDE,
            "wide_terms: float32 centroids and codebooks of at most %d codewords on one device "
            "required", MAX_KSUB_WIDE)
    width = code_bytes(M, wide=True)
    args = [centroids.contiguous(), codebooks.transpose(1, 2).contiguous()]
    terms = torch.empty((nlist, ksub, width), dtype=torch.float32, device=centroids.device)
    _build.launch("pq_scan_wide", centroids.device, (*args, nlist, d, M, ksub, dsub, width, terms),
                  "wide_terms", (nlist, d, M, ksub), lambda: (
                      4.0 * nlist * ksub * d, 4.0 * (nlist * d + d * ksub + terms.numel()),
                      inventory.footprint(args, (terms,))),
                  kernel="pq_scan_wide_terms")
    return terms


def _scan(name, queries, centroids, codebooks, codes, slot_ids, cent_slots, probes, kk,
          terms=None):
    """The launch of K7 (``name`` ``"pq_scan"``) or of the wide route
    (``"pq_scan_wide"``, with its ``terms``) after the checks both share;
    CPU tensors take :func:`ivf_pq_scan_plain`."""
    if queries.device.type == "cpu":
        S, cap = slot_ids.shape
        return ivf_pq_scan_plain(queries, centroids, codebooks,
                                 code_rows(codes).reshape(S, cap, -1), slot_ids, cent_slots,
                                 probes, kk)
    wide = name == "pq_scan_wide"
    _build.load(name)           # built or loaded before any work on the device
    nq, d = queries.shape
    M, ksub, dsub = codebooks.shape
    S, cap = slot_ids.shape
    nlist, max_slots = cent_slots.shape
    nprobe = probes.shape[1]
    rule = takes_wide if wide else takes
    expects(rule(queries, centroids, codebooks, kk, nprobe, max_slots),
            "%s: the kernel does not take d=%d M=%d ksub=%d kk=%d nprobe=%d max_slots=%d "
            "(%s queries)", name, d, M, ksub, kk, nprobe, max_slots, queries.dtype)
    expects(centroids.shape[1] == d and M * dsub == d,
            "%s: centroids and codebooks must span d=%d", name, d)
    width = code_bytes(M, wide)
    shape = (width // 16, S * cap, 16) if wide else (S * cap, width)
    expects(codes.dtype == torch.uint8 and tuple(codes.shape) == shape,
            "%s: codes must be narrow_codes' %s uint8", name, shape)
    expects(not wide or (terms.dtype == torch.float32
                         and tuple(terms.shape) == (nlist, ksub, width)),
            "%s: terms must be wide_terms' (%d, %d, %d) float32", name, nlist, ksub, width)
    expects(slot_ids.dtype == torch.int32 and cent_slots.dtype == torch.int32
            and probes.dtype == torch.int32 and probes.shape[0] == nq,
            "%s: int32 ids, slots and (nq, nprobe) probes required", name)
    expects(S * cap < 2**31, "%s: store rows overflow int32", name)
    dev = queries.device
    expects(all(t.device == dev for t in (centroids, codebooks, codes, slot_ids, cent_slots,
                                          probes) + ((terms,) if wide else ())),
            "%s: inputs on different devices", name)
    out_d = torch.empty((nq, kk), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, kk), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_i
    # the wide route reads the codebooks as (M, dsub, ksub), its list
    # terms, and the store's row count
    books = codebooks.transpose(1, 2) if wide else codebooks
    args = [t.contiguous() for t in (queries, centroids, books)
            + ((terms,) if wide else ()) + (codes, slot_ids, cent_slots, probes)]
    next_query = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = (S * cap,) if wide else ()
    _build.launch(name, dev, (*args, nq, d, M, ksub, dsub, cap, *rows, max_slots, nlist, nprobe,
                              kk, width, next_query, out_d, out_i),
                  "ivf_" + name, (nq, d, M, ksub, nprobe, kk, S, cap), lambda: (
                      *scan_cost(slot_ids, cent_slots, probes, d, ksub, M, kk),
                      inventory.footprint(args, (out_d, out_i))))
    return out_d, out_i


def wide_table_read_bytes(nq: int, d: int, ksub: int, M: int, nprobe: int) -> int:
    """A model, from the launch geometry and not measured: the
    device-memory bytes a wide launch reads to build its tables.  Each
    query reads its row and the codebooks (its own terms); each (query,
    probe) reads the list's terms (ksub rows of the code row's width) and
    the list's centroid (the residual norms).  The list terms, made once
    an index (:func:`wide_terms`), are not counted."""
    width = code_bytes(M, wide=True)
    return nq * 4 * (d * ksub + d + nprobe * (ksub * width + d))


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
