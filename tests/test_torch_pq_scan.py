"""K7, the IVF-PQ ADC scan (``raft_tpu_torch/ops/pq_scan.py``).

On the CPU: the legality rule (which shapes route to the kernel), the
search's route glue with the rule forced (the kernel's place taken by
the plain version, which a CPU tensor gets), the narrowed codes, the
kernel route's chunk bytes and the counters' names.

On the card (marked ``card``; this file imports no JAX, so run it there
with ``python -m pytest tests/test_torch_pq_scan.py -m card
--noconftest``): the kernel against its plain version on indexes with
uneven lists and vacant rows, at M 64 (2 dimensions a subspace), M 16
(8), M 32 and M 8 with 4-bit codes, kk 10, 40, 200 and 512, and with
probes that hold fewer rows than kk; the search bitwise the same in 1, 3
and 16 chunks; the launch and chunk counts; the shared-memory limit of
the legality rule at its edge; and a call the kernel does not take
raising.
"""

import pytest
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.ops import _build, cost, pq_scan
from raft_tpu_torch.spatial import ann


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


# --------------------------------------------------------------------- #
# the CPU
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,routed", [
    ((128, 64, 256, 200, 50, 4), True),      # the sift1m_ivfpq cell
    ((128, 16, 256, 40, 32, 4), True),       # chip_smoke's ivf_pq_1M, refined
    ((128, 16, 256, 10, 32, 4), True),       # and unrefined
    ((128, 16, 256, 400, 32, 4), True),      # its served arm, k 100 x refine 4
    ((128, 64, 256, 512, 50, 4), True),      # the widest kk
    ((128, 64, 256, 513, 50, 4), False),
    ((128, 128, 256, 200, 50, 4), False),    # more subspaces than a code row
    ((128, 64, 512, 200, 50, 4), False),     # 9-bit codes
    ((16, 8, 48, 10, 4, 2), False),          # not a power of two
    ((256, 64, 256, 200, 50, 4), False),     # the codebooks outgrow shared memory
    ((16, 8, 256, 10, 4, 2), True),
    ((128, 64, 256, 200, 1024, 40), False),  # the probes' slot lists outgrow it
])
def test_legality_rule(shape, routed):
    d, M, ksub, kk, nprobe, max_slots = shape
    assert pq_scan.fits(d, M, ksub, kk, nprobe, max_slots) is routed


def test_cpu_tensors_never_take_the_kernel():
    q = torch.zeros(4, 16)
    assert not pq_scan.takes(q, torch.zeros(8, 16), torch.zeros(8, 256, 2), 10, 4, 2)


def test_pq_counters_keep_their_names():
    assert ann.PQ_COUNTERS == ("ivf_pq_search.chunks", "ivf_pq_search.steps",
                               "ivf_pq_search.table_bytes")
    assert ann.PQ_KERNEL_CHUNKS == "ivf_pq_search.kernel_chunks"
    assert ann.PQ_KERNEL_CHUNKS not in ann.PQ_COUNTERS


@pytest.mark.parametrize("M,width", [(8, 16), (16, 16), (24, 32), (64, 64)])
def test_narrow_codes(M, width):
    g = torch.Generator().manual_seed(M)
    codes = torch.randint(0, 256, (5, 7, M), generator=g, dtype=torch.int32)
    got = pq_scan.narrow_codes(codes)
    assert got.dtype == torch.uint8 and got.shape == (35, width)
    assert torch.equal(got[:, :M].to(torch.int32), codes.reshape(35, M))
    assert not got[:, M:].any()


def test_kernel_route_chunk_bytes():
    # the cell's shape: the re-rank's three (kk, d) arrays set the peak
    assert ann.pq_query_bytes(50, 64, 256, 984, 200, 128, True, kernel=True) == (
        3 * 4 * 200 * 128 + 16 * 200)
    assert ann.pq_query_bytes(50, 64, 256, 984, 10, 128, False, kernel=True) == 80
    rows = ann._pq_chunk_rows(10000, 100, 50,
                              ann.pq_query_bytes(50, 64, 256, 984, 200, 128, True, kernel=True))
    assert rows == 10000


@pytest.fixture(scope="module")
def small_index():
    g = torch.Generator().manual_seed(3)
    centres = torch.randn(6, 16, generator=g) * 3.0
    # uneven lists: blob sizes 1:2:...:6
    pick = torch.multinomial(torch.arange(1.0, 7.0), 1500, replacement=True, generator=g)
    x = centres[pick] + 0.5 * torch.randn(1500, 16, generator=g)
    q = centres[torch.randint(6, (60,), generator=g)] + 0.5 * torch.randn(60, 16, generator=g)
    params = ann.IVFPQParams(nlist=12, nprobe=3, M=8, n_bits=8, refine_ratio=2)
    return ann.ivf_pq_build(x, params, DistanceType.L2SqrtExpanded, seed=2, device="cpu"), q


@pytest.mark.parametrize("refine_ratio", [1, 2])
def test_kernel_route_glue_on_the_cpu(small_index, refine_ratio, monkeypatch):
    """With the rule forced, the search takes K7's route: the codes
    narrowed once, one scan a chunk, no step counted; on CPU tensors the
    wrapper hands the call to the plain version, so the answers are the
    step route's, bit for bit."""
    index, q = small_index
    step = ann.ivf_pq_search(index, q, 5, refine_ratio=refine_ratio, device="cpu")
    monkeypatch.setattr(pq_scan, "takes", lambda *args: True)
    names = ann.PQ_COUNTERS + (ann.PQ_KERNEL_CHUNKS,)
    before = [tracing.get_counter(c) for c in names]
    got = ann.ivf_pq_search(index, q, 5, refine_ratio=refine_ratio, device="cpu")
    chunks, steps, table_bytes, kernel_chunks = (
        tracing.get_counter(c) - b for c, b in zip(names, before))
    assert torch.equal(got[0], step[0]) and torch.equal(got[1], step[1])
    assert chunks == kernel_chunks == 1 and steps == 0
    assert table_bytes == len(q) * 3 * 8 * 256 * 4


def test_step_route_counts_no_kernel_chunk(small_index):
    index, q = small_index
    before = tracing.get_counter(ann.PQ_KERNEL_CHUNKS)
    steps = tracing.get_counter(ann.PQ_COUNTERS[1])
    ann.ivf_pq_search(index, q, 5, device="cpu")
    assert tracing.get_counter(ann.PQ_KERNEL_CHUNKS) == before
    assert tracing.get_counter(ann.PQ_COUNTERS[1]) > steps


def test_wrapper_on_the_cpu_is_the_plain_version(small_index):
    index, q = small_index
    _, probes = ann.select_k(ann.expanded_sq_dists(q, index.centroids), 3, select_min=True,
                             device="cpu")
    args = (q, index.centroids, index.codebooks)
    got = pq_scan.ivf_pq_scan(*args, pq_scan.narrow_codes(index.slot_codes), index.slot_ids,
                              index.cent_slots, probes, 10)
    ref = pq_scan.ivf_pq_scan_plain(*args, index.slot_codes, index.slot_ids, index.cent_slots,
                                    probes, 10)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert bool((got[0][:, 1:] >= got[0][:, :-1]).all())


def test_scan_cost_counts_the_probed_rows(small_index):
    index, q = small_index
    probes = torch.tensor([[0, 1], [1, 2]], dtype=torch.int32)
    sizes = index.list_sizes.long()
    ops, nbytes = pq_scan.scan_cost(index.slot_ids, index.cent_slots, probes, 16, 256, 8, 10)
    scanned = int(sizes[[0, 1, 1, 2]].sum())
    distinct = int(sizes[[0, 1, 2]].sum())
    assert (ops, nbytes) == cost.pq_scan_cost(2, 16, 256, 8, 2, 10, scanned, distinct)
    assert ops == 2.0 * 16 * 2 * 2 * 256 + 8 * scanned


# --------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------- #
def _mixture(n, d, dev, seed):
    """Rows of 40 blobs of sizes 1:2:...:40 (uneven lists), and a far,
    small blob of 30 rows: a query there probes lists of fewer than kk
    rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    centres = torch.randn(40, d, device=dev, generator=g)
    pick = torch.multinomial(torch.arange(1.0, 41.0, device=dev), n - 30, replacement=True,
                             generator=g)
    x = centres[pick] + 0.5 * torch.randn(n - 30, d, device=dev, generator=g)
    far = 20.0 + 0.1 * torch.randn(30, d, device=dev, generator=g)
    return torch.cat([x, far]), centres, g


# (M, bits) at d 128: the cell's subspaces of 2 dimensions and chip_smoke's
# of 8 (the kernel's unrolled table builds), and two shapes of its generic
# build: 32-byte code rows, and 4-bit codes in rows padded to 16 bytes
SHAPES = {"M64": (64, 8), "M16": (16, 8), "M32": (32, 8), "M8x4bit": (8, 4)}


@pytest.fixture(scope="module")
def card_indexes():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    dev = torch.device("cuda")
    x, centres, g = _mixture(40_000, 128, dev, 5)
    q = centres[torch.randint(40, (300,), device=dev, generator=g)] + 0.5 * torch.randn(
        300, 128, device=dev, generator=g)
    q = torch.cat([q, 20.0 + 0.1 * torch.randn(4, 128, device=dev, generator=g)])
    out = {}
    for name, (M, bits) in SHAPES.items():
        params = ann.IVFPQParams(nlist=96, nprobe=8, M=M, n_bits=bits, refine_ratio=2)
        out[name] = ann.ivf_pq_build(x, params, DistanceType.L2SqrtExpanded, seed=7,
                                     device=dev)
    return out, q


def _probes(index, q, nprobe):
    _, probes = ann.select_k(ann.expanded_sq_dists(q, index.centroids), nprobe,
                             select_min=True, device=q.device)
    return probes


def _assert_matches_plain(got, ref, rtol_d=1e-5, rtol_tie=1e-6):
    """Distances rank by rank within ``rtol_d`` of the plain version's;
    ids the same sets, but for rows whose ADC distance ties the kk-th
    within ``rtol_tie``; (+inf, -1) where the plain version has them."""
    gd, gi, rd, ri = (t.cpu() for t in (*got, *ref))
    assert torch.equal(gi < 0, ri < 0) and bool(torch.isinf(gd[gi < 0]).all())
    fin = ri >= 0
    scale = rd.where(fin, 0.0).amax(dim=1, keepdim=True).clamp(min=1e-30)
    err = ((gd - rd).abs() / scale).where(fin, 0.0)
    assert float(err.max()) <= rtol_d, float(err.max())
    assert bool((gd[:, 1:] >= gd[:, :-1]).where(fin[:, 1:], True).all())
    for r in range(len(gi)):
        a, b = set(gi[r][gi[r] >= 0].tolist()), set(ri[r][ri[r] >= 0].tolist())
        assert len(a) == int((gi[r] >= 0).sum()), "row %d: an id twice" % r
        if a == b:
            continue
        kth = float(rd[r][fin[r]][-1])
        for i in a ^ b:
            dist = float(gd[r][gi[r] == i][0]) if i in a else float(rd[r][ri[r] == i][0])
            assert abs(dist - kth) <= rtol_tie * max(kth, 1e-30), (r, i, dist, kth)


@pytest.mark.card
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kk", [10, 40, 200, 512])
@pytest.mark.parametrize("nprobe", [1, 8])
def test_kernel_matches_plain(card, card_indexes, shape, kk, nprobe):
    indexes, q = card_indexes
    index = indexes[shape]
    probes = _probes(index, q, nprobe)
    args = (q, index.centroids, index.codebooks)
    before = pq_scan.ivf_pq_scan.launches
    got = pq_scan.ivf_pq_scan(*args, pq_scan.narrow_codes(index.slot_codes), index.slot_ids,
                              index.cent_slots, probes, kk)
    torch.cuda.synchronize()
    assert pq_scan.ivf_pq_scan.launches == before + 1
    ref = pq_scan.ivf_pq_scan_plain(*args, index.slot_codes, index.slot_ids, index.cent_slots,
                                    probes, kk)
    _assert_matches_plain(got, ref)
    if nprobe == 1 and kk == 512:
        # the far queries' lists hold fewer rows than kk
        assert bool((got[1][-4:] < 0).any())


@pytest.mark.card
@pytest.mark.parametrize("M", [64, 16])
@pytest.mark.parametrize("refine_ratio", [1, 2])
def test_search_bitwise_whatever_the_chunks(card, card_indexes, M, refine_ratio, monkeypatch):
    indexes, q = card_indexes
    index, k, nprobe = indexes["M%d" % M], 100, 8
    kk = k * refine_ratio
    per = ann.pq_query_bytes(nprobe, M, 256, index.slot_ids.shape[1], kk, 128,
                             refine_ratio > 1, kernel=True)
    nq = len(q)
    got = {}
    for chunks in (1, 3, 16):
        budget = nq * (4 * nprobe + 8 * k) + per * -(-nq // chunks)
        monkeypatch.setattr(ann, "PQ_BUDGET_BYTES", budget)
        names = ann.PQ_COUNTERS + (ann.PQ_KERNEL_CHUNKS,)
        before = [tracing.get_counter(c) for c in names]
        got[chunks] = ann.ivf_pq_search(index, q, k, nprobe, refine_ratio, device=card)
        torch.cuda.synchronize()
        counted = [tracing.get_counter(c) - b for c, b in zip(names, before)]
        assert counted[0] == counted[3] == chunks and counted[1] == 0, counted
    for chunks in (3, 16):
        assert torch.equal(got[chunks][0], got[1][0]) and torch.equal(got[chunks][1], got[1][1])


@pytest.mark.card
def test_shared_memory_limit(card, card_indexes):
    """At the most probe slots the rule admits the kernel launches and
    answers as with the index's own slot table (the columns added are
    -1); one column more and it raises."""
    indexes, q = card_indexes
    index = indexes["M64"]
    probes = _probes(index, q, 8)
    nlist, max_slots = index.cent_slots.shape
    widest = max(w for w in range(max_slots, 4096)
                 if pq_scan.fits(128, 64, 256, 200, 8, w))
    pad = torch.full((nlist, widest - max_slots), -1, dtype=torch.int32, device=card)
    codes = pq_scan.narrow_codes(index.slot_codes)
    args = (q, index.centroids, index.codebooks, codes, index.slot_ids)
    ref = pq_scan.ivf_pq_scan(*args, index.cent_slots, probes, 200)
    got = pq_scan.ivf_pq_scan(*args, torch.cat([index.cent_slots, pad], dim=1), probes, 200)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert pq_scan.smem_bytes(128, 256, 8, widest) <= pq_scan.SMEM_LIMIT
    with pytest.raises(LogicError):
        pq_scan.ivf_pq_scan(*args, torch.cat([index.cent_slots, pad, pad[:, :1]], dim=1),
                            probes, 200)


@pytest.mark.card
def test_call_the_kernel_does_not_take_raises(card, card_indexes):
    indexes, q = card_indexes
    index = indexes["M64"]
    probes = _probes(index, q, 8)
    codes = pq_scan.narrow_codes(index.slot_codes)
    with pytest.raises(LogicError):
        pq_scan.ivf_pq_scan(q, index.centroids, index.codebooks, codes, index.slot_ids,
                            index.cent_slots, probes, pq_scan.MAX_KK + 1)
    with pytest.raises(LogicError):
        pq_scan.ivf_pq_scan(q.double(), index.centroids, index.codebooks, codes,
                            index.slot_ids, index.cent_slots, probes, 10)
    assert "pq_scan" in _build.KERNELS
