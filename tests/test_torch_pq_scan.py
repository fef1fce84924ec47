"""K7, the IVF-PQ ADC scan, and its wide-row route
(``raft_tpu_torch/ops/pq_scan.py``).

On the CPU: the legality rules (which shapes route to which kernel), the
search's route glue with the rule forced (the kernel's place taken by
the plain version, which a CPU tensor gets), the narrowed codes, the
kernel route's chunk bytes, the counters' names, and the table's bank
rule at code rows of 16, 32 and 64 bytes: ``csrc/pq_layout.cuh``, the
kernel's own layout functions, compiled on the host with ``g++`` (at
every step of the scan a warp's 32 lanes read 32 banks and each lane
sums each subspace of its row once; the build's stores and codebook
reads fall in 32 banks, and its reads stay below M whatever M is); the
same for the wide route's rows of 32, 64 and 96 bytes, its route glue
and counters, and the bytes its tables read.

On the card (marked ``card``; this file imports no JAX, so run it there
with ``python -m pytest tests/test_torch_pq_scan.py -m card
--noconftest``): the kernel against its plain version on indexes with
uneven lists and vacant rows, at M 64 (2 dimensions a subspace), M 16
(8), M 32 and M 8 with 4-bit codes at d 128, and at fewer subspaces
than the code row is wide (M 48 and 24 of 2 dimensions, M 12 and 8 of
8), kk 10, 40, 200, 400 and 512, and with probes that hold fewer rows
than kk; on lists whose rows straddle
slot boundaries at every lane offset, with vacant rows, at M 64, 32 and
16; the search bitwise the same in 1, 3 and 16 chunks; the launch and
chunk counts; the shared-memory limit of the legality rule at its edge;
and a call the kernel does not take raising.  The wide route against
the plain version at d 960 / M 96 (gist-960's shape), d 256 / M 32, d 768
/ M 96, d 960 / M 80 and M 48 (rows of 96, 32, 96, 96 and 64 bytes), kk
10, 200 and 512, on lists across slot boundaries, at the most slots its
rule admits, bitwise whatever the chunks; the sift1m_ivfpq cell's shape
still on K7.
"""

import gc
import json
import shutil
import subprocess

import pytest
import torch
from torch.utils.weak import WeakIdKeyDictionary

from raft_tpu_torch.core import inventory, tracing
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.ops import _build, cost, pq_scan
from raft_tpu_torch.spatial import ann

BANKS = 32  # shared-memory banks of 4 bytes

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


# --------------------------------------------------------------------- #
# the table's layout and each lane's walk over it (the bank rule), from
# the kernel's own csrc/pq_layout.cuh built on the host
# --------------------------------------------------------------------- #
_LAYOUT_DUMP = r"""
#include <cstdio>
#include "pq_layout.cuh"
using namespace raft_tpu_torch::pq_layout;
template <int NCH>
void dump() {
  const int width = 16 * NCH;
  std::printf("{\"width\": %d, \"copies\": %d, \"column\": [", width, kCopies<NCH>);
  for (int m = 0; m < width; ++m)
    for (int c = 0; c < kCopies<NCH>; ++c)
      std::printf("%s%s%d%s", m || c ? ", " : "", c ? "" : "[", table_column<NCH>(m, c),
                  c + 1 == kCopies<NCH> ? "]" : "");
  std::printf("], \"subspace\": [");
  for (int col = 0; col < kColumns; ++col)
    std::printf("%s%d", col ? ", " : "", column_subspace<NCH>(col));
  std::printf("], \"walk\": [");
  for (int lane = 0; lane < 32; ++lane)
    for (int p = 0; p < width; ++p)
      std::printf("%s%s[%d, %d]%s", lane || p ? ", " : "", p ? "" : "[", walk_byte<NCH>(p, lane),
                  table_column<NCH>(p, 0) ^ lane, p + 1 == width ? "]" : "");
  std::printf("], \"build\": [");
  for (int lane = 0; lane < 32; ++lane)
    std::printf("%s[%d, %d]", lane ? ", " : "", build_subspace<NCH>(lane, false),
                build_subspace<NCH>(lane, true));
  std::printf("], \"reads\": [");
  for (int M = 1; M <= width; ++M)
    for (int lane = 0; lane < 32; ++lane)
      std::printf("%s%s[%d, %d]%s", M > 1 || lane ? ", " : "", lane ? "" : "[",
                  build_reads<NCH>(lane, false, M), build_reads<NCH>(lane, true, M),
                  lane == 31 ? "]" : "");
  std::printf("]}\n");
}
int main() {
  dump<1>();
  dump<2>();
  dump<4>();
}
"""


def _host_dump(tmp_path_factory, source: str) -> dict:
    """``source`` built with ``g++`` against ``csrc/`` and run: each line
    it prints, a JSON object, by its ``width``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine")
    d = tmp_path_factory.mktemp("pq_layout")
    (d / "dump.cpp").write_text(source)
    subprocess.run([gxx, "-std=c++17", "-I", str(_build.CSRC), "-o", str(d / "dump"),
                    str(d / "dump.cpp")], check=True, capture_output=True)
    out = subprocess.run([str(d / "dump")], check=True, capture_output=True, text=True).stdout
    return {lay["width"]: lay for lay in map(json.loads, out.splitlines())}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """What ``csrc/pq_layout.cuh`` says for each code width: the copies,
    ``column[m][c]``, ``subspace[col]``, ``walk[lane][step]`` (the byte
    of its row and the column a lane reads), ``build[lane]`` (the
    subspaces a build lane stores, its own and its sibling's) and
    ``reads[M - 1][lane]`` (the subspaces whose codebooks it reads)."""
    return _host_dump(tmp_path_factory, _LAYOUT_DUMP)


@pytest.mark.parametrize("width,copies", [(16, 2), (32, 1), (64, 1)])
def test_table_columns_are_distinct(layouts, width, copies):
    layout = layouts[width]
    assert layout["copies"] == copies
    cols = [col for row in layout["column"] for col in row]
    assert len(cols) == width * copies == len(set(cols))
    assert all(0 <= col < pq_scan.TABLE_FLOATS // 256 for col in cols)
    assert all(layout["subspace"][col] == m for m, row in enumerate(layout["column"])
               for col in row)


@pytest.mark.parametrize("width", pq_scan.CODE_BYTES)
def test_every_step_reads_32_banks(layouts, width):
    walk = layouts[width]["walk"]
    for step in range(width):
        assert len({walk[lane][step][1] % BANKS for lane in range(32)}) == 32, step


@pytest.mark.parametrize("width", pq_scan.CODE_BYTES)
@pytest.mark.parametrize("lane", range(32))
def test_lane_reads_each_subspace_once(layouts, width, lane):
    """Lane ``lane`` sums every byte of its row once, each from the column
    of that byte's subspace, all in one copy."""
    layout = layouts[width]
    walk = layout["walk"][lane]
    assert sorted(byte for byte, _ in walk) == list(range(width))
    assert all(layout["subspace"][col] == byte for byte, col in walk)
    copy = {c: k for row in layout["column"] for k, c in enumerate(row)}
    assert len({copy[col] for _, col in walk}) == 1


@pytest.mark.parametrize("width", pq_scan.CODE_BYTES)
def test_build_stores_and_reads_32_banks(layouts, width):
    """The build (``csrc/pq_scan.cu:build_table``): lane l takes column l,
    and column l + 32 where a row has 64 columns, its subspace and copy,
    and codeword l + t mod 32 of a block at step t < 32 / copies; each
    entry goes to every copy.  Each store and each codebook read of a warp
    falls in 32 banks, and every (column, codeword) of the block is
    written once."""
    layout = layouts[width]
    copies, column = layout["copies"], layout["column"]
    owner = {col: (m, c) for m, row in enumerate(column) for c, col in enumerate(row)}
    homes = [[lane + 32 * h for lane in range(32)] for h in range(len(owner) // 32)]
    written = {}
    for cols in homes:
        for t in range(32 // copies):
            assert len({(lane + t) % 32 for lane in range(32)}) == 32
            for k in range(copies):
                banks = set()
                for lane, col in enumerate(cols):
                    m, c = owner[col]
                    at = (column[m][c ^ k], (lane + t) % 32)
                    written[at] = written.get(at, 0) + 1
                    banks.add(at[0] % BANKS)
                assert len(banks) == 32
    assert len(written) == len(owner) * 32 and set(written.values()) == {1}


@pytest.mark.parametrize("width", pq_scan.CODE_BYTES)
def test_build_reads_no_subspace_past_M(layouts, width):
    """Whatever M a row of ``width`` bytes holds, a build lane reads the
    residual and codebook of its own subspace and its sibling's where
    they are below M, and of subspace 0 where not, so no read leaves the
    codebooks; and the lanes store every subspace."""
    layout = layouts[width]
    build = layout["build"]
    assert all(layout["subspace"][lane] == own for lane, (own, _) in enumerate(build))
    assert {m for pair in build for m in pair} == set(range(width))
    for M, reads in enumerate(layout["reads"], start=1):
        for (own, sib), (r_own, r_sib) in zip(build, reads):
            assert r_own == (own if own < M else 0) and r_sib == (sib if sib < M else 0)


# the wide route's layout (csrc/pq_layout.cuh, wide_*), built on the host
_WIDE_DUMP = r"""
#include <cstdio>
#include "pq_layout.cuh"
using namespace raft_tpu_torch::pq_layout;
int main() {
  for (int width = 32; width <= 96; width += 32) {
    std::printf("{\"width\": %d, \"column\": [", width);
    for (int m = 0; m < width; ++m) std::printf("%s%d", m ? ", " : "", wide_column(m));
    std::printf("], \"subspace\": [");
    for (int col = 0; col < width; ++col) std::printf("%s%d", col ? ", " : "", wide_subspace(col));
    std::printf("], \"walk\": [");
    for (int lane = 0; lane < 32; ++lane)
      for (int p = 0; p < width; ++p)
        std::printf("%s%s[%d, %d]%s", lane || p ? ", " : "", p ? "" : "[",
                    wide_walk_byte(p, lane), wide_walk_column(p, lane), p + 1 == width ? "]" : "");
    std::printf("]}\n");
  }
}
"""


@pytest.fixture(scope="module")
def wide_layouts(tmp_path_factory):
    """What ``csrc/pq_layout.cuh`` says for each wide row width:
    ``column[m]``, ``subspace[col]`` and ``walk[lane][step]`` (the byte of
    its row and the column a lane reads; a table row has ``width``
    floats)."""
    return _host_dump(tmp_path_factory, _WIDE_DUMP)


@pytest.mark.parametrize("width", pq_scan.WIDE_CODE_BYTES)
def test_wide_columns_are_a_permutation(wide_layouts, width):
    layout = wide_layouts[width]
    assert sorted(layout["column"]) == list(range(width))
    assert all(layout["subspace"][col] == m for m, col in enumerate(layout["column"]))


@pytest.mark.parametrize("width", pq_scan.WIDE_CODE_BYTES)
def test_wide_every_step_reads_32_banks(wide_layouts, width):
    """A table row is ``width`` floats, a multiple of 32, so an entry's
    bank is its column's mod 32 whatever its codeword."""
    walk = wide_layouts[width]["walk"]
    for step in range(width):
        assert len({walk[lane][step][1] % BANKS for lane in range(32)}) == 32, step


@pytest.mark.parametrize("width", pq_scan.WIDE_CODE_BYTES)
@pytest.mark.parametrize("lane", range(32))
def test_wide_lane_reads_each_subspace_once(wide_layouts, width, lane):
    layout = wide_layouts[width]
    walk = layout["walk"][lane]
    assert sorted(byte for byte, _ in walk) == list(range(width))
    assert all(layout["subspace"][col] == byte for byte, col in walk)


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
# the wide route on the CPU: its rule, the search's choice of route, its
# code rows, glue, counters and bytes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,routed", [
    ((96, 256, 200, 50, 90), True),       # gist1m_ivfpq: 96-byte rows of 10 dimensions
    ((96, 256, 200, 50, 94), True),       # the most slots a list at nprobe 50
    ((96, 256, 200, 50, 95), False),
    ((32, 256, 200, 50, 4), True),        # d 256 / M 32, which K7's codebook refuses
    ((80, 256, 200, 50, 4), True),        # M not a multiple of 16
    ((64, 256, 200, 50, 4), True),
    ((96, 256, 512, 50, 4), True),        # the widest kk
    ((96, 256, 513, 50, 4), False),
    ((97, 256, 200, 50, 4), False),       # more subspaces than the widest row
    ((96, 512, 200, 50, 4), False),       # 9-bit codes
    ((8, 48, 10, 4, 2), True),            # any codebook size up to 256
])
def test_wide_legality_rule(shape, routed):
    assert pq_scan.fits_wide(*shape) is routed


@pytest.mark.parametrize("d,M,kk,route", [
    (128, 64, 200, "kernel"),     # the sift1m_ivfpq cell stays on K7
    (128, 16, 400, "kernel"),
    (960, 96, 200, "wide"),       # the gist1m_ivfpq cell
    (960, 80, 200, "wide"),
    (768, 96, 200, "wide"),
    (256, 32, 200, "wide"),       # K7's codebook outgrows shared memory
    (256, 64, 200, "wide"),
    (960, 96, 513, "step"),
    (1280, 128, 200, "step"),     # more subspaces than either row
])
def test_search_route(d, M, kk, route, monkeypatch):
    """The first route whose rule takes the call, with the device and
    dtype half of the rules taken as met (CPU tensors never take a
    kernel)."""
    monkeypatch.setattr(pq_scan, "_cuda_float32", lambda *args: True)
    q, cent, books = torch.zeros(4, d), torch.zeros(16, d), torch.zeros(M, 256, d // M)
    assert ann._pq_route(q, cent, books, kk, 50, 4, DistanceType.L2SqrtExpanded) == route
    assert ann._pq_route(q, cent, books, kk, 50, 4, DistanceType.InnerProduct) == "step"


def test_cpu_tensors_never_take_the_wide_route():
    assert not pq_scan.takes_wide(torch.zeros(4, 960), torch.zeros(8, 960),
                                  torch.zeros(96, 256, 10), 200, 4, 2)


@pytest.mark.parametrize("M,wide,width", [(96, True, 96), (80, True, 96), (65, True, 96),
                                          (64, True, 64), (33, True, 64), (32, True, 32),
                                          (1, True, 32), (64, False, 64), (17, False, 32)])
def test_code_bytes(M, wide, width):
    assert pq_scan.code_bytes(M, wide) == width


@pytest.mark.parametrize("M,wide", [(65, False), (96, False), (97, True), (0, True)])
def test_code_bytes_past_the_widest_row_raises(M, wide):
    with pytest.raises(LogicError, match="code row"):
        pq_scan.code_bytes(M, wide)


@pytest.mark.parametrize("M,width", [(96, 96), (80, 96), (48, 64), (32, 32), (20, 32)])
def test_narrow_codes_wide(M, width):
    """The wide route's codes are chunk-major: chunk c of row r is
    ``got[c, r]``, the row's bytes 16 c to 16 c + 15; ``code_rows`` gives
    the rows back."""
    g = torch.Generator().manual_seed(M)
    codes = torch.randint(0, 256, (5, 7, M), generator=g, dtype=torch.int32)
    got = pq_scan.narrow_codes(codes, wide=True)
    assert got.dtype == torch.uint8 and got.shape == (width // 16, 35, 16)
    assert got.is_contiguous()
    rows = pq_scan.code_rows(got)
    assert rows.shape == (35, width)
    assert torch.equal(rows[:, :M].to(torch.int32), codes.reshape(35, M))
    assert not rows[:, M:].any()
    assert torch.equal(got[1, 4], rows[4, 16:32])
    k7 = pq_scan.narrow_codes(codes[..., :16])
    assert pq_scan.code_rows(k7) is k7


def test_wide_counters_keep_their_names():
    assert ann.PQ_WIDE_CHUNKS == "ivf_pq_search.wide_chunks"
    assert ann.PQ_TABLE_READS == ("ivf_pq_search.table_read_bytes",
                                  "ivf_pq_search.table_read_queries")
    assert not {ann.PQ_WIDE_CHUNKS, *ann.PQ_TABLE_READS} & {*ann.PQ_COUNTERS,
                                                           ann.PQ_KERNEL_CHUNKS}


def test_wide_table_read_bytes_by_hand():
    # gist1m_ivfpq's call: each of 1,000 queries reads its row and the
    # codebooks, and each of its 50 probes 256 rows of 96 floats and a
    # centroid; the list terms, made once an index, are not counted
    got = pq_scan.wide_table_read_bytes(1000, 960, 256, 96, 50)
    per_query = 4 * (960 * 256 + 960) + 50 * 4 * (256 * 96 + 960)
    assert got == 1000 * per_query
    assert 6.0e6 < got / 1000 < 6.2e6
    # M 80 reads the rows of 96 floats that its code rows are padded to
    assert pq_scan.wide_table_read_bytes(1, 960, 256, 80, 1) == got / 1000 - 49 * 4 * (
        256 * 96 + 960)


def test_wide_route_chunk_bytes():
    """A wide chunk holds a query's candidates and re-rank, as K7's does
    (the list terms are the index's), and the gist1m_ivfpq cell's call is
    one chunk."""
    per = ann.pq_query_bytes(50, 96, 256, 984, 200, 960, True, kernel=True)
    assert per == 3 * 4 * 200 * 960 + 16 * 200
    assert ann._pq_chunk_rows(1000, 100, 50, per) == 1000


def test_wide_terms_on_the_cpu_expand_the_table():
    """The list terms plus |q - c|^2 and -2 q.w are the table of the
    residual to the codewords, subspace by subspace."""
    g = torch.Generator().manual_seed(11)
    M, ksub, dsub, nlist = 6, 16, 5, 4
    centroids = torch.randn(nlist, M * dsub, generator=g, dtype=torch.float64)
    books = torch.randn(M, ksub, dsub, generator=g, dtype=torch.float64)
    q = torch.randn(M * dsub, generator=g, dtype=torch.float64)
    terms = pq_scan.wide_terms(centroids, books)
    assert terms.shape == (nlist, ksub, M)
    for lst in range(nlist):
        r = (q - centroids[lst]).reshape(M, 1, dsub)
        table = ((r - books) ** 2).sum(-1)                                     # (M, ksub)
        q_terms = -2.0 * (q.reshape(M, 1, dsub) * books).sum(-1)
        r2 = (r * r).sum(-1)
        assert torch.allclose(terms[lst].T + q_terms + r2, table, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("refine_ratio", [1, 2])
def test_wide_route_glue_on_the_cpu(small_index, refine_ratio, monkeypatch):
    """With K7's rule refused and the wide route's forced, the search
    takes the wide route: the codes narrowed to 32-byte rows once, one
    scan a chunk, counted as a kernel chunk and a wide one, with the bytes
    its tables read; on CPU tensors the wrapper hands the call to the plain
    version, so the answers are the step route's, bit for bit."""
    index, q = small_index
    step = ann.ivf_pq_search(index, q, 5, refine_ratio=refine_ratio, device="cpu")
    monkeypatch.setattr(pq_scan, "takes", lambda *args: False)
    monkeypatch.setattr(pq_scan, "takes_wide", lambda *args: True)
    monkeypatch.setattr(ann, "_WIDE_OPERANDS", WeakIdKeyDictionary())
    narrowed = []
    narrow = pq_scan.narrow_codes
    monkeypatch.setattr(pq_scan, "narrow_codes",
                        lambda codes, wide=False: narrowed.append(wide) or narrow(codes, wide))
    names = ann.PQ_COUNTERS + (ann.PQ_KERNEL_CHUNKS, ann.PQ_WIDE_CHUNKS) + ann.PQ_TABLE_READS
    before = [tracing.get_counter(c) for c in names]
    got = ann.ivf_pq_search(index, q, 5, refine_ratio=refine_ratio, device="cpu")
    chunks, steps, table_bytes, kernel, wide, read_bytes, queries = (
        tracing.get_counter(c) - b for c, b in zip(names, before))
    assert torch.equal(got[0], step[0]) and torch.equal(got[1], step[1])
    assert narrowed == [True]
    assert chunks == kernel == wide == 1 and steps == 0
    assert table_bytes == len(q) * 3 * 8 * 256 * 4
    assert queries == len(q)
    assert read_bytes == pq_scan.wide_table_read_bytes(len(q), 16, 256, 8, 3)


def test_wide_operands_made_once_an_index(small_index, monkeypatch):
    """The wide route's codes and list terms are made at an index's first
    wide search and kept: a second search makes neither, a write to the
    index's codes or another index makes them again, and they go with the
    codes tensor."""
    index, q = small_index
    monkeypatch.setattr(pq_scan, "takes", lambda *args: False)
    monkeypatch.setattr(pq_scan, "takes_wide", lambda *args: True)
    monkeypatch.setattr(ann, "_WIDE_OPERANDS", WeakIdKeyDictionary())
    made = []
    terms = pq_scan.wide_terms
    monkeypatch.setattr(pq_scan, "wide_terms", lambda c, b: made.append(c) or terms(c, b))
    first = ann.ivf_pq_search(index, q, 5, device="cpu")
    ann.ivf_pq_search(index, q[:3], 5, device="cpu")
    assert len(made) == 1 and len(ann._WIDE_OPERANDS) == 1
    codes = index.slot_codes.clone()
    other = index._replace(slot_codes=codes)
    again = ann.ivf_pq_search(other, q, 5, device="cpu")
    assert len(made) == 2 and len(ann._WIDE_OPERANDS) == 2
    assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    codes.add_(0)
    ann.ivf_pq_search(other, q, 5, device="cpu")
    assert len(made) == 3
    del other, codes
    gc.collect()
    assert len(ann._WIDE_OPERANDS) == 1


def test_k7_route_counts_no_wide_chunk(small_index, monkeypatch):
    index, q = small_index
    monkeypatch.setattr(pq_scan, "takes", lambda *args: True)
    names = (ann.PQ_KERNEL_CHUNKS, ann.PQ_WIDE_CHUNKS) + ann.PQ_TABLE_READS
    before = [tracing.get_counter(c) for c in names]
    ann.ivf_pq_search(index, q, 5, device="cpu")
    assert [tracing.get_counter(c) - b for c, b in zip(names, before)] == [1, 0, 0, 0]


def test_wide_wrapper_on_the_cpu_is_the_plain_version(small_index):
    index, q = small_index
    _, probes = ann.select_k(ann.expanded_sq_dists(q, index.centroids), 3, select_min=True,
                             device="cpu")
    args = (q, index.centroids, index.codebooks)
    got = pq_scan.ivf_pq_scan_wide(*args, pq_scan.narrow_codes(index.slot_codes, wide=True),
                                   pq_scan.wide_terms(index.centroids, index.codebooks),
                                   index.slot_ids, index.cent_slots, probes, 10)
    ref = pq_scan.ivf_pq_scan_plain(*args, index.slot_codes, index.slot_ids, index.cent_slots,
                                    probes, 10)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


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


# (M, bits, d): at d 128 the cell's subspaces of 2 dimensions and
# chip_smoke's of 8 (the kernel's unrolled table builds), and two shapes of
# its generic build: 32-byte code rows, and 4-bit codes in rows padded to
# 16 bytes; then the unrolled builds at fewer subspaces than the code row
# is wide, whose lanes past M store nothing (M 48 at d 96 is deep-96's
# pq_dim in raft-ann-bench)
SHAPES = {"M64": (64, 8, 128), "M16": (16, 8, 128), "M32": (32, 8, 128), "M8x4bit": (8, 4, 128),
          "M48d96": (48, 8, 96), "M24d48": (24, 8, 48), "M12d96": (12, 8, 96),
          "M8d64": (8, 8, 64)}


@pytest.fixture(scope="module")
def card_indexes():
    """Each shape's index and the queries of its width."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    dev = torch.device("cuda")
    data = {}
    for d in sorted({d for _, _, d in SHAPES.values()}):
        x, centres, g = _mixture(40_000, d, dev, 5)
        q = centres[torch.randint(40, (300,), device=dev, generator=g)] + 0.5 * torch.randn(
            300, d, device=dev, generator=g)
        data[d] = x, torch.cat([q, 20.0 + 0.1 * torch.randn(4, d, device=dev, generator=g)])
    out = {}
    for name, (M, bits, d) in SHAPES.items():
        params = ann.IVFPQParams(nlist=96, nprobe=8, M=M, n_bits=bits, refine_ratio=2)
        x, q = data[d]
        out[name] = ann.ivf_pq_build(x, params, DistanceType.L2SqrtExpanded, seed=7,
                                     device=dev), q
    return out


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
@pytest.mark.parametrize("kk", [10, 40, 200, 400, 512])
@pytest.mark.parametrize("nprobe", [1, 8])
def test_kernel_matches_plain(card, card_indexes, shape, kk, nprobe):
    index, q = card_indexes[shape]
    probes = _probes(index, q, nprobe)
    args = (q, index.centroids, index.codebooks)
    before = inventory.snapshot()
    got = pq_scan.ivf_pq_scan(*args, pq_scan.narrow_codes(index.slot_codes), index.slot_ids,
                              index.cent_slots, probes, kk)
    torch.cuda.synchronize()
    assert sum(inventory.launches_since(before)["pq_scan"].values()) == 1
    ref = pq_scan.ivf_pq_scan_plain(*args, index.slot_codes, index.slot_ids, index.cent_slots,
                                    probes, kk)
    _assert_matches_plain(got, ref)
    if nprobe == 1 and kk == 512:
        # the far queries' lists hold fewer rows than kk
        assert bool((got[1][-4:] < 0).any())


@pytest.mark.card
@pytest.mark.parametrize("M", [64, 32, 16])
@pytest.mark.parametrize("kk", [10, 40, 200, 400])
def test_kernel_matches_plain_across_slot_boundaries(card, M, kk):
    """Lists of slots that are not neighbours in the store, 40 rows a slot
    (so a warp's 32 rows straddle two slots, and its lanes' rows sit at
    every offset of a slot), vacant rows inside slots and at their ends,
    and every query probing the three lists in its own order; 2, 4 and 8
    dimensions a subspace (the unrolled builds and the generic one)."""
    g = torch.Generator(device=card).manual_seed(1000 * M + kk)
    d, ksub, cap, S = 128, 256, 40, 7
    cent_slots = torch.tensor([[5, 2, 6], [0, 3, -1], [1, 4, -1]], dtype=torch.int32,
                              device=card)
    pos = torch.arange(cap, device=card)
    vacant = (pos % 9 == 4).expand(S, cap).clone()
    vacant[[2, 4], cap - 6:] = True
    ids = torch.arange(S * cap, dtype=torch.int32, device=card).reshape(S, cap)
    ids = torch.where(vacant, -1, ids)
    codes = torch.randint(0, ksub, (S, cap, M), generator=g, device=card, dtype=torch.int32)
    centroids = torch.randn(3, d, generator=g, device=card)
    codebooks = 0.5 * torch.randn(M, ksub, d // M, generator=g, device=card)
    q = torch.randn(48, d, generator=g, device=card)
    probes = torch.stack([torch.tensor([0, 1, 2]).roll(i) for i in range(len(q))]).to(
        device=card, dtype=torch.int32)
    got = pq_scan.ivf_pq_scan(q, centroids, codebooks, pq_scan.narrow_codes(codes), ids,
                              cent_slots, probes, kk)
    ref = pq_scan.ivf_pq_scan_plain(q, centroids, codebooks, codes, ids, cent_slots, probes,
                                    kk)
    torch.cuda.synchronize()
    _assert_matches_plain(got, ref)
    filled = min(kk, int((ids[cent_slots[cent_slots >= 0].long()] >= 0).sum()))
    assert bool((got[1][:, :filled] >= 0).all()) and bool((got[1][:, filled:] < 0).all())


@pytest.mark.card
@pytest.mark.parametrize("M", [64, 16])
@pytest.mark.parametrize("refine_ratio", [1, 2])
def test_search_bitwise_whatever_the_chunks(card, card_indexes, M, refine_ratio, monkeypatch):
    (index, q), k, nprobe = card_indexes["M%d" % M], 100, 8
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
    index, q = card_indexes["M64"]
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
    index, q = card_indexes["M64"]
    probes = _probes(index, q, 8)
    codes = pq_scan.narrow_codes(index.slot_codes)
    with pytest.raises(LogicError):
        pq_scan.ivf_pq_scan(q, index.centroids, index.codebooks, codes, index.slot_ids,
                            index.cent_slots, probes, pq_scan.MAX_KK + 1)
    with pytest.raises(LogicError):
        pq_scan.ivf_pq_scan(q.double(), index.centroids, index.codebooks, codes,
                            index.slot_ids, index.cent_slots, probes, 10)
    assert "pq_scan" in _build.KERNELS


# --------------------------------------------------------------------- #
# the card: the wide route
# --------------------------------------------------------------------- #
# (M, d): gist-960's shape (96 subspaces of 10 dimensions, 96-byte rows),
# d 256 / M 32 (K7's codebook outgrows shared memory; 32-byte rows), d 768
# / M 96 (8 dimensions), M 80 (not a multiple of 16: a 96-byte row with 16
# zero bytes) and M 48 (64-byte rows) at d 960
WIDE_SHAPES = {"d960M96": (96, 960), "d256M32": (32, 256), "d768M96": (96, 768),
               "d960M80": (80, 960), "d960M48": (48, 960)}


@pytest.fixture(scope="module")
def wide_indexes():
    """Each wide shape's index (uneven lists, vacant rows, a far blob) and
    the queries of its width."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    dev = torch.device("cuda")
    data = {}
    for d in sorted({d for _, d in WIDE_SHAPES.values()}):
        x, centres, g = _mixture(40_000, d, dev, 6)
        q = centres[torch.randint(40, (200,), device=dev, generator=g)] + 0.5 * torch.randn(
            200, d, device=dev, generator=g)
        data[d] = x, torch.cat([q, 20.0 + 0.1 * torch.randn(4, d, device=dev, generator=g)])
    out = {}
    for name, (M, d) in WIDE_SHAPES.items():
        params = ann.IVFPQParams(nlist=96, nprobe=8, M=M, n_bits=8, refine_ratio=2)
        x, q = data[d]
        out[name] = ann.ivf_pq_build(x, params, DistanceType.L2SqrtExpanded, seed=7,
                                     device=dev), q
    return out


def _wide_call(index, q, probes, kk, cent_slots=None):
    return pq_scan.ivf_pq_scan_wide(q, index.centroids, index.codebooks,
                                    pq_scan.narrow_codes(index.slot_codes, wide=True),
                                    pq_scan.wide_terms(index.centroids, index.codebooks),
                                    index.slot_ids,
                                    index.cent_slots if cent_slots is None else cent_slots,
                                    probes, kk)


@pytest.mark.card
@pytest.mark.parametrize("shape", list(WIDE_SHAPES))
def test_wide_terms_match_the_plain_terms(card, wide_indexes, shape):
    """The terms kernel's rows hold the plain terms of their list and
    codeword, each subspace once at a column of its own and zeros past M,
    and count one launch."""
    index, _ = wide_indexes[shape]
    M, _ = WIDE_SHAPES[shape]
    before = inventory.snapshot()
    got = pq_scan.wide_terms(index.centroids, index.codebooks)
    torch.cuda.synchronize()
    assert sum(inventory.launches_since(before)["pq_scan_wide_terms"].values()) == 1
    width = pq_scan.code_bytes(M, wide=True)
    assert got.shape == (index.centroids.shape[0], 256, width)
    ref = pq_scan.wide_terms(index.centroids.cpu().double(), index.codebooks.cpu().double())
    ref = torch.cat([ref, ref.new_zeros(*ref.shape[:2], width - M)], dim=2)
    assert torch.allclose(got.cpu().double().sort(dim=2).values, ref.sort(dim=2).values,
                          rtol=1e-5, atol=1e-4)


@pytest.mark.card
@pytest.mark.parametrize("shape", list(WIDE_SHAPES))
@pytest.mark.parametrize("kk", [10, 200, 512])
@pytest.mark.parametrize("nprobe", [1, 8])
def test_wide_matches_plain(card, wide_indexes, shape, kk, nprobe):
    index, q = wide_indexes[shape]
    M, d = WIDE_SHAPES[shape]
    probes = _probes(index, q, nprobe)
    assert not pq_scan.takes(q, index.centroids, index.codebooks, kk, nprobe,
                             index.cent_slots.shape[1])
    before = inventory.snapshot()
    got = _wide_call(index, q, probes, kk)
    torch.cuda.synchronize()
    assert sum(inventory.launches_since(before)["pq_scan_wide"].values()) == 1
    ref = pq_scan.ivf_pq_scan_plain(q, index.centroids, index.codebooks, index.slot_codes,
                                    index.slot_ids, index.cent_slots, probes, kk)
    _assert_matches_plain(got, ref)
    if nprobe == 1 and kk == 512:
        assert bool((got[1][-4:] < 0).any())


@pytest.mark.card
@pytest.mark.parametrize("M,d", [(96, 960), (80, 960), (32, 256)])
@pytest.mark.parametrize("kk", [10, 200, 400])
def test_wide_matches_plain_across_slot_boundaries(card, M, d, kk):
    """As K7's test of the same name: lists of slots that are not
    neighbours, 40 rows a slot, vacant rows inside slots and at their
    ends, every query probing the three lists in its own order."""
    g = torch.Generator(device=card).manual_seed(1000 * M + kk)
    ksub, cap, S = 256, 40, 7
    cent_slots = torch.tensor([[5, 2, 6], [0, 3, -1], [1, 4, -1]], dtype=torch.int32,
                              device=card)
    pos = torch.arange(cap, device=card)
    vacant = (pos % 9 == 4).expand(S, cap).clone()
    vacant[[2, 4], cap - 6:] = True
    ids = torch.arange(S * cap, dtype=torch.int32, device=card).reshape(S, cap)
    ids = torch.where(vacant, -1, ids)
    codes = torch.randint(0, ksub, (S, cap, M), generator=g, device=card, dtype=torch.int32)
    centroids = torch.randn(3, d, generator=g, device=card)
    codebooks = 0.5 * torch.randn(M, ksub, d // M, generator=g, device=card)
    q = torch.randn(48, d, generator=g, device=card)
    probes = torch.stack([torch.tensor([0, 1, 2]).roll(i) for i in range(len(q))]).to(
        device=card, dtype=torch.int32)
    got = pq_scan.ivf_pq_scan_wide(q, centroids, codebooks,
                                   pq_scan.narrow_codes(codes, wide=True),
                                   pq_scan.wide_terms(centroids, codebooks), ids, cent_slots,
                                   probes, kk)
    ref = pq_scan.ivf_pq_scan_plain(q, centroids, codebooks, codes, ids, cent_slots, probes,
                                    kk)
    torch.cuda.synchronize()
    _assert_matches_plain(got, ref)
    filled = min(kk, int((ids[cent_slots[cent_slots >= 0].long()] >= 0).sum()))
    assert bool((got[1][:, :filled] >= 0).all()) and bool((got[1][:, filled:] < 0).all())


@pytest.mark.card
def test_wide_shared_memory_limit(card, wide_indexes):
    """At the most probe slots the wide rule admits at gist-960's shape
    the route launches and answers as with the index's own slot table;
    one column more and it raises."""
    index, q = wide_indexes["d960M96"]
    probes = _probes(index, q, 8)
    nlist, max_slots = index.cent_slots.shape
    widest = max(w for w in range(max_slots, 4096) if pq_scan.fits_wide(96, 256, 200, 8, w))
    pad = torch.full((nlist, widest - max_slots), -1, dtype=torch.int32, device=card)
    ref = _wide_call(index, q, probes, 200)
    got = _wide_call(index, q, probes, 200, torch.cat([index.cent_slots, pad], dim=1))
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert pq_scan.smem_bytes_wide(96, 256, 8, widest) <= pq_scan.SMEM_LIMIT
    with pytest.raises(LogicError):
        _wide_call(index, q, probes, 200, torch.cat([index.cent_slots, pad, pad[:, :1]], dim=1))


@pytest.mark.card
@pytest.mark.parametrize("refine_ratio", [1, 2])
def test_wide_search_bitwise_whatever_the_chunks(card, wide_indexes, refine_ratio, monkeypatch):
    (index, q), k, nprobe = wide_indexes["d960M96"], 100, 8
    kk = k * refine_ratio
    per = ann.pq_query_bytes(nprobe, 96, 256, index.slot_ids.shape[1], kk, 960,
                             refine_ratio > 1, kernel=True)
    nq = len(q)
    got = {}
    names = ann.PQ_COUNTERS + (ann.PQ_KERNEL_CHUNKS, ann.PQ_WIDE_CHUNKS) + ann.PQ_TABLE_READS
    for chunks in (1, 3, 16):
        budget = nq * (4 * nprobe + 8 * k) + per * -(-nq // chunks)
        monkeypatch.setattr(ann, "PQ_BUDGET_BYTES", budget)
        before = [tracing.get_counter(c) for c in names]
        got[chunks] = ann.ivf_pq_search(index, q, k, nprobe, refine_ratio, device=card)
        torch.cuda.synchronize()
        counted = [tracing.get_counter(c) - b for c, b in zip(names, before)]
        assert counted[0] == counted[3] == counted[4] == chunks and counted[1] == 0, counted
        assert counted[6] == nq, counted
    for chunks in (3, 16):
        assert torch.equal(got[chunks][0], got[1][0]) and torch.equal(got[chunks][1], got[1][1])


@pytest.mark.card
def test_sift_cell_shape_still_takes_k7(card, card_indexes, wide_indexes):
    """The sift1m_ivfpq cell's shape (d 128, M 64, kk 200, nprobe 50)
    routes to K7's <4, 256, 2> instance, and gist-960's to the wide
    route, each launching its own kernel alone."""
    for (index, q), route, kernel in ((card_indexes["M64"], "kernel", "pq_scan"),
                                      (wide_indexes["d960M96"], "wide", "pq_scan_wide")):
        M = index.codebooks.shape[0]
        assert ann._pq_route(q, index.centroids, index.codebooks, 200, 50,
                             index.cent_slots.shape[1], DistanceType.L2SqrtExpanded) == route
        before = inventory.snapshot()
        wide = tracing.get_counter(ann.PQ_WIDE_CHUNKS)
        ann.ivf_pq_search(index, q, 100, 50, 2, device=card)
        torch.cuda.synchronize()
        launched = inventory.launches_since(before)
        assert kernel in launched and {"pq_scan", "pq_scan_wide"} - {kernel} - set(launched)
        assert tracing.get_counter(ann.PQ_WIDE_CHUNKS) - wide == (route == "wide")
        if route == "kernel":
            assert M == 64 and pq_scan.code_bytes(M) == 64   # NCH 4 with dsub 2


@pytest.mark.card
def test_call_the_wide_route_does_not_take_raises(card, wide_indexes):
    index, q = wide_indexes["d960M96"]
    probes = _probes(index, q, 8)
    with pytest.raises(LogicError):
        _wide_call(index, q, probes, pq_scan.MAX_KK + 1)
    with pytest.raises(LogicError):
        _wide_call(index, q.double(), probes, 10)
    assert "pq_scan_wide" in _build.KERNELS
