"""Port parity of the kernel cost inventory (raft_tpu_torch.core.inventory)
and the analytic counts it records (raft_tpu_torch.ops.cost).

The JAX inventory reads a compiled program's cost and memory analysis;
the port's is fed at the kernel wrappers' launch seam.  Both are given
the same numbers here (the JAX one through a stand-in compiled object)
and must give the same entries, rollups and gauges, bit for bit.  The
analytic counts are held to the arithmetic that ``chip_smoke.py``'s
bounds used, at three shapes a kernel, and K3's count of a work list to
the count from its scan lists.  On the CPU every wrapper takes its plain
version, which records nothing.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu.core import inventory as jinv
from raft_tpu.core.metrics import default_registry as jax_registry
from raft_tpu_torch.core import inventory
from raft_tpu_torch.core.metrics import default_registry
from raft_tpu_torch.ops import cost
from raft_tpu_torch.ops.ivf_tile import scan_work_list, fused_ivf_scan
from raft_tpu_torch.ops.knn_tile import fused_knn_tile
from raft_tpu_torch.ops.nn_tile import fused_nn_tile
from raft_tpu_torch.ops.select_tile import select_tile
from raft_tpu_torch.session import metrics_snapshot
from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat_build, ivf_flat_search

ROOT = Path(__file__).resolve().parents[1]

# (fn, key, flops, bytes, arguments, outputs, scratch)
ENTRIES = [
    ("knn_tile", (1024, 1_000_000, 128, 100), 2.62144e11, 5.1302e8, 5.13e8, 8.2e5, 9.8e4),
    ("knn_tile", (16, 500_000, 128, 100), 2.048e9, 2.56e8, 2.56e8, 1.28e4, 9.8e4),
    ("select_tile", (128, 3200, 100), 409600.0, 1740800.0, 1638400.0, 102400.0, 65536.0),
    ("ivf_tile", (128, 4096, 1_000_448, 128, 1954, 100, False), 1.2e9, 8.1e8, 5.2e8, 3.3e6,
     0.0),
]


class _Analysis:
    """Stand-in for a compiled program: what the JAX inventory reads."""

    def __init__(self, flops, nbytes, arg, out, tmp):
        self._ca = {"flops": flops, "bytes accessed": nbytes}
        self.argument_size_in_bytes = arg
        self.output_size_in_bytes = out
        self.temp_size_in_bytes = tmp
        self.generated_code_size_in_bytes = 0

    def cost_analysis(self):
        return self._ca

    def memory_analysis(self):
        return self


@pytest.fixture(autouse=True)
def _clean():
    inventory.reset()
    jinv.reset()
    yield
    inventory.reset()
    jinv.reset()


def _feed_both():
    for fn, key, flops, nbytes, arg, out, tmp in ENTRIES:
        jinv.note_compiled(fn, key, _Analysis(flops, nbytes, arg, out, tmp))
        inventory.note_launch(fn, key, flops, nbytes, (arg, out, tmp))


def test_entries_match_jax():
    _feed_both()
    ours, theirs = inventory.snapshot(), jinv.snapshot()
    assert set(ours) == set(theirs)
    for fn in theirs:
        assert set(ours[fn]) == set(theirs[fn])
        for key, want in theirs[fn].items():
            got = dict(ours[fn][key])
            assert got.pop("launches") == 1
            assert got == want
    assert inventory.entry_count() == jinv.entry_count() == len(ENTRIES)


def test_summary_matches_jax():
    _feed_both()
    ours, theirs = inventory.summary(), jinv.summary()
    assert ours["programs"] == theirs["programs"]
    assert ours["total_hbm_bytes"] == theirs["total_hbm_bytes"]
    assert set(ours["per_fn"]) == set(theirs["per_fn"])
    for fn, want in theirs["per_fn"].items():
        got = dict(ours["per_fn"][fn])
        assert got.pop("launches") == sum(1 for e in ENTRIES if e[0] == fn)
        assert got == want


def test_gauges_match_jax():
    _feed_both()
    for name in ("raft_tpu_program_flops", "raft_tpu_program_bytes",
                 "raft_tpu_program_hbm_bytes"):
        ours = {tuple(sorted(lbls.items())): s.value
                for lbls, s in default_registry().get(name).series()}
        theirs = {tuple(sorted(lbls.items())): s.value
                  for lbls, s in jax_registry().get(name).series()}
        mine = {k: v for k, v in theirs.items() if dict(k)["fn"] in {e[0] for e in ENTRIES}}
        for k, v in mine.items():
            assert ours[k] == v, (name, k)


def test_later_launches_count_and_keep_the_first_costs():
    first = inventory.note_launch("nn_tile", (8, 4, 16), 1024.0, 704.0, (640.0, 64.0, 0.0))
    assert first["launches"] == 1
    again = inventory.note_launch("nn_tile", (8, 4, 16), 9.0, 9.0, (9.0, 9.0, 9.0))
    assert again["launches"] == 2 and again["flops"] == 1024.0 and again["hbm_bytes"] == 704.0
    inventory.note_launch("nn_tile", (8, 4, 16))
    entry = next(iter(inventory.snapshot()["nn_tile"].values()))
    assert entry["launches"] == 3 and entry["bytes_accessed"] == 704.0
    assert inventory.summary()["per_fn"]["nn_tile"]["launches"] == 3


def test_count_launch_counts_once_a_shape():
    calls = []

    def costs():
        calls.append(1)
        return 10.0, 20.0, (1.0, 2.0, 3.0)

    for _ in range(4):
        inventory.count_launch("select_tile", (2, 8, 4), costs)
    inventory.count_launch("select_tile", (2, 8, 5), costs)
    assert len(calls) == 2
    snap = inventory.snapshot()["select_tile"]
    assert sorted(e["launches"] for e in snap.values()) == [1, 4]
    assert all(e["flops"] == 10.0 and e["hbm_bytes"] == 6.0 for e in snap.values())


def test_reset_drops_entries_but_not_gauges():
    _feed_both()
    inventory.reset()
    assert inventory.snapshot() == {} and inventory.entry_count() == 0
    assert inventory.summary() == {"programs": 0, "total_hbm_bytes": 0.0, "per_fn": {}}
    assert default_registry().get("raft_tpu_program_flops") is not None


def test_footprint_counts_tensor_bytes():
    a, b = torch.zeros(3, 4), torch.zeros(5, dtype=torch.int32)
    assert inventory.footprint((a, b), (b,), 7) == (68.0, 20.0, 7.0)
    assert inventory.footprint((), (a,)) == (0.0, 48.0, 0.0)


def test_cpu_calls_record_nothing():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((300, 16)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((9, 16)).astype(np.float32))
    fused_knn_tile(x, q, 5)
    fused_nn_tile(q, x)
    select_tile(q, 3)
    index = ivf_flat_build(x, IVFFlatParams(nlist=8, nprobe=4), device="cpu")
    ivf_flat_search(index, q, 5, device="cpu")
    assert inventory.entry_count() == 0


def test_metrics_snapshot_carries_inventory():
    inventory.note_launch("knn_tile", (1, 2, 8, 1), 32.0, 104.0, (96.0, 8.0, 0.0))
    inv = metrics_snapshot()["inventory"]
    assert inv["programs"] == 1 and inv["per_fn"]["knn_tile"]["launches"] == 1
    assert inv["detail"] == inventory.snapshot()


# --------------------------------------------------------------------- #
# the analytic counts against the arithmetic of chip_smoke.py's bounds
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("nq,n,d,k", [(1024, 1_000_000, 128, 100), (16, 250_000, 128, 100),
                                      (33, 20_011, 16, 64)])
def test_knn_cost(nq, n, d, k):
    assert cost.knn_cost(nq, n, d, k) == (2.0 * nq * n * d,
                                          4.0 * (n + nq) * d + 8.0 * nq * k)


@pytest.mark.parametrize("m,w,k", [(1024, 100_000, 100), (128, 3200, 100), (96, 64, 32)])
def test_select_cost(m, w, k):
    assert cost.select_cost(m, w, k) == (1.0 * m * w, 4.0 * m * w + 8.0 * m * k)


@pytest.mark.parametrize("nq,d,k,entries,scanned,distinct", [
    (1024, 128, 100, 32768, 31_000_000, 990_000), (128, 128, 100, 4096, 3_900_000, 800_000),
    (7, 24, 10, 56, 900, 700)])
def test_ivf_scan_cost(nq, d, k, entries, scanned, distinct):
    row_bytes = 4.0 * d + 8.0
    io = 4.0 * nq * d + 4.0 * entries + 8.0 * nq * k
    assert cost.ivf_scan_cost(nq, d, k, entries, scanned, distinct) == (
        2.0 * d * scanned, distinct * row_bytes + io)


@pytest.mark.parametrize("m,n,d", [(131_072, 1024, 128), (1_000_000, 256, 8), (9000, 77, 300)])
def test_nn_cost(m, n, d):
    assert cost.nn_cost(m, n, d) == (2.0 * m * n * d, 4.0 * (m + n) * d + 8.0 * m)


@pytest.mark.parametrize("m,n,d", [(1024, 100_000, 128), (1024, 1024, 65_536), (3, 5, 77)])
def test_pairwise_cost(m, n, d):
    assert cost.pairwise_cost(m, n, d) == (1.0 * m * n * d * 2,
                                           4.0 * ((m + n) * d + m * n))


def test_chip_smoke_takes_its_bounds_from_the_counts():
    """Every count function is what chip_smoke.py's bounds divide."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    called = {node.func.attr for node in ast.walk(tree)
              if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and isinstance(node.func.value, (ast.Name, ast.Attribute))
              and (getattr(node.func.value, "id", None) == "cost"
                   or getattr(node.func.value, "attr", None) == "cost")}
    assert {"knn_cost", "select_cost", "ivf_scan_cost", "nn_cost", "pairwise_cost"} <= called
    # and no local of the script shadows the module's name
    stores = [node.lineno for node in ast.walk(tree) if isinstance(node, ast.Name)
              and node.id == "cost" and isinstance(node.ctx, ast.Store)]
    assert not stores, stores


@pytest.mark.parametrize("nq,n_steps,seed", [(40, 6, 0), (130, 8, 1), (16, 3, 2)])
def test_ivf_item_cost_matches_the_scan_lists(nq, n_steps, seed):
    """K3's count of a work list (what its wrapper records) equals the
    count from the scan lists (what chip_smoke.py's K3 row computes)."""
    from raft_tpu_torch.ops.ivf_tile import item_cost

    rng = np.random.default_rng(seed)
    S, cap, d, k = 12, 9, 24, 10
    ids = torch.from_numpy(np.where(rng.random((S, cap)) < 0.7,
                                    np.arange(S * cap).reshape(S, cap), -1).astype(np.int32))
    slots = torch.from_numpy(rng.integers(-1, S, (nq, n_steps)).astype(np.int32))
    work = scan_work_list(slots, S, cap, 16)
    rows_in_slot = (ids >= 0).sum(dim=1)
    live = slots >= 0
    scanned = int(rows_in_slot[slots[live].long()].sum())
    distinct = int(rows_in_slot[torch.unique(slots[live].long())].sum())
    assert item_cost(ids.reshape(-1), work, cap, nq, d, k, slots.numel()) == \
        cost.ivf_scan_cost(nq, d, k, slots.numel(), scanned, distinct)
    # and the scan itself still runs on these lists on the CPU
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    vecs = torch.from_numpy(rng.standard_normal((S, cap, d)).astype(np.float32))
    fused_ivf_scan(q, vecs, (vecs * vecs).sum(-1), ids, slots, k)
    assert inventory.entry_count() == 0
