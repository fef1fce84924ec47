"""Package rules of raft_tpu_torch: no JAX, explicit devices, kernel
wrappers that follow their tensor's device and never fall back."""

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import raft_tpu_torch
from raft_tpu_torch import RaftError, linalg, matrix, stats
from raft_tpu_torch.cache import VecCache
from raft_tpu_torch.core.handle import Handle
from raft_tpu_torch.label import make_monotonic, merge_labels
from raft_tpu_torch.lap import LinearAssignmentProblem, solve_lap
from raft_tpu_torch.persist import load_current
from raft_tpu_torch.random import Rng
from raft_tpu_torch.sparse import COO, CSR
from raft_tpu_torch.sparse import convert as sparse_convert
from raft_tpu_torch.sparse import distance as sparse_distance
from raft_tpu_torch.sparse import hierarchy, linkage, selection
from raft_tpu_torch.sparse.mst import mst
from raft_tpu_torch.sparse import linalg as sparse_linalg
from raft_tpu_torch.sparse import op as sparse_op
from raft_tpu_torch.sparse.spectral import fit_embedding
from raft_tpu_torch import spectral
from raft_tpu_torch.spectral.spectral_util import transform_eigen_matrix
from raft_tpu_torch.serve import BucketPolicy, MicroBatcher, ServeWorker
from raft_tpu_torch.fleet import Fleet
from raft_tpu_torch.core.utils import Pow2, align, ceildiv, round_down_safe, round_up_safe
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.core import inventory
from raft_tpu_torch.ops import _build, pq_scan
from raft_tpu_torch.ops.ivf_tile import fused_ivf_scan, fused_ivf_scan_plain
from raft_tpu_torch.ops.knn_tile import (fused_knn_tile, fused_knn_twophase, knn_tile_plain,
                                         twophase_tiles, twophase_tiles_plain)
from raft_tpu_torch.ops.nn_tile import fused_nn_tile, nn_tile_plain
from raft_tpu_torch.ops.pairwise_tile import pairwise_tile, pairwise_tile_plain
from raft_tpu_torch.ops.select_tile import select_tile, select_tile_plain

ROOT = Path(__file__).resolve().parents[1]


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_import_pulls_in_no_jax():
    code = ("import raft_tpu_torch, raft_tpu_torch.convert, sys; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'raft_tpu.'))"
            " or m == 'raft_tpu']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                   check=True, timeout=120)


@pytest.mark.parametrize("module", ["raft_tpu_torch.serve", "raft_tpu_torch.cache",
                                    "raft_tpu_torch.comms.faults", "raft_tpu_torch.config",
                                    "raft_tpu_torch.core.tracing",
                                    "raft_tpu_torch.comms.resilience",
                                    "raft_tpu_torch.serve.ann_service",
                                    "raft_tpu_torch.core.native", "raft_tpu_torch.core.handle",
                                    "raft_tpu_torch.core.debug", "raft_tpu_torch.linalg",
                                    "raft_tpu_torch.matrix", "raft_tpu_torch.stats",
                                    "raft_tpu_torch.random", "raft_tpu_torch.label",
                                    "raft_tpu_torch.lap", "raft_tpu_torch.sparse",
                                    "raft_tpu_torch.sparse.spectral",
                                    "raft_tpu_torch.sparse.distance",
                                    "raft_tpu_torch.sparse.selection",
                                    "raft_tpu_torch.sparse.mst", "raft_tpu_torch.sparse.linkage",
                                    "raft_tpu_torch.sparse.hierarchy",
                                    "raft_tpu_torch.spectral", "raft_tpu_torch.persist",
                                    "raft_tpu_torch.persist.wal",
                                    "raft_tpu_torch.persist.snapshot",
                                    "raft_tpu_torch.persist.manager",
                                    "raft_tpu_torch.spatial.ball_cover",
                                    "raft_tpu_torch.core.inventory", "raft_tpu_torch.ops.cost",
                                    "raft_tpu_torch.serve.sentinel",
                                    "raft_tpu_torch.serve.opsplane", "raft_tpu_torch.fleet",
                                    "raft_tpu_torch.fleet.protocol",
                                    "raft_tpu_torch.fleet.tracing",
                                    "raft_tpu_torch.fleet.chaos", "raft_tpu_torch.fleet.router",
                                    "raft_tpu_torch.fleet.worker",
                                    "raft_tpu_torch.fleet.supervisor",
                                    "raft_tpu_torch.core.tuning",
                                    "raft_tpu_torch.core.specializations"])
def test_serving_modules_pull_in_no_jax(module):
    code = ("import importlib, sys; importlib.import_module(%r); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'raft_tpu.'))"
            " or m == 'raft_tpu']; assert not bad, bad" % module)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                   check=True, timeout=120)


@pytest.mark.parametrize("tool", ["torch_autotune.py", "torch_loadgen.py",
                                  "torch_trace_report.py", "torch_metrics_report.py"])
def test_tools_pull_in_no_jax(tool):
    code = ("import importlib.util, sys; "
            "spec = importlib.util.spec_from_file_location('t', 'tools/%s'); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'raft_tpu.'))"
            " or m == 'raft_tpu']; assert not bad, bad" % tool)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                   check=True, timeout=120)


def test_metrics_demo_runs_without_jax():
    # the port's --demo on the CPU end to end, then the modules it loaded
    code = ("import runpy, sys; sys.argv = ['torch_metrics_report.py', '--demo', '--device', "
            "'cpu', '--format', 'json']\n"
            "try:\n    runpy.run_path('tools/torch_metrics_report.py', run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code in (0, None), e.code\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'raft_tpu.'))"
            " or m == 'raft_tpu']; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"raft_tpu_serve_requests_total"' in out.stdout


def test_pyproject_names_every_port_subpackage():
    """A wheel built from the tree carries every subpackage of the port
    and its data files (the kernels' sources, the tuning tables)."""
    import tomllib

    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    named = set(conf["tool"]["setuptools"]["packages"])
    found = {".".join(p.parent.relative_to(ROOT).parts)
             for p in (ROOT / "raft_tpu_torch").rglob("__init__.py")}
    assert found <= named, sorted(found - named)
    data = conf["tool"]["setuptools"]["package-data"]["raft_tpu_torch"]
    assert {"ops/csrc/*.cu", "ops/csrc/*.cuh", "tuning/*.json"} <= set(data)
    manifest = (ROOT / "MANIFEST.in").read_text()
    assert "recursive-include raft_tpu_torch/tuning *.json" in manifest
    assert "recursive-include raft_tpu_torch/ops/csrc *.cu *.cuh" in manifest


def test_sources_import_no_jax():
    banned = re.compile(r"\s*(from|import)\s+(jax|raft_tpu)(\.|\s|$)")
    for path in list((ROOT / "raft_tpu_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py", ROOT / "tools" / "torch_autotune.py",
            ROOT / "tools" / "torch_loadgen.py", ROOT / "tools" / "torch_trace_report.py",
            ROOT / "tools" / "torch_metrics_report.py", ROOT / "tools" / "torch_ivfpq_sweep.py"]:
        for line in path.read_text().splitlines():
            assert not banned.match(line), (path, line)


def _cpu_index(x):
    return raft_tpu_torch.ivf_flat_build(x, raft_tpu_torch.IVFFlatParams(nlist=2), device="cpu")


def _cpu_pq(x):
    return raft_tpu_torch.ivf_pq_build(x, raft_tpu_torch.IVFPQParams(nlist=2, M=2, n_bits=3),
                                       device="cpu")


def _cpu_sq(x):
    return raft_tpu_torch.ivf_sq_build(x, raft_tpu_torch.IVFSQParams(nlist=2), device="cpu")


def _cpu_rbc(x):
    return raft_tpu_torch.rbc_build_index(x, device="cpu")


def _cpu_graph(x):
    """A symmetric CSR on the CPU (asked for explicitly) of x's 20 rows."""
    adj = (np.abs(x[:, None, 0] - x[None, :, 0]) < 0.5).astype(np.float32)
    np.fill_diagonal(adj, 0)
    return CSR.from_dense(adj, device="cpu")


def _cpu_coo(x):
    return sparse_convert.csr_to_coo(_cpu_graph(x))


ENTRY_POINTS = {
    "brute_force_knn": lambda x, q: raft_tpu_torch.brute_force_knn(x, q, 3),
    "knn_merge_parts": lambda x, q: raft_tpu_torch.knn_merge_parts(
        x[None, :, :3], np.zeros((1, 20, 3), np.int32), 3),
    "fused_l2_knn": lambda x, q: raft_tpu_torch.fused_l2_knn(x, q, 3),
    "select_k": lambda x, q: raft_tpu_torch.select_k(x, 3),
    "pairwise_distance": lambda x, q: raft_tpu_torch.pairwise_distance(x, q),
    "haversine_knn": lambda x, q: raft_tpu_torch.haversine_knn(x[:, :2], q[:, :2], 3),
    "fused_l2_nn": lambda x, q: raft_tpu_torch.fused_l2_nn(q, x),
    "fused_l2_nn_min_reduce": lambda x, q: raft_tpu_torch.fused_l2_nn_min_reduce(q, x),
    "kmeans": lambda x, q: raft_tpu_torch.kmeans(x, 2),
    "ivf_flat_build": lambda x, q: raft_tpu_torch.ivf_flat_build(
        x, raft_tpu_torch.IVFFlatParams(nlist=2)),
    "ivf_flat_search": lambda x, q: raft_tpu_torch.ivf_flat_search(_cpu_index(x), q, 3),
    "ivf_flat_extend": lambda x, q: raft_tpu_torch.ivf_flat_extend(
        _cpu_index(x), q, np.arange(100, 105)),
    "approx_knn_build_index": lambda x, q: raft_tpu_torch.approx_knn_build_index(
        x, raft_tpu_torch.IVFFlatParams(nlist=2)),
    "approx_knn_search": lambda x, q: raft_tpu_torch.approx_knn_search(_cpu_index(x), q, 3),
    "ivf_pq_build": lambda x, q: raft_tpu_torch.ivf_pq_build(
        x, raft_tpu_torch.IVFPQParams(nlist=2, M=2, n_bits=3)),
    "ivf_pq_search": lambda x, q: raft_tpu_torch.ivf_pq_search(_cpu_pq(x), q, 3),
    "ivf_sq_build": lambda x, q: raft_tpu_torch.ivf_sq_build(x, raft_tpu_torch.IVFSQParams(2)),
    "ivf_sq_search": lambda x, q: raft_tpu_torch.ivf_sq_search(_cpu_sq(x), q, 3),
    "approx_knn_search PQ": lambda x, q: raft_tpu_torch.approx_knn_search(_cpu_pq(x), q, 3),
    "rbc_build_index": lambda x, q: raft_tpu_torch.rbc_build_index(x),
    "rbc_knn_query": lambda x, q: raft_tpu_torch.rbc_knn_query(_cpu_rbc(x), 3, q),
    "rbc_all_knn_query": lambda x, q: raft_tpu_torch.rbc_all_knn_query(_cpu_rbc(x), 3),
    "persist.load_current": lambda x, q: load_current("."),
    "ANNService PQ": lambda x, q: raft_tpu_torch.ANNService(_cpu_pq(x), 3, start=False),
    "KNNService": lambda x, q: raft_tpu_torch.KNNService(x, 3, start=False),
    "PairwiseService": lambda x, q: raft_tpu_torch.PairwiseService(x, start=False),
    "ANNService": lambda x, q: raft_tpu_torch.ANNService(_cpu_index(x), 3, start=False),
    "VecCache": lambda x, q: VecCache(4, 8),
    "Handle": lambda x, q: Handle(),
    "linalg.gemm": lambda x, q: linalg.gemm(x, q, trans_b=True),
    "linalg.compute_smallest_eigenvectors": lambda x, q: linalg.compute_smallest_eigenvectors(
        x[:4, :4] + x[:4, :4].T, 4, 1),
    "matrix.copy_rows": lambda x, q: matrix.copy_rows(x, np.array([0, 1])),
    "stats.mean": lambda x, q: stats.mean(x),
    "Rng": lambda x, q: Rng(0),
    "label.make_monotonic": lambda x, q: make_monotonic(np.array([3, 1, 3], np.int32)),
    "label.merge_labels": lambda x, q: merge_labels(np.array([1, 2]), np.array([2, 2]),
                                                    np.array([True, True])),
    "lap.solve_lap": lambda x, q: solve_lap(x[:4, :4]),
    "lap.LinearAssignmentProblem": lambda x, q: LinearAssignmentProblem().solve(
        np.stack([x[:4, :4]] * 2)),
    "sparse.COO": lambda x, q: COO(np.array([0]), np.array([1]), np.array([1.0]), (2, 2)),
    "sparse.CSR.from_dense": lambda x, q: CSR.from_dense(x),
    "sparse.convert.dense_to_csr": lambda x, q: sparse_convert.dense_to_csr(x),
    "sparse.op.max_duplicates": lambda x, q: sparse_op.max_duplicates(_cpu_coo(x)),
    "sparse.linalg.csr_spmv": lambda x, q: sparse_linalg.csr_spmv(_cpu_graph(x),
                                                                  np.ones(20, np.float32)),
    "sparse.linalg.weak_cc": lambda x, q: sparse_linalg.weak_cc(_cpu_graph(x)),
    "sparse.spectral.fit_embedding": lambda x, q: fit_embedding(_cpu_coo(x), 2),
    "sparse.distance.pairwise_distance": lambda x, q: sparse_distance.pairwise_distance(
        _cpu_graph(x), _cpu_graph(x)),
    "sparse.selection.brute_force_knn": lambda x, q: selection.brute_force_knn(
        _cpu_graph(x), _cpu_graph(x), 3),
    "sparse.selection.knn_graph": lambda x, q: selection.knn_graph(x, 3),
    "sparse.mst.mst": lambda x, q: mst(_cpu_graph(x)),
    "sparse.linkage.connect_components": lambda x, q: linkage.connect_components(
        x, np.arange(20, dtype=np.int32) % 2),
    "sparse.hierarchy.single_linkage": lambda x, q: hierarchy.single_linkage(x, 2),
    "spectral.partition": lambda x, q: spectral.partition(_cpu_graph(x)),
    "spectral.analyze_partition": lambda x, q: spectral.analyze_partition(
        _cpu_graph(x), 2, np.zeros(20, np.int32)),
    "spectral.modularity_maximization": lambda x, q: spectral.modularity_maximization(
        _cpu_graph(x)),
    "spectral.analyze_modularity": lambda x, q: spectral.analyze_modularity(
        _cpu_graph(x), 2, np.zeros(20, np.int32)),
    "spectral.transform_eigen_matrix": lambda x, q: transform_eigen_matrix(x),
    "fleet.Fleet": lambda x, q: Fleet(1, root=os.path.join(tempfile.gettempdir(), "no-fleet"),
                                      index_rows=20, dim=4, k=3),
}


@pytest.mark.parametrize("call", list(ENTRY_POINTS.values()), ids=list(ENTRY_POINTS))
def test_default_device_raises_without_cuda(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((20, 4)).astype(np.float32)
    q = rng.standard_normal((5, 4)).astype(np.float32)
    with pytest.raises(RaftError, match="CUDA"):
        call(x, q)


@pytest.mark.parametrize("cls", [raft_tpu_torch.KNNService, raft_tpu_torch.PairwiseService],
                         ids=lambda c: c.__name__)
def test_services_run_on_the_cpu_when_asked(cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).standard_normal((20, 4)).astype(np.float32)
    args = (x, 3) if cls is raft_tpu_torch.KNNService else (x,)
    svc = cls(*args, device="cpu", start=False)
    pinned = svc.index if hasattr(svc, "index") else svc.y
    assert svc.device.type == "cpu" and pinned.device.type == "cpu"
    fut = svc.submit(x[:2])
    svc.close()
    assert fut.exception(timeout=0) is None


def test_serve_worker_takes_its_device_explicitly():
    # no default device stands for the CPU
    batcher = MicroBatcher(max_batch_rows=8, max_wait_s=0.0, queue_cap=4)
    with pytest.raises(TypeError, match="device"):
        ServeWorker("w", batcher, BucketPolicy((8,)), lambda p: p)
    worker = ServeWorker("w", batcher, BucketPolicy((8,)), lambda p: p, device="cpu")
    assert worker.stream is None


def _no_build(monkeypatch):
    def refuse(name):
        raise AssertionError("kernel %s loaded for a CPU tensor" % name)
    monkeypatch.setattr(_build, "load", refuse)


def _ivf_args(g):
    sv = torch.randn(5, 12, 8, generator=g)
    si = torch.arange(60, dtype=torch.int32).reshape(5, 12)
    slots = torch.tensor([[0, 3, -1], [4, 1, 2]], dtype=torch.int32).repeat(4, 1)[:7]
    return sv, (sv * sv).sum(-1), si, slots


def _pq_args(g):
    """K7's operands for 7 queries of depth 8: 4 lists over 6 slots of 5
    rows (two vacant), 4 subspaces of 16 codewords, codes narrowed to 16
    bytes a row, 2 probes a query."""
    ids = torch.arange(30, dtype=torch.int32).reshape(6, 5)
    ids[2, 3:] = -1
    codes = torch.randint(0, 16, (6, 5, 4), generator=g)
    cent_slots = torch.tensor([[0, 1], [2, -1], [3, 4], [5, -1]], dtype=torch.int32)
    probes = torch.tensor([[0, 2], [1, 3], [2, 1]], dtype=torch.int32).repeat(3, 1)[:7]
    return (torch.randn(4, 8, generator=g), torch.randn(4, 16, 2, generator=g),
            pq_scan.narrow_codes(codes), ids, cent_slots, probes)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    _no_build(monkeypatch)
    before = inventory.snapshot()
    g = torch.Generator().manual_seed(0)
    x, q = torch.randn(300, 8, generator=g), torch.randn(7, 8, generator=g)
    ivf = _ivf_args(g)
    cents, books, codes, ids, cent_slots, probes = _pq_args(g)
    for got, want in [(fused_knn_tile(x, q, 5), knn_tile_plain(x, q, 5)),
                      (select_tile(x, 5), select_tile_plain(x, 5)),
                      (fused_nn_tile(q, x), nn_tile_plain(q, x)),
                      (fused_ivf_scan(q, *ivf, 5), fused_ivf_scan_plain(q, *ivf, 5)),
                      (twophase_tiles(x, q, 256), twophase_tiles_plain(x, q, 256)),
                      (pq_scan.ivf_pq_scan(q, cents, books, codes, ids, cent_slots, probes, 5),
                       pq_scan.ivf_pq_scan_plain(q, cents, books, codes.view(6, 5, -1), ids,
                                                 cent_slots, probes, 5))]:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        assert torch.equal(got[1], want[1])
    torch.testing.assert_close(pairwise_tile(q, x, DistanceType.L1),
                               pairwise_tile_plain(q, x, DistanceType.L1), rtol=0, atol=0)
    assert inventory.snapshot() == before


def test_non_cpu_tensors_never_fall_back(monkeypatch, tmp_path):
    # a tensor off the CPU goes to the kernel; when the kernel cannot be
    # built the wrapper raises instead of running the plain version
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: shutil.which("false") or "/bin/false")
    x = torch.empty((300, 8), device="meta")
    q = torch.empty((7, 8), device="meta")
    sv = torch.empty((5, 12, 8), device="meta")
    sn = torch.empty((5, 12), device="meta")
    si = torch.empty((5, 12), dtype=torch.int32, device="meta")
    slots = torch.empty((7, 3), dtype=torch.int32, device="meta")
    pq = [t.to("meta") for t in _pq_args(torch.Generator().manual_seed(0))]
    calls = [lambda: fused_knn_tile(x, q, 5), lambda: select_tile(x, 5),
             lambda: pairwise_tile(q, x, DistanceType.L1), lambda: fused_nn_tile(q, x),
             lambda: fused_ivf_scan(q, sv, sn, si, slots, 5),
             lambda: twophase_tiles(x, q, 256), lambda: fused_knn_twophase(x, q, 5),
             lambda: pq_scan.ivf_pq_scan(q, *pq, 5)]
    for call in calls:
        with pytest.raises(RaftError, match="nvcc failed"):
            call()
    assert not list(tmp_path.glob("*.tmp")), "failed builds leave no partial file"


def test_first_load_builds_and_loads_once(monkeypatch, tmp_path):
    # a serving worker and a caller reaching a library's first load
    # together: one build, one load, the same library for both
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_stats", {"builds": 0, "loads": 0})
    calls = {"build": 0, "cdll": 0}
    entered = threading.Barrier(2)

    def fake_build(names, phases=False):
        calls["build"] += 1
        _build._stats["builds"] += 1
        threading.Event().wait(0.2)     # a slow nvcc widens the race
        return {n: 0.0 for n in names}

    def fake_cdll(path):
        calls["cdll"] += 1
        return object()

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    got = []

    def first_use():
        entered.wait(5)
        got.append(_build.load("knn_twophase"))

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"build": 1, "cdll": 1}
    assert len(got) == 2 and got[0] is got[1]
    assert _build.stats() == {"builds": 1, "loads": 1}


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    (csrc / "warp_select.cuh").write_text((csrc / "warp_select.cuh").read_text() + "\n// edit\n")
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    assert all(before[n] != after[n] for n in _build.KERNELS)
    assert all(p.parent == _build.BUILD_DIR for p in after.values())


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs in full")
    # no card here: the script must exit non-zero and print no result,
    # from the repository and from a directory holding nothing else
    for cwd, script in [(ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, shutil.copy(ROOT / "chip_smoke.py", tmp_path))]:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=_clean_env(),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_utils():
    assert ceildiv(7, 3) == 3 and align(7, 4) == 8
    assert round_up_safe(7, 4) == 8 and round_up_safe(8, 4) == 8
    assert round_down_safe(7, 4) == 4 and round_down_safe(8, 4) == 8
    p = Pow2(32)
    assert (p.div(70), p.mod(70), p.round_down(70), p.round_up(70)) == (2, 6, 64, 96)
    assert p.is_aligned(64) and not p.is_aligned(65)
    with pytest.raises(raft_tpu_torch.LogicError):
        Pow2(12)


def test_distance_type_values_match_the_reference():
    from raft_tpu.distance.distance_type import DistanceType as JD

    assert {m.name: int(m) for m in DistanceType} == {m.name: int(m) for m in JD}
