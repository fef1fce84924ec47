"""Package rules of raft_tpu_torch: no JAX, explicit devices, kernel
wrappers that follow their tensor's device and never fall back."""

import ctypes
import os
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import raft_tpu_torch
from raft_tpu_torch import RaftError, linalg, matrix, stats
from raft_tpu_torch.cache import VecCache
from raft_tpu_torch.core.handle import Handle
from raft_tpu_torch.serve import BucketPolicy, MicroBatcher, ServeWorker
from raft_tpu_torch.core.utils import Pow2, align, ceildiv, round_down_safe, round_up_safe
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops.ivf_tile import fused_ivf_scan, fused_ivf_scan_plain, ivf_items
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
                                    "raft_tpu_torch.matrix", "raft_tpu_torch.stats"])
def test_serving_modules_pull_in_no_jax(module):
    code = ("import importlib, sys; importlib.import_module(%r); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'raft_tpu.'))"
            " or m == 'raft_tpu']; assert not bad, bad" % module)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                   check=True, timeout=120)


def test_sources_import_no_jax():
    banned = re.compile(r"\s*(from|import)\s+(jax|raft_tpu)(\.|\s|$)")
    for path in list((ROOT / "raft_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            assert not banned.match(line), (path, line)


def _cpu_index(x):
    return raft_tpu_torch.ivf_flat_build(x, raft_tpu_torch.IVFFlatParams(nlist=2), device="cpu")


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


WRAPPERS = (fused_knn_tile, select_tile, pairwise_tile, fused_nn_tile, ivf_items,
            twophase_tiles)


def _ivf_args(g):
    sv = torch.randn(5, 12, 8, generator=g)
    si = torch.arange(60, dtype=torch.int32).reshape(5, 12)
    slots = torch.tensor([[0, 3, -1], [4, 1, 2]], dtype=torch.int32).repeat(4, 1)[:7]
    return sv, (sv * sv).sum(-1), si, slots


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    _no_build(monkeypatch)
    before = [w.launches for w in WRAPPERS]
    g = torch.Generator().manual_seed(0)
    x, q = torch.randn(300, 8, generator=g), torch.randn(7, 8, generator=g)
    ivf = _ivf_args(g)
    for got, want in [(fused_knn_tile(x, q, 5), knn_tile_plain(x, q, 5)),
                      (select_tile(x, 5), select_tile_plain(x, 5)),
                      (fused_nn_tile(q, x), nn_tile_plain(q, x)),
                      (fused_ivf_scan(q, *ivf, 5), fused_ivf_scan_plain(q, *ivf, 5)),
                      (twophase_tiles(x, q, 256), twophase_tiles_plain(x, q, 256))]:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        assert torch.equal(got[1], want[1])
    torch.testing.assert_close(pairwise_tile(q, x, DistanceType.L1),
                               pairwise_tile_plain(q, x, DistanceType.L1), rtol=0, atol=0)
    assert [w.launches for w in WRAPPERS] == before


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
    calls = [lambda: fused_knn_tile(x, q, 5), lambda: select_tile(x, 5),
             lambda: pairwise_tile(q, x, DistanceType.L1), lambda: fused_nn_tile(q, x),
             lambda: fused_ivf_scan(q, sv, sn, si, slots, 5),
             lambda: twophase_tiles(x, q, 256), lambda: fused_knn_twophase(x, q, 5)]
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

    def fake_build(names):
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
