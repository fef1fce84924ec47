"""The port's float32 products run in IEEE float32 whatever the caller's
matmul-precision setting, and the caller's setting survives each call
(``raft_tpu_torch.core.precision``).

Each of the port's float32 product sites runs here with the caller's
setting on TF32 (``torch.set_float32_matmul_precision("high")``), under a
spy on ``torch.matmul`` and ``torch.bmm`` that records, at the moment of
each call, whether torch's flags ask for IEEE float32.
"""

import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from raft_tpu_torch import (DistanceType, IVFFlatParams, RaftError, ivf_flat_build,
                            ivf_flat_search, kmeans,
                            linalg)
from raft_tpu_torch.core import precision
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.ops.ivf_tile import fused_ivf_scan_plain
from raft_tpu_torch.ops.knn_tile import knn_tile_plain, twophase_tiles_plain
from raft_tpu_torch.ops.nn_tile import nn_tile_plain
from raft_tpu_torch.spatial.ann import _delta_merge_impl
from raft_tpu_torch import spectral
from raft_tpu_torch.sparse import CSR
from raft_tpu_torch.sparse import distance as sparse_distance
from raft_tpu_torch.sparse import linkage

D = DistanceType


def _flags():
    """Every matmul-precision flag torch lets us read."""
    out = {}
    try:
        out["legacy"] = torch.get_float32_matmul_precision()
    except RuntimeError:
        out["legacy"] = "unreadable"
    if hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        out["cuda"] = torch.backends.cuda.matmul.fp32_precision
        out["mkldnn"] = torch.backends.mkldnn.matmul.fp32_precision
    return out


@pytest.fixture
def tf32_caller():
    """The caller asks for TF32 products; the default comes back after."""
    torch.set_float32_matmul_precision("high")
    yield _flags()
    torch.set_float32_matmul_precision("highest")
    if hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        torch.backends.cuda.matmul.fp32_precision = "none"
        torch.backends.mkldnn.matmul.fp32_precision = "none"


@pytest.fixture
def spy(monkeypatch):
    """Records precision.is_ieee() at each torch.matmul / torch.bmm call."""
    seen = []
    for name in ("matmul", "bmm"):
        real = getattr(torch, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            seen.append((_name, precision.is_ieee()))
            return _real(*a, **kw)

        monkeypatch.setattr(torch, name, wrapped)
    return seen


def _f32(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


def _ivf_index():
    x = _f32(400, 8, seed=1)
    return ivf_flat_build(x, IVFFlatParams(nlist=8, nprobe=3), D.L2Expanded, device="cpu")


def _site_pairwise():
    pairwise_distance(_f32(9, 8), _f32(11, 8, seed=1), D.L2Expanded, device="cpu")


def _site_kmeans_assign():
    kmeans(_f32(200, 6), 5, max_iter=3, device="cpu")       # k < 256: the matmul route


def _site_delta_merge():
    q, dv = _f32(5, 8), _f32(12, 8, seed=1)
    ids = torch.arange(12, dtype=torch.int32)
    base_d = torch.full((5, 4), float("inf"))
    base_i = torch.full((5, 4), -1, dtype=torch.int32)
    _delta_merge_impl(dv, ids, base_d, base_i, q, 4, False)


def _site_scan_route():
    ivf_flat_search(_ivf_index(), _f32(6, 8, seed=2), 5, scan_impl="scan",
                    device="cpu")


def _site_knn_tile_plain():
    knn_tile_plain(_f32(300, 8), _f32(7, 8, seed=1), 5)


def _site_twophase_plain():
    twophase_tiles_plain(_f32(300, 8), _f32(7, 8, seed=1), 256)


def _site_nn_tile_plain():
    nn_tile_plain(_f32(50, 8), _f32(9, 8, seed=1))


def _site_ivf_scan_plain():
    S, cap, d, nq = 4, 10, 8, 5
    sv = _f32(S, cap, d)
    si = torch.arange(S * cap, dtype=torch.int32).reshape(S, cap)
    slots = torch.tensor([[0, 1], [2, 3], [1, -1], [3, 0], [2, 2]], dtype=torch.int32)
    fused_ivf_scan_plain(_f32(nq, d, seed=1), sv, (sv * sv).sum(-1), si, slots, 3)


def _site_gemm():
    linalg.gemm(_f32(9, 8), _f32(8, 5, seed=1), device="cpu")


def _site_gemv():
    linalg.gemv(_f32(9, 8), _f32(8, seed=1), device="cpu")


def _site_svd_eig():
    linalg.svd_eig(_f32(12, 5), device="cpu")


def _site_svd_reconstruction():
    linalg.svd_reconstruction(_f32(6, 3), _f32(3, seed=1), _f32(4, 3, seed=2), device="cpu")


def _site_lanczos():
    a = _f32(40, 40)
    linalg.compute_smallest_eigenvectors(a + a.T, 40, 2, maxiter=60, device="cpu")


def _graph():
    adj = (_f32(30, 30) < 0.3).to(torch.float32)
    return CSR.from_dense(torch.triu(adj, 1) + torch.triu(adj, 1).T, device="cpu")


def _site_dense_operator():
    spectral.LaplacianMatrix(_graph(), densify=True).mv(_f32(30, seed=1))


def _site_partition():
    # the sparse operator makes no product; Lanczos and the k-means
    # assignment do
    spectral.partition(_graph(), device="cpu")


def _sparse_pair():
    a = _f32(9, 16) * (_f32(9, 16, seed=1) < 0.4)
    b = _f32(7, 16, seed=2) * (_f32(7, 16, seed=3) < 0.4)
    return CSR.from_dense(a, device="cpu"), CSR.from_dense(b, device="cpu")


def _site_sparse_coltiled_mm():
    # the column-tiled engine's cross term of the "mm" family
    sparse_distance.pairwise_distance(*_sparse_pair(), D.CosineExpanded, batch_size_k=5,
                                      device="cpu")


def _site_sparse_binary_expanded():
    # Jaccard on full-width blocks: binarised inner products
    sparse_distance.pairwise_distance(*_sparse_pair(), D.JaccardExpanded, device="cpu")


def _site_connect_scan():
    # the components fix-up's masked 1-NN scan
    colors = torch.arange(40, dtype=torch.int32) % 3
    linkage.connect_components(_f32(40, 3), colors, device="cpu")


SITES = {
    "distance/pairwise.py matmul": _site_pairwise,
    "spectral/kmeans.py _assign": _site_kmeans_assign,
    "spatial/ann.py delta merge": _site_delta_merge,
    "spatial/ann.py scan route": _site_scan_route,
    "ops/knn_tile.py knn_tile_plain": _site_knn_tile_plain,
    "ops/knn_tile.py twophase_tiles_plain": _site_twophase_plain,
    "ops/nn_tile.py nn_tile_plain": _site_nn_tile_plain,
    "ops/ivf_tile.py plain scan": _site_ivf_scan_plain,
    "linalg/gemm.py gemm": _site_gemm,
    "linalg/gemm.py gemv": _site_gemv,
    "linalg/svd.py svd_eig": _site_svd_eig,
    "linalg/svd.py svd_reconstruction": _site_svd_reconstruction,
    "linalg/lanczos.py": _site_lanczos,
    "spectral/matrix_wrappers.py dense operator": _site_dense_operator,
    "spectral/partition.py": _site_partition,
    "sparse/distance.py column-tiled product": _site_sparse_coltiled_mm,
    "sparse/distance.py _binary_expanded": _site_sparse_binary_expanded,
    "sparse/linkage.py connect scan": _site_connect_scan,
}


@pytest.mark.parametrize("site", list(SITES), ids=list(SITES))
def test_site_runs_in_ieee_float32(site, tf32_caller, spy):
    assert not precision.is_ieee()
    SITES[site]()
    assert spy, "%s made no product through torch.matmul or torch.bmm" % site
    assert all(ieee for _, ieee in spy), spy
    assert _flags() == tf32_caller


def test_gemm_default_precision_pins_tf32_for_the_call(tf32_caller, spy, monkeypatch):
    # the JAX default precision: the card's TF32 mode, pinned for that call
    # only, whatever the caller set, and the caller's setting back after
    torch.set_float32_matmul_precision("highest")
    before = _flags()
    seen = []
    real = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda *a: (seen.append(precision._is("tf32")),
                                                     real(*a))[1])
    linalg.gemm(_f32(9, 8), _f32(8, 5, seed=1), precision="default", device="cpu")
    assert seen == [True]
    assert _flags() == before and precision.is_ieee()


def test_the_two_modes_wait_for_each_other(tf32_caller):
    # a TF32 call in one thread, an IEEE call in another: the second waits
    # until the first pin is released, so neither runs under the other's
    inside, release, order = threading.Event(), threading.Event(), []

    def worker():
        with precision.tf32():
            inside.set()
            release.wait(10)
            order.append(("tf32", precision._is("tf32")))

    t = threading.Thread(target=worker)
    t.start()
    assert inside.wait(10)
    threading.Timer(0.2, release.set).start()
    with precision.ieee_fp32():
        order.append(("ieee", precision.is_ieee()))
    t.join(10)
    assert not t.is_alive()
    assert order == [("tf32", True), ("ieee", True)]
    assert _flags() == tf32_caller


def test_the_other_mode_inside_a_pin_of_the_same_thread_raises(tf32_caller):
    # a thread that holds a pin would wait on itself for the other mode:
    # it raises instead, and the pin it holds is released as usual
    with precision.ieee_fp32():
        with precision.ieee_fp32():                 # the same mode nests
            assert precision.is_ieee()
        with pytest.raises(RaftError, match="do not nest"):
            with precision.tf32():
                pass
        assert precision.is_ieee()
    with precision.tf32():
        with pytest.raises(RaftError, match="do not nest"):
            precision.matmul(_f32(3, 3), _f32(3, 3))
    assert _flags() == tf32_caller


def test_lanczos_holds_no_pin_around_the_callers_operator(tf32_caller):
    # the operator makes TF32 products (gemv at precision="default") and
    # waits, in its first call, for a TF32 product of another thread: with
    # a pin held over the whole solve the first would raise and the second
    # would wait for the solve to end
    a = _f32(48, 48)
    a = a + a.T
    seen = []

    def other_thread_tf32():
        t = threading.Thread(target=lambda: seen.append(
            ("thread", linalg.gemm(a, a, precision="default", device="cpu").shape)))
        t.start()
        t.join(10)
        assert not t.is_alive(), "a TF32 product of another thread waited for the solve"

    def mv(x):
        if not seen:
            other_thread_tf32()
        seen.append(("mv", precision.is_ieee()))
        return linalg.gemv(a, x, precision="default", device="cpu")

    vals, vecs, _ = linalg.compute_smallest_eigenvectors(mv, 48, 3, maxiter=480, device="cpu")
    ref, _, _ = linalg.compute_smallest_eigenvectors(a, 48, 3, maxiter=480, device="cpu")
    torch.testing.assert_close(vals, ref, rtol=1e-4, atol=1e-4)
    assert seen[0] == ("thread", (48, 48))
    # the operator runs with the caller's own setting (TF32), pinned by no one
    assert all(mode is False for tag, mode in seen[1:]), seen
    assert _flags() == tf32_caller


def test_import_changes_no_flag():
    code = ("import torch\n"
            "torch.set_float32_matmul_precision('high')\n"
            "before = torch.get_float32_matmul_precision()\n"
            "import raft_tpu_torch, raft_tpu_torch.ops, raft_tpu_torch.serve\n"
            "assert torch.get_float32_matmul_precision() == before == 'high'\n"
            "print('unchanged')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "unchanged" in out.stdout, out.stderr


@pytest.mark.parametrize("setting", ["high", "medium", "backend-tf32"])
def test_caller_setting_restored(setting, tf32_caller):
    if setting == "backend-tf32" and hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        # the per-backend settings alone (the legacy one left at "highest")
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.fp32_precision = "tf32"
        torch.backends.mkldnn.matmul.fp32_precision = "bf16"
    else:
        torch.set_float32_matmul_precision("high" if setting == "backend-tf32" else setting)
    before = _flags()
    with precision.ieee_fp32():
        assert precision.is_ieee()
        inside = _flags()
        assert inside.get("cuda", "ieee") == "ieee" and inside.get("mkldnn", "ieee") == "ieee"
    assert _flags() == before


def test_default_setting_is_left_unwritten(monkeypatch):
    # with the flags already at IEEE float32 the helper writes nothing
    calls = []
    monkeypatch.setattr(torch, "set_float32_matmul_precision",
                        lambda *a: calls.append(a))
    with precision.ieee_fp32():
        pass
    assert calls == []


def test_concurrent_calls_share_one_pin(tf32_caller):
    # two port calls overlap in two threads: the flags stay pinned until
    # the last one leaves, then the caller's setting is back
    inside, release = threading.Event(), threading.Event()
    seen = []

    def worker():
        with precision.ieee_fp32():
            inside.set()
            release.wait(10)
            seen.append(precision.is_ieee())

    t = threading.Thread(target=worker)
    t.start()
    assert inside.wait(10)
    with precision.ieee_fp32():
        seen.append(precision.is_ieee())
    seen.append(precision.is_ieee())       # the worker still holds the pin
    release.set()
    t.join(10)
    assert seen == [True, True, True]
    assert _flags() == tf32_caller


def test_product_matches_float64():
    # the helper's product is the float32 product: within float32's
    # rounding of a float64 reference
    a, b = _f32(17, 300), _f32(300, 13, seed=1)
    got = precision.matmul(a, b)
    ref = (a.double() @ b.double()).float()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    got = precision.bmm(a[None], b[None])[0]
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
