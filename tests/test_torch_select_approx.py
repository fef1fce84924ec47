"""The port's ``select_impl="approx95"``: the TPU's approximate top-k at
recall target 0.95 (``raft_tpu_torch/spatial/select_k.py``).

JAX's ``lax.approx_max_k`` falls back to an exact top-k off the TPU, so
the port is not held to JAX's bits here.  It is held to what defines the
TPU's result: the bin count L and fold count r of jaxlib's
``approx_top_k_reduction_output_size``, a numpy emulation of the fold
(bitwise), exactness where r is 0, and recall against JAX's exact select.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax._src.lib import _jax

from raft_tpu_torch import ANNService, config
from raft_tpu_torch.ops.knn_tile import fused_knn_twophase, knn_twophase_plain, twophase_tiles
from raft_tpu_torch.spatial.fused_l2_knn import fused_l2_knn
from raft_tpu_torch.spatial.select_k import (APPROX_RECALL, approx95_cols, approx_bins,
                                             approx_fold, select_k, top_k_rows)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    # no process-wide select_impl reaches these tests but the one they set
    monkeypatch.setattr(config, "_values", {})
    monkeypatch.setattr(config, "_table", None)
    monkeypatch.setattr(config, "_table_env_checked", True)
    for env, _, _ in config._KNOBS.values():
        monkeypatch.delenv(env, raising=False)
    yield


def _keys(m, n, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).random((m, n)).astype(dtype)


# ---------------------------------------------------------------------- #
# L and r: jaxlib's rule
# ---------------------------------------------------------------------- #
_NS = [1, 100, 128, 129, 200, 1000, 1930, 4000, 8192, 10_000, 65_536, 100_000, 131_072,
       500_000, 1_000_000, 3_000_000]
_KS = [1, 2, 5, 10, 32, 64, 100, 128, 256, 1000]


@pytest.mark.parametrize("recall", [0.5, 0.9, APPROX_RECALL, 0.99, 1.0])
def test_bins_follow_jaxlib(recall):
    rng = np.random.default_rng(int(recall * 100))
    ns = _NS + [int(v) for v in rng.integers(1, 5_000_000, 60)]
    for n in ns:
        for k in _KS:
            if k <= n:
                want = tuple(_jax.approx_top_k_reduction_output_size(n, 2, k, recall, False, -1))
                assert approx_bins(n, k, recall) == want, (n, k, recall)


def test_bins_of_the_smoke_shapes():
    assert [approx_bins(n, k) for n, k in [(8192, 100), (100_000, 100), (1_000_000, 100),
                                            (1_000_000, 10)]] == \
        [(2048, 2), (3200, 5), (2048, 9), (256, 12)]


# ---------------------------------------------------------------------- #
# the fold, bitwise against numpy
# ---------------------------------------------------------------------- #
def _fold_numpy(keys, bins, folds):
    m, n = keys.shape
    x = np.full((m, bins << folds), np.inf, np.float32)
    x[:, :n] = keys
    col = np.broadcast_to(np.arange(x.shape[1], dtype=np.int32), x.shape)
    for _ in range(folds):
        h = x.shape[1] // 2
        a, b = x[:, :h], x[:, h:]
        take = (b < a) | (np.isnan(a) & ~np.isnan(b))
        x = np.where(take, b, a)
        col = np.where(take, col[:, h:], col[:, :h])
    return x, col


def _approx_numpy(keys, k):
    """The whole select in numpy: the fold, then the first k of a stable
    sort of the winners (NaN last: K2's order; the rows here keep a key
    that is not NaN in every bin)."""
    n = keys.shape[1]
    bins, folds = approx_bins(n, k)
    win, col = _fold_numpy(keys, bins, folds)
    pos = np.argsort(win, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(win, pos, 1), np.minimum(np.take_along_axis(col, pos, 1), n - 1)


@pytest.mark.parametrize("m,n,k", [(7, 8192, 100), (5, 100_000, 100), (3, 20_000, 10),
                                   (9, 1000, 1), (4, 12_000, 128)])
def test_fold_matches_numpy_bitwise(m, n, k):
    keys = _keys(m, n, seed=n)
    keys[0, ::7] = np.inf
    keys[1, 3::5] = np.nan
    bins, folds = approx_bins(n, k)
    assert folds > 0
    win, col = approx_fold(torch.from_numpy(keys), bins, folds)
    want_w, want_c = _fold_numpy(keys, bins, folds)
    np.testing.assert_array_equal(win.numpy().view(np.int32), want_w.view(np.int32))
    np.testing.assert_array_equal(col.numpy(), want_c)
    # every column lands in its bin, column mod L
    assert ((col.numpy() % bins) == np.arange(bins)[None, :]).all()
    vals, cols = approx95_cols(torch.from_numpy(keys), k, True)
    want_v, want_i = _approx_numpy(keys, k)
    np.testing.assert_array_equal(vals.numpy(), want_v)
    np.testing.assert_array_equal(cols.numpy(), want_i)


def test_fold_keeps_the_smaller_column_on_ties():
    keys = np.zeros((2, 4096), np.float32)        # every key ties
    bins, folds = approx_bins(4096, 10)
    _, col = approx_fold(torch.from_numpy(keys), bins, folds)
    np.testing.assert_array_equal(col.numpy(), np.broadcast_to(np.arange(bins), (2, bins)))


# ---------------------------------------------------------------------- #
# exact at r = 0; recall otherwise
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("m,n,k", [(6, 100, 10), (4, 128, 128), (5, 300, 100), (3, 1500, 90)])
def test_exact_where_nothing_folds(m, n, k):
    assert approx_bins(n, k)[1] == 0
    keys = torch.from_numpy(_keys(m, n, seed=k))
    for select_min in (True, False):
        got = select_k(keys, k, select_min=select_min, impl="approx95", device=CPU)
        want = select_k(keys, k, select_min=select_min, impl="sort", device=CPU)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,k", [(8192, 100), (100_000, 100), (200_000, 10)])
def test_recall_against_jax_exact(n, k):
    keys = _keys(32, n, seed=n + k)
    _, ref_i = lax.top_k(-jnp.asarray(keys), k)
    got_d, got_i = select_k(keys, k, impl="approx95", device=CPU)
    ref_i = np.asarray(ref_i)
    recall = np.mean([len(set(a) & set(b)) / k for a, b in zip(got_i.numpy(), ref_i)])
    assert recall >= 0.9, recall
    assert (np.diff(got_d.numpy(), axis=1) >= 0).all()
    np.testing.assert_array_equal(got_d.numpy(), np.take_along_axis(keys, got_i.numpy(), 1))


def test_largest_is_the_smallest_of_the_negated_keys():
    keys = torch.from_numpy(_keys(5, 50_000, seed=9))
    d_max, i_max = top_k_rows(keys, 20, impl="approx95")
    d_min, i_min = select_k(-keys, 20, impl="approx95", device=CPU)
    assert torch.equal(d_max, -d_min) and torch.equal(i_max, i_min)


def test_float_keys_only():
    with pytest.raises(Exception, match="float keys"):
        select_k(torch.arange(2000).reshape(2, 1000), 5, impl="approx95", device=CPU)


# ---------------------------------------------------------------------- #
# where the knob reaches, and where it does not
# ---------------------------------------------------------------------- #
def test_env_select_impl_reaches_select_k(monkeypatch):
    keys = torch.from_numpy(_keys(6, 30_000, seed=4))
    want = select_k(keys, 50, impl="approx95", device=CPU)
    exact = select_k(keys, 50, device=CPU)
    monkeypatch.setenv("RAFT_TPU_SELECT_IMPL", "approx95")
    got = select_k(keys, 50, device=CPU)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[1], exact[1])


def test_env_select_impl_reaches_the_tile_scan(monkeypatch):
    # the scan's tiles of 8,192 fold to 2,048 bins at k 100; its merges of
    # 2k columns do not fold (r = 0), so they stay exact
    rng = np.random.default_rng(5)
    x = rng.standard_normal((20_000, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    exact_d, exact_i = fused_l2_knn(x, q, 100, impl="scan", device=CPU)
    monkeypatch.setenv("RAFT_TPU_SELECT_IMPL", "approx95")
    got_d, got_i = fused_l2_knn(x, q, 100, impl="scan", device=CPU)
    recall = np.mean([len(set(a) & set(b)) / 100 for a, b in zip(got_i.numpy(),
                                                                  exact_i.numpy())])
    assert 0.9 <= recall < 1.0, recall
    assert approx_bins(200, 100) == (200, 0)


def test_k6_merge_is_argument_only(monkeypatch):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((3000, 8)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    exact = fused_knn_twophase(x, q, 10, block_n=256)
    approx = fused_knn_twophase(x, q, 10, block_n=256, merge_select_impl="approx95")
    assert torch.equal(exact[0], knn_twophase_plain(x, q, 10, 256)[0])
    part_d, part_i = twophase_tiles(x, q, 256)
    want = select_k(part_d, 10, values=part_i, impl="approx95", device=CPU)
    assert torch.equal(approx[0], want[0]) and torch.equal(approx[1], want[1])
    # a process-wide select_impl never reaches the merge
    monkeypatch.setenv("RAFT_TPU_SELECT_IMPL", "approx95")
    again = fused_knn_twophase(x, q, 10, block_n=256)
    assert torch.equal(again[0], exact[0]) and torch.equal(again[1], exact[1])


def test_ann_service_takes_approx95():
    from raft_tpu_torch import IVFFlatParams, ivf_flat_build

    rng = np.random.default_rng(7)
    x = rng.standard_normal((3000, 8)).astype(np.float32)
    index = ivf_flat_build(x, IVFFlatParams(nlist=8, nprobe=8), device=CPU)
    svc = ANNService(index, 10, start=False, device=CPU, select_impl="approx95", nprobe=8,
                     nprobe_ladder=(8,), bucket_rungs=(8,), max_wait_ms=0.0)
    try:
        fut = svc.submit(x[:5])
        assert svc.worker.run_once()
        d, i = fut.result(timeout=0)
        assert d.shape == (5, 10) and (i[:, 0].numpy() == np.arange(5)).all()
    finally:
        svc.close(drain=False)
