"""Port parity: ``spectral/kmeans.py``.

``jax.random`` cannot be reproduced in torch, so the Lloyd solve is held
to the JAX package from the JAX package's own k-means++ draw:
``kmeans(X, k, seed=s)`` there equals Lloyd started from
``init_plus_plus(X, k, PRNGKey(s))``, so the port's ``_lloyd`` from that
``C0`` must give the same labels, centroids, iteration count and
residual.  Seeded blob data keeps every point well away from a tie
between two centroids.  k-means++ itself is tested by its properties."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu_torch import LogicError, kmeans
from raft_tpu_torch.spectral.kmeans import (FUSED_ASSIGN_MIN_K, _lloyd, init_plus_plus,
                                            restart_generator)

jkm = importlib.import_module("raft_tpu.spectral.kmeans")

# centroids are means of the same rows summed in another order
C_ATOL, RES_RTOL = 1e-5, 1e-5


def _blobs(m, d, n_blobs, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_blobs, d)) * 4.0
    return (centers[rng.integers(0, n_blobs, m)]
            + rng.standard_normal((m, d)) * 0.35).astype(np.float32)


@pytest.mark.parametrize("m,n_blobs,k", [(2000, 20, 16), (3000, 400, 300)],
                         ids=["dense-assign", "fused-assign"])
def test_lloyd_from_jax_init_matches_jax_kmeans(m, n_blobs, k):
    X = _blobs(m, 8, n_blobs, seed=0)
    Xj = jnp.asarray(X, jnp.float32)
    ref = jkm.kmeans(Xj, k, seed=3)
    C0 = np.array(jkm.init_plus_plus(Xj, k, jax.random.PRNGKey(3)))
    C, labels, res, iters = _lloyd(torch.from_numpy(X), torch.from_numpy(C0), 1e-4, 300)
    assert (k >= FUSED_ASSIGN_MIN_K) == (k == 300)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(C.numpy(), np.asarray(ref.centroids), rtol=0, atol=C_ATOL)
    assert iters == int(ref.iters)
    np.testing.assert_allclose(float(res), float(ref.residual), rtol=RES_RTOL)


def test_lloyd_respects_max_iter():
    X = _blobs(1500, 6, 12, seed=1)
    Xj = jnp.asarray(X, jnp.float32)
    ref = jkm.kmeans(Xj, 12, seed=2, max_iter=2)
    C0 = np.array(jkm.init_plus_plus(Xj, 12, jax.random.PRNGKey(2)))
    C, labels, _, iters = _lloyd(torch.from_numpy(X), torch.from_numpy(C0), 1e-4, 2)
    assert iters == int(ref.iters) == 2
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref.labels))


def test_init_plus_plus_picks_distinct_rows():
    X = torch.from_numpy(_blobs(500, 4, 10, seed=2))
    C = init_plus_plus(X, 40, torch.Generator().manual_seed(0))
    rows = {tuple(r) for r in X.numpy().tolist()}
    picked = [tuple(r) for r in C.numpy().tolist()]
    assert all(p in rows for p in picked) and len(set(picked)) == 40


def test_init_plus_plus_falls_back_to_uniform_draws():
    # five distinct rows, each 20 times: after five picks every
    # min-distance is 0, and the rest of the draws are uniform
    X = torch.from_numpy(np.repeat(_blobs(5, 3, 5, seed=3), 20, axis=0))
    C = init_plus_plus(X, 30, torch.Generator().manual_seed(1))
    assert torch.isfinite(C).all()
    assert len({tuple(r) for r in C.numpy().tolist()}) == 5


def test_draws_are_reproducible():
    X = torch.from_numpy(_blobs(400, 4, 8, seed=4))
    a = init_plus_plus(X, 8, restart_generator(7, 0))
    b = init_plus_plus(X, 8, restart_generator(7, 0))
    c = init_plus_plus(X, 8, restart_generator(7, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    r1, r2 = kmeans(X, 8, seed=7, device="cpu"), kmeans(X, 8, seed=7, device="cpu")
    assert torch.equal(r1.centroids, r2.centroids) and torch.equal(r1.labels, r2.labels)


def test_n_init_keeps_the_lowest_residual():
    X = _blobs(800, 5, 6, seed=5)
    runs = [kmeans(X, 6, seed=11, n_init=1, device="cpu")]
    best = kmeans(X, 6, seed=11, n_init=4, device="cpu")
    for t in range(4):
        C0 = init_plus_plus(torch.from_numpy(X), 6, restart_generator(11, t))
        runs.append(_lloyd(torch.from_numpy(X), C0, 1e-4, 300))
    assert float(best.residual) == min(float(r[2]) for r in runs)
    assert float(best.residual) <= float(runs[0][2])


def test_kmeans_quality_against_jax():
    # different random streams, the same problem: both find the blobs
    X = _blobs(3000, 8, 10, seed=6)
    ref = jkm.kmeans(jnp.asarray(X, jnp.float32), 10, seed=0, n_init=3)
    got = kmeans(X, 10, seed=0, n_init=3, device="cpu")
    assert got.centroids.shape == (10, 8) and got.labels.shape == (3000,)
    assert float(got.residual) <= 1.05 * float(ref.residual)


def test_argument_checks():
    X = _blobs(50, 3, 2, seed=7)
    with pytest.raises(LogicError):
        kmeans(X, 51, device="cpu")
    with pytest.raises(LogicError):
        kmeans(X, 2, n_init=0, device="cpu")
    with pytest.raises(LogicError):
        kmeans(X[:, 0], 2, device="cpu")
