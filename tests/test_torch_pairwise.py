"""Port parity: raft_tpu_torch pairwise_distance / K5 vs the JAX package.

The JAX side runs its Pallas pairwise kernel in interpret mode for the
unexpanded metrics; the port runs K5's plain version on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance import DistanceType as JD
from raft_tpu.distance.pairwise import pairwise_distance as jax_pairwise
from raft_tpu_torch import DistanceType, LogicError, pairwise_distance
from raft_tpu_torch.ops.pairwise_tile import (METRICS, pairwise_tile,
                                              pairwise_tile_plain)

D = DistanceType

ALL_METRICS = [D.L2Expanded, D.L2SqrtExpanded, D.CosineExpanded,
               D.CorrelationExpanded, D.InnerProduct, D.HellingerExpanded,
               D.RusselRaoExpanded, D.KLDivergence, D.L1, D.L2Unexpanded,
               D.L2SqrtUnexpanded, D.Linf, D.Canberra, D.LpUnexpanded,
               D.HammingUnexpanded, D.JensenShannon, D.BrayCurtis]

# ragged in every dimension, and a depth that crosses the JAX kernel's
# 128-deep tile
SHAPES = [(19, 23, 7), (20, 24, 150)]


def _inputs(m, n, d, metric, seed=0):
    rng = np.random.default_rng(seed)
    if metric == D.HammingUnexpanded:
        # few distinct values, so that equal coordinates occur
        x = rng.integers(0, 3, (m, d)).astype(np.float32)
        y = rng.integers(0, 3, (n, d)).astype(np.float32)
    else:
        # non-negative: KL, Hellinger and Jensen-Shannon take logs / roots
        x = rng.random((m, d), dtype=np.float32)
        y = rng.random((n, d), dtype=np.float32)
    return x, y


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m.name)
def test_pairwise_matches_jax(metric, shape):
    m, n, d = shape
    x, y = _inputs(m, n, d, metric)
    ref = np.asarray(jax_pairwise(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                                  JD(int(metric)), metric_arg=3.0))
    got = pairwise_distance(x, y, metric, metric_arg=3.0, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (m, n)
    # float32 sums over d terms in another order: relative error of a few
    # ulps times d.  Correlation and KL subtract nearly equal terms, so
    # their absolute error is set by the operands' scale (about d).
    tol = 2e-6 * d
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_pairwise_tile_plain_takes_integer_inputs(metric):
    rng = np.random.default_rng(1)
    xi = torch.from_numpy(rng.integers(0, 5, (9, 13)).astype(np.int32))
    yi = torch.from_numpy(rng.integers(0, 5, (11, 13)).astype(np.int32))
    got = pairwise_tile(xi, yi, metric, 3.0)
    assert got.dtype == torch.float32
    want = pairwise_tile_plain(xi.float(), yi.float(), metric, 3.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_plain_version_chunks_rows_exactly():
    # the plain version cuts x into row chunks; the cut must not change
    # any value (every row's reduction is independent)
    x, y = _inputs(300, 40, 33, D.L1)
    whole = pairwise_tile_plain(torch.from_numpy(x), torch.from_numpy(y), D.L1)
    rows = [pairwise_tile_plain(torch.from_numpy(x[i:i + 1]), torch.from_numpy(y), D.L1)
            for i in (0, 157, 299)]
    for i, r in zip((0, 157, 299), rows):
        torch.testing.assert_close(whole[i:i + 1], r, rtol=0, atol=0)


def test_unsupported_metric_raises():
    x, y = _inputs(4, 5, 3, D.L1)
    with pytest.raises(LogicError):
        pairwise_distance(x, y, D.JaccardExpanded, device="cpu")
    with pytest.raises(LogicError):
        pairwise_tile(torch.from_numpy(x), torch.from_numpy(y), D.CosineExpanded)
