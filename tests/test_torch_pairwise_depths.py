"""K5's plain version (``raft_tpu_torch.ops.pairwise_tile``) against the
JAX ``pairwise_distance``, whose unexpanded metrics run the Pallas
``pairwise_tile`` in interpret mode, at the depths the kernel's staging
treats apart: 1 and 3 (one slab, mostly zero padding, scalar loads) and
300 (several slabs of 16 and a ragged last one).
``tests/test_torch_pairwise.py`` covers depths 7 and 150.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance import DistanceType as JD
from raft_tpu.distance.pairwise import pairwise_distance as jax_pairwise
from raft_tpu_torch.ops.pairwise_tile import METRICS, pairwise_tile

P = 3.0              # the Minkowski exponent of LpUnexpanded


def _inputs(m, n, d, metric, seed):
    rng = np.random.default_rng(seed)
    if metric.name == "HammingUnexpanded":
        # few distinct values, so that equal coordinates occur
        return (rng.integers(0, 3, (m, d)).astype(np.float32),
                rng.integers(0, 3, (n, d)).astype(np.float32))
    # non-negative: Jensen-Shannon takes logs
    return rng.random((m, d), dtype=np.float32), rng.random((n, d), dtype=np.float32)


@pytest.mark.parametrize("d", [1, 3, 300])
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_plain_matches_jax_at_depth(metric, d):
    m, n = 13, 21
    x, y = _inputs(m, n, d, metric, seed=d)
    ref = np.asarray(jax_pairwise(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                                  JD(int(metric)), metric_arg=P))
    got = pairwise_tile(torch.from_numpy(x), torch.from_numpy(y), metric, P)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    # float32 sums of d terms in another order: a few ulps times d
    tol = 2e-6 * max(d, 8)
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
