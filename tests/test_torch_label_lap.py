"""Port parity of the label utilities (raft_tpu_torch.label) and the
linear assignment solver (raft_tpu_torch.lap) against the JAX package,
on the CPU.

Labels are integers: every output is exactly the JAX package's.  The LAP
is held by its optimal cost: equal to the JAX package's and to
``scipy.optimize.linear_sum_assignment``'s within 1e-5 relative, single
and batched; where the optimum is tied, the assignment may differ, so
the test holds only that it is a permutation whose cost is the
objective.  Every port call passes ``device="cpu"``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from raft_tpu.label import get_ovr_labels as jovr
from raft_tpu.label import get_unique_labels as junique
from raft_tpu.label import make_monotonic as jmonotonic
from raft_tpu.label import merge_labels as jmerge
from raft_tpu.lap import LinearAssignmentProblem as JLAP
from raft_tpu.lap import solve_lap as jsolve_lap
from raft_tpu_torch import RaftError
from raft_tpu_torch.label import get_ovr_labels, get_unique_labels, make_monotonic, merge_labels
from raft_tpu_torch.lap import LinearAssignmentProblem, solve_lap

CPU = dict(device="cpu")
COST_RTOL = 1e-5


def _labels(n=60, seed=0, lo=-3, hi=40):
    return np.random.default_rng(seed).integers(lo, hi, n).astype(np.int32)


# ---------------------------------------------------------------------- #
# labels
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("max_labels", [None, 60, 43])
def test_unique_labels(max_labels):
    x = _labels()
    uniq, n_unique = get_unique_labels(x, max_labels, **CPU)
    juniq, jn = junique(jnp.asarray(x), max_labels)
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))
    assert int(n_unique) == int(jn) == len(np.unique(x))


@pytest.mark.parametrize("zero_based", [False, True])
@pytest.mark.parametrize("noise", [False, True])
def test_make_monotonic(zero_based, noise):
    x = _labels(seed=1)
    filt = (lambda v: v < 0) if noise else None
    got = make_monotonic(x, zero_based, filt, **CPU)
    ref = jmonotonic(jnp.asarray(x), zero_based, filt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_ovr_labels():
    x = _labels(seed=2)
    uniq, _ = get_unique_labels(x, **CPU)
    juniq, _ = junique(jnp.asarray(x))
    for idx in (0, 3, 7):
        np.testing.assert_array_equal(get_ovr_labels(x, uniq, idx, **CPU).numpy(),
                                      np.asarray(jovr(jnp.asarray(x), juniq, idx)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_labels(seed):
    # two 1-based labellings of N points, joined where the mask is set;
    # long chains need several sweeps to reach the fixpoint
    rng = np.random.default_rng(seed)
    n = 200
    a = rng.integers(1, n // 4, n).astype(np.int32)
    b = rng.integers(1, n // 4, n).astype(np.int32)
    mask = rng.random(n) < (0.1 + 0.2 * seed)
    got = merge_labels(a, b, mask, **CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jmerge(jnp.asarray(a), jnp.asarray(b),
                                                    jnp.asarray(mask))))


# ---------------------------------------------------------------------- #
# linear assignment
# ---------------------------------------------------------------------- #
def _costs(shape, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:                                  # many tied optima
        return rng.integers(0, 5, shape).astype(np.float32)
    return rng.random(shape).astype(np.float32) * 10.0


def _check_assignment(res, cost):
    """A complete permutation whose cost is the objective."""
    rows = res.row_assignment.numpy()
    cols = res.col_assignment.numpy()
    n = cost.shape[0]
    assert res.row_assignment.dtype == torch.int32 and bool(res.complete)
    assert sorted(rows.tolist()) == list(range(n))
    np.testing.assert_array_equal(cols[rows], np.arange(n))
    np.testing.assert_allclose(float(res.obj_val), cost[np.arange(n), rows].sum(), rtol=1e-6)


@pytest.mark.parametrize("n,integer", [(8, False), (30, False), (30, True), (60, False)])
def test_solve_lap_optimal_cost(n, integer):
    cost = _costs((n, n), n, integer)
    got = solve_lap(cost, **CPU)
    _check_assignment(got, cost)
    r, c = linear_sum_assignment(cost)
    opt = cost[r, c].sum()
    np.testing.assert_allclose(float(got.obj_val), opt, rtol=COST_RTOL)
    np.testing.assert_allclose(float(got.obj_val), float(jsolve_lap(jnp.asarray(cost)).obj_val),
                               rtol=COST_RTOL)
    assert got.row_duals.shape == (n,) and got.col_duals.shape == (n,)


@pytest.mark.parametrize("integer", [False, True])
def test_batched_lap_optimal_costs(integer):
    costs = _costs((5, 24, 24), 3, integer)
    got = LinearAssignmentProblem().solve(costs, **CPU)
    ref = JLAP().solve(jnp.asarray(costs))
    assert got.obj_val.shape == (5,) and bool(got.complete.all())
    np.testing.assert_allclose(got.obj_val.numpy(), np.asarray(ref.obj_val), rtol=COST_RTOL)
    for b in range(5):
        r, c = linear_sum_assignment(costs[b])
        np.testing.assert_allclose(float(got.obj_val[b]), costs[b][r, c].sum(), rtol=COST_RTOL)
        _check_assignment(type(got)(*(t[b] for t in got)), costs[b])
    # a batch element solves as it does alone
    one = LinearAssignmentProblem().solve(costs[2], **CPU)
    np.testing.assert_allclose(float(one.obj_val), float(got.obj_val[2]), rtol=COST_RTOL)


def test_round_cap_leaves_the_assignment_incomplete():
    cost = _costs((20, 20), 5)
    got = solve_lap(cost, max_rounds=1, **CPU)
    ref = jsolve_lap(jnp.asarray(cost), max_rounds=1)
    assert bool(got.complete) == bool(ref.complete) is False
    assert np.isinf(float(got.obj_val)) and np.isinf(float(ref.obj_val))


def test_lap_rejects_non_square():
    with pytest.raises(RaftError, match="square"):
        solve_lap(np.zeros((3, 4), np.float32), **CPU)
    with pytest.raises(RaftError, match="SP, N, N"):
        LinearAssignmentProblem().solve(np.zeros((2, 3, 4), np.float32), **CPU)
