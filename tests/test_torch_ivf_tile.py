"""Port parity: K3's plain version (``fused_ivf_scan_plain``) vs the JAX
package's ``fused_ivf_scan_xla`` (the op-for-op oracle of the Pallas
kernel) in float32 and bfloat16, and one small case against the Pallas
``fused_ivf_scan`` in interpret mode (the stores of
``tests/test_fused_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_knn_close
from raft_tpu.ops.ivf_tile import fused_ivf_scan as jax_fused_ivf_scan
from raft_tpu.ops.ivf_tile import fused_ivf_scan_xla
from raft_tpu_torch import LogicError
from raft_tpu_torch.ops.ivf_tile import fused_ivf_scan, fused_ivf_scan_plain

# expanded-form float32 in another order: a few ulps of |q|^2 + |v|^2
RTOL, ATOL = 1e-5, 1e-4
# bf16 operands: the port and the JAX bf16 oracle round the same values and
# differ in the order of the float32 sums; against float32 the rounding
# itself shows (the tolerance of tests/test_fused_kernels.py)
BF16_ATOL, BF16_TRUTH_ATOL = 1e-3, 5e-2


def _rand(shape, seed):
    return np.random.RandomState(seed).random(shape).astype(np.float32)


def _slot_store(S, cap, d, seed, vacancy_rows=0):
    rng = np.random.RandomState(seed)
    sv = rng.random((S, cap, d)).astype(np.float32)
    sn = (sv * sv).sum(-1).astype(np.float32)
    si = np.arange(S * cap, dtype=np.int32).reshape(S, cap)
    if vacancy_rows:
        si[:, cap - vacancy_rows:] = -1
        sv[:, cap - vacancy_rows:] = 0.0
        sn[:, cap - vacancy_rows:] = 0.0
    return sv, sn, si


def _case(S, cap, d, nq, n_steps, seed, vacancy_rows):
    sv, sn, si = _slot_store(S, cap, d, seed, vacancy_rows)
    q = _rand((nq, d), seed + 1)
    rng = np.random.RandomState(seed + 2)
    slots = np.stack([rng.permutation(S)[:n_steps] for _ in range(nq)]).astype(np.int32)
    slots[0, 2:] = -1                    # a short scan list
    slots[1, :] = -1                     # a query with nothing to scan
    return q, sv, sn, si, slots


def _run(args, k, accum_bf16=False):
    jargs = [jnp.asarray(a) for a in args]
    ref = fused_ivf_scan_xla(*jargs, k, accum_bf16=accum_bf16)
    got = fused_ivf_scan_plain(*[torch.from_numpy(a) for a in args], k,
                               accum_bf16=accum_bf16)
    return ref, got


# (S, cap, d, k, nq, n_steps, vacancy_rows): the tier-1 store of
# test_fused_kernels, the store of its parity matrix, k = 1 and k at the
# cap of 128 (more than the candidates of the short lists)
CASES = [(6, 24, 10, 5, 7, 4, 3), (8, 40, 18, 13, 9, 5, 2), (5, 37, 16, 1, 6, 3, 0),
         (8, 40, 18, 128, 5, 5, 2)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "S%d-cap%d-d%d-k%d" % c[:4])
def test_plain_matches_jax_oracle(case):
    S, cap, d, k, nq, n_steps, vac = case
    args = _case(S, cap, d, nq, n_steps, 12, vac)
    (rd, ri), (gd, gi) = _run(args, k)
    assert_knn_close(rd, ri, gd.numpy(), gi.numpy(), RTOL, ATOL)
    assert (gi[1] == -1).all() and torch.isinf(gd[1]).all()


def test_bf16_matches_jax_bf16_oracle_and_float32_truth():
    args = _case(8, 40, 18, 9, 5, 23, 2)
    (rd, ri), (gd, gi) = _run(args, 13, accum_bf16=True)
    assert_knn_close(rd, ri, gd.numpy(), gi.numpy(), 0, BF16_ATOL)
    (fd, _), _ = _run(args, 13)
    fin = np.isfinite(np.asarray(fd))
    np.testing.assert_allclose(gd.numpy()[fin], np.asarray(fd)[fin], rtol=0,
                               atol=BF16_TRUTH_ATOL)


def test_plain_matches_interpreted_pallas_kernel():
    # the one interpret-mode run of the Pallas kernel
    args = _case(6, 24, 10, 7, 4, 12, 3)
    ref = jax_fused_ivf_scan(*[jnp.asarray(a) for a in args], 5, interpret=True)
    got = fused_ivf_scan(*[torch.from_numpy(a) for a in args], 5)
    assert_knn_close(*ref, got[0].numpy(), got[1].numpy(), RTOL, ATOL)


def test_ties_resolve_to_the_earlier_scan_position():
    # every slot holds the same rows: equal distances in each step
    sv, sn, si = _slot_store(1, 8, 4, 3)
    sv, sn = np.repeat(sv, 3, 0), np.repeat(sn, 3, 0)
    si = np.arange(24, dtype=np.int32).reshape(3, 8)
    q = _rand((2, 4), 4)
    slots = np.array([[2, 0, 1], [1, 2, 0]], np.int32)
    _, ids = fused_ivf_scan(*[torch.from_numpy(a) for a in (q, sv, sn, si, slots)], 6)
    # the two nearest rows, each three times, in scan-step order
    ids = ids.numpy().reshape(2, 2, 3)
    assert (ids // 8 == slots[:, None, :]).all()
    assert (ids % 8 == ids[:, :, :1] % 8).all()


def test_wrapper_limits():
    q, sv, sn, si, slots = (torch.from_numpy(a) for a in _case(6, 24, 10, 3, 2, 1, 0))
    with pytest.raises(LogicError, match="k <= 128"):
        fused_ivf_scan(q, sv, sn, si, slots, 129)
    with pytest.raises(LogicError, match="float32"):
        fused_ivf_scan(q.double(), sv.double(), sn, si, slots, 3)
    with pytest.raises(LogicError, match="int32"):
        fused_ivf_scan(q, sv, sn, si.long(), slots, 3)
    with pytest.raises(LogicError, match="empty scan list"):
        fused_ivf_scan(q, sv, sn, si, slots[:, :0], 3)
