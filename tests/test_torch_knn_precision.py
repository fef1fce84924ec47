"""The kNN layer's ``precision="default"`` in the port: the product of
``raft_tpu_torch.core.precision.matmul_bf16`` (operands rounded to
bfloat16, exact products, float32 sums, a float32 result; norms from the
unrounded rows), held through K1 (``fused_l2_knn``), K6
(``fused_knn_twophase``), K4 (``fused_l2_nn``) and K3 (``fused_ivf_scan``)
on CPU tensors, where each wrapper takes its plain version.

On inputs that are bfloat16 values the single pass is exact, so the port
computes what the JAX functions compute at ``"default"`` on the CPU (a
float32 product there): held at ``l2_atol``.  On general inputs the port
is held to a numpy emulation of the definition (``helpers/tf32.py``
``dots_bf16``), and its recall@k against the JAX float32 answer.  The
rounding makes equal distances common, so ids are compared as sets up to
ties (``assert_knn_close``), never by position.  The JAX inputs are
explicit float32 (``tests/conftest.py`` turns on x64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.tf32 import bf16_round, dots_bf16, knn_from_dots, nn_from_dots
from helpers.torch_parity import assert_knn_close
from raft_tpu.distance.fused_l2_nn import fused_l2_nn as jax_fused_l2_nn
from raft_tpu.ops.ivf_tile import fused_ivf_scan_xla
from raft_tpu.ops.knn_tile import fused_knn_twophase as jax_twophase
from raft_tpu.spatial.fused_l2_knn import fused_l2_knn as jax_fused_l2_knn
from raft_tpu_torch import DistanceType, LogicError, brute_force_knn
from raft_tpu_torch.core import precision, tuning
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
from raft_tpu_torch.distance.pairwise import expanded_sq_dists, pairwise_distance
from raft_tpu_torch.ops.ivf_tile import fused_ivf_scan
from raft_tpu_torch.ops.knn_tile import fused_knn_tile, fused_knn_twophase
from raft_tpu_torch.ops.nn_tile import fused_nn_tile
from raft_tpu_torch.spatial.fused_l2_knn import fused_l2_knn

D = DistanceType
CPU = "cpu"


def l2_atol(a, b):
    """The tolerance of expanded-form squared L2 in float32 (chip_smoke.py
    ``l2_atol``): the rounding of |a|^2 + |b|^2 at the largest norms."""
    return 2e-6 * float((a * a).sum(-1).max() + (b * b).sum(-1).max())


def _data(n, nq, d, kind="uniform", seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random((n, d), dtype=np.float32), rng.random((nq, d), dtype=np.float32)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _recall(got_i, ref_i):
    got_i, ref_i = np.asarray(got_i), np.asarray(ref_i)
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(got_i, ref_i)]))


def _sq_dists_emulated(x, y):
    xn = (x * x).sum(axis=1, dtype=np.float32)[:, None]
    yn = (y * y).sum(axis=1, dtype=np.float32)[None, :]
    return np.maximum(xn + yn - np.float32(2.0) * dots_bf16(x, y), np.float32(0.0))


# ---------------------------------------------------------------------- #
# the product
# ---------------------------------------------------------------------- #
def test_default_product_is_bf16_operands_with_float32_sums():
    # 64 x 2,000 rows of uniform [0, 1) at depth 128: a product rounded to
    # bfloat16 at the output is off by up to 0.25 here, the definition's
    # own rounding by far less than l2_atol
    y, x = _data(2000, 64, 128)
    tx, ty = _t(x, y)
    got = expanded_sq_dists(tx, ty, "default")
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - _sq_dists_emulated(x, y)).max()
    assert err <= l2_atol(x, y), (err, l2_atol(x, y))
    dots = precision.matmul_bf16(tx, ty.T)
    assert dots.dtype == torch.float32
    np.testing.assert_allclose(dots.numpy(), dots_bf16(x, y), rtol=1e-6, atol=0)


@pytest.mark.parametrize("metric", [D.L2Expanded, D.InnerProduct], ids=lambda m: m.name)
def test_pairwise_default_takes_the_product(metric):
    y, x = _data(300, 40, 96, "normal", seed=1)
    got = pairwise_distance(x, y, metric, precision="default", device=CPU).numpy()
    want = _sq_dists_emulated(x, y) if metric == D.L2Expanded else dots_bf16(x, y)
    np.testing.assert_allclose(got, want, rtol=0, atol=l2_atol(x, y))


def test_truncating_sums_stay_within_l2_atol():
    # the card's bfloat16 instance sums each k8 step into one truncating
    # float32 accumulator: on same-sign data every truncation drifts one
    # way, and it still meets the tolerance the card is held to
    for kind, (n, nq, d) in (("uniform", (3000, 40, 128)), ("uniform", (2000, 20, 300))):
        y, x = _data(n, nq, d, kind, seed=2)
        xn = (x * x).sum(axis=1, dtype=np.float32)[:, None]
        yn = (y * y).sum(axis=1, dtype=np.float32)[None, :]
        card = xn + yn - 2 * dots_bf16(x, y, acc="one")
        plain = xn + yn - 2 * dots_bf16(x, y)
        assert np.abs(card - plain).max() <= l2_atol(x, y)


# ---------------------------------------------------------------------- #
# K1 through fused_l2_knn (the kernel's plain version, and the scan)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["kernel", "scan"])
def test_k1_on_bf16_values_matches_jax_default(impl):
    x, q = (bf16_round(a) for a in _data(3000, 33, 64, "normal", seed=3))
    ref_d, ref_i = jax_fused_l2_knn(jnp.asarray(x), jnp.asarray(q), 10, precision="default")
    got_d, got_i = fused_l2_knn(x, q, 10, precision="default", impl=impl, device=CPU)
    assert_knn_close(np.asarray(ref_d), np.asarray(ref_i), got_d.numpy(), got_i.numpy(), 0,
                     l2_atol(x, q))


@pytest.mark.parametrize("impl", ["kernel", "scan"])
def test_k1_on_general_inputs_matches_the_emulation(impl):
    x, q = _data(2000, 64, 128, seed=4)
    got_d, got_i = fused_l2_knn(x, q, 10, precision="default", impl=impl, device=CPU)
    want_d, want_i = knn_from_dots(q, x, dots_bf16(q, x), 10)
    assert_knn_close(want_d, want_i, got_d.numpy(), got_i.numpy(), 0, l2_atol(x, q))
    _, ref_i = jax_fused_l2_knn(jnp.asarray(x), jnp.asarray(q), 10)
    assert _recall(got_i, ref_i) >= 0.95


def test_brute_force_default_reaches_the_kernel_route():
    x, q = _data(2500, 20, 32, "normal", seed=5)
    got_d, got_i = brute_force_knn(x, q, 7, D.L2Expanded, precision="default", device=CPU)
    want_d, want_i = fused_l2_knn(x, q, 7, precision="default", impl="kernel", device=CPU)
    assert_knn_close(want_d.numpy(), want_i.numpy(), got_d.numpy(), got_i.numpy(), 0,
                     l2_atol(x, q))


# ---------------------------------------------------------------------- #
# K6 and K4
# ---------------------------------------------------------------------- #
def test_k6_on_bf16_values_matches_jax_default():
    x, q = (bf16_round(a) for a in _data(1500, 17, 32, "normal", seed=6))
    ref_d, ref_i = jax_twophase(jnp.asarray(x), jnp.asarray(q), 20, block_n=256,
                                precision="default", interpret=True)
    got_d, got_i = fused_knn_twophase(*_t(x, q), 20, block_n=256, precision="default")
    assert_knn_close(np.asarray(ref_d), np.asarray(ref_i), got_d.numpy(), got_i.numpy(), 0,
                     l2_atol(x, q))


@pytest.mark.parametrize("block_n", [256, 2048])
def test_k6_on_general_inputs_matches_the_emulation(block_n):
    x, q = _data(3000, 40, 128, seed=7)
    got_d, got_i = fused_knn_twophase(*_t(x, q), 100, block_n=block_n, precision="default")
    want_d, want_i = knn_from_dots(q, x, dots_bf16(q, x), 100)
    assert_knn_close(want_d, want_i, got_d.numpy(), got_i.numpy(), 0, l2_atol(x, q))


def test_k4_on_bf16_values_matches_jax_default():
    y, x = (bf16_round(a) for a in _data(500, 300, 48, "normal", seed=8))
    ref_v, ref_i = jax_fused_l2_nn(jnp.asarray(x), jnp.asarray(y), precision="default")
    got_v, got_i = fused_l2_nn(x, y, precision="default", impl="kernel", device=CPU)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), rtol=0, atol=l2_atol(x, y))
    _ties_only(x, y, got_i.numpy(), np.asarray(ref_i), np.asarray(ref_v), l2_atol(x, y))


def test_k4_on_general_inputs_matches_the_emulation():
    y, x = _data(1024, 2000, 128, "normal", seed=9)
    got_v, got_i = fused_l2_nn(x, y, precision="default", impl="kernel", device=CPU)
    want_v, want_i = nn_from_dots(x, y, dots_bf16(x, y))
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=l2_atol(x, y))
    _ties_only(x, y, got_i.numpy(), want_i, want_v, l2_atol(x, y))
    _, ref_i = jax_fused_l2_nn(jnp.asarray(x), jnp.asarray(y))
    assert np.mean(got_i.numpy() == np.asarray(ref_i)) >= 0.95


def _ties_only(x, y, got_i, ref_i, ref_v, atol):
    """Where the ids differ, the port's id is a tie with the reference's
    minimum (within ``atol``) in the port's own arithmetic."""
    bad = np.nonzero(got_i != ref_i)[0]
    if len(bad):
        alt = _sq_dists_emulated(x[bad], y)[np.arange(len(bad)), got_i[bad]]
        assert (np.abs(alt - ref_v[bad]) <= atol).all()


def test_k4_keeps_its_nan_contract_at_default():
    y, x = _data(200, 50, 16, "normal", seed=10)
    x[7, 3] = np.nan
    got_v, got_i = fused_nn_tile(*_t(x, y), precision="default")
    assert np.isinf(got_v[7].item()) and int(got_i[7]) == 2**31 - 1


# ---------------------------------------------------------------------- #
# K3
# ---------------------------------------------------------------------- #
def _ivf_case(S=8, cap=40, d=18, nq=9, n_steps=5, seed=23):
    rng = np.random.RandomState(seed)
    sv = rng.random((S, cap, d)).astype(np.float32)
    sn = (sv * sv).sum(-1).astype(np.float32)
    si = np.arange(S * cap, dtype=np.int32).reshape(S, cap)
    si[:, cap - 2:] = -1
    q = np.random.RandomState(seed + 1).random((nq, d)).astype(np.float32)
    slots = np.stack([rng.permutation(S)[:n_steps] for _ in range(nq)]).astype(np.int32)
    slots[0, 2:] = -1
    return q, sv, sn, si, slots


def test_k3_default_is_the_bf16_instance():
    args = _t(*_ivf_case())
    got = fused_ivf_scan(*args, 13, precision="default")
    want = fused_ivf_scan(*args, 13, accum_bf16=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    high = fused_ivf_scan(*args, 13)
    assert not torch.equal(got[0], high[0])
    with pytest.raises(LogicError):
        fused_ivf_scan(*args, 13, precision="high")


def test_k3_on_bf16_values_matches_jax_default():
    q, sv, sn, si, slots = _ivf_case(seed=31)
    q, sv = bf16_round(q), bf16_round(sv)
    sn = (sv * sv).sum(-1).astype(np.float32)
    ref_d, ref_i = fused_ivf_scan_xla(*[jnp.asarray(a) for a in (q, sv, sn, si, slots)], 13,
                                      precision="default")
    got_d, got_i = fused_ivf_scan(*_t(q, sv, sn, si, slots), 13, precision="default")
    assert_knn_close(np.asarray(ref_d), np.asarray(ref_i), got_d.numpy(), got_i.numpy(), 0,
                     l2_atol(q, sv.reshape(-1, sv.shape[-1])))


# ---------------------------------------------------------------------- #
# narrower inputs and the legality rules
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("prec", ["highest", "default"])
def test_narrow_inputs_go_through_a_float32_copy(dtype, prec):
    x, q = (t.to(dtype) for t in _t(*_data(900, 11, 24, "normal", seed=12)))
    xf, qf = x.float(), q.float()
    for got, want in [(fused_knn_tile(x, q, 9, prec), fused_knn_tile(xf, qf, 9, prec)),
                      (fused_knn_twophase(x, q, 9, block_n=256, precision=prec),
                       fused_knn_twophase(xf, qf, 9, block_n=256, precision=prec)),
                      (fused_nn_tile(q, x, prec), fused_nn_tile(qf, xf, prec)),
                      (fused_l2_knn(x, q, 9, precision=prec, impl="kernel", device=CPU),
                       fused_l2_knn(xf, qf, 9, precision=prec, impl="kernel", device=CPU))]:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernels_refuse_what_they_have_no_instance_for():
    x, q = _t(*_data(300, 5, 8, "normal", seed=13))
    for call in (lambda: fused_knn_tile(x.double(), q.double(), 3),
                 lambda: fused_nn_tile(q.double(), x.double()),
                 lambda: fused_knn_tile(x, q, 3, "high"),
                 lambda: fused_knn_twophase(x, q, 3, precision="high"),
                 lambda: fused_nn_tile(q, x, "high")):
        with pytest.raises(LogicError):
            call()
    # float64 stays on the scan route, with or without an explicit kernel
    with pytest.raises(LogicError, match="float32, float16 or bfloat16"):
        fused_l2_knn(x.double(), q.double(), 3, impl="kernel", device=CPU)
    d, _ = fused_l2_knn(x.double(), q.double(), 3, precision="default", device=CPU)
    assert d.dtype == torch.float32


@pytest.mark.parametrize("knob,site", [("fused_knn_impl", "fused_l2_knn"),
                                       ("fused_nn_impl", "fused_l2_nn")])
def test_dispatch_takes_the_kernel_at_default(knob, site, monkeypatch):
    # unset, the dispatch asks the registry for the kernel at "default" on
    # the card; here the legality is held for every input type it takes
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert tuning.check(knob, "kernel", site=site, explicit=True, k=10, dtype=dtype,
                            precision="default", device="cuda") == "kernel"
