"""Port parity of the device RNG (raft_tpu_torch.random.Rng) against the
JAX package's raft_tpu.random.Rng, on the CPU.

The port draws from a torch Generator and the JAX package from Threefry,
so the numbers differ for one seed; the two are held to the same
distributions.  Each distribution is drawn N = 200,000 times from each
package at fixed seeds and must pass, against the closed form (scipy):
a one-sample Kolmogorov-Smirnov distance below 0.0062 (the critical
value at alpha 1e-6 for N: sqrt(ln(2 / alpha) / (2 N))) and a mean within
6 standard errors; against the JAX draws, a two-sample KS distance below
0.0088 (alpha 1e-6).  Every method's support and dtype are checked too.
Every port Rng is made with ``device="cpu"``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from raft_tpu.random import Rng as JRng
from raft_tpu_torch import RaftError
from raft_tpu_torch.random import GeneratorType, Rng

N = 200_000
KS_ONE, KS_TWO = 0.0062, 0.0088


def _rng(seed=42):
    return Rng(seed, device="cpu")


# (name, port call, JAX call, scipy distribution)
DISTRIBUTIONS = [
    ("uniform", lambda r: r.uniform((N,), -1.0, 3.0), st.uniform(-1.0, 4.0)),
    ("normal", lambda r: r.normal((N,), 2.0, 0.5), st.norm(2.0, 0.5)),
    ("gumbel", lambda r: r.gumbel((N,), 1.0, 2.0), st.gumbel_r(1.0, 2.0)),
    ("lognormal", lambda r: r.lognormal((N,), 0.5, 0.4), st.lognorm(0.4, scale=math.exp(0.5))),
    ("logistic", lambda r: r.logistic((N,), -1.0, 0.7), st.logistic(-1.0, 0.7)),
    ("exponential", lambda r: r.exponential((N,), 2.5), st.expon(scale=1 / 2.5)),
    ("rayleigh", lambda r: r.rayleigh((N,), 1.5), st.rayleigh(scale=1.5)),
    ("laplace", lambda r: r.laplace((N,), 0.3, 2.0), st.laplace(0.3, 2.0)),
]


@pytest.mark.parametrize("name,draw,dist", DISTRIBUTIONS, ids=[d[0] for d in DISTRIBUTIONS])
def test_distribution_matches_closed_form_and_jax(name, draw, dist):
    x = draw(_rng())
    assert x.dtype == torch.float32 and x.shape == (N,) and torch.isfinite(x).all()
    x = x.numpy().astype(np.float64)
    ref = np.asarray(draw(JRng(seed=42)), np.float64)
    assert st.kstest(x, dist.cdf).statistic < KS_ONE
    assert st.ks_2samp(x, ref).statistic < KS_TWO
    assert abs(x.mean() - dist.mean()) < 6 * dist.std() / math.sqrt(N)


def test_support_and_dtypes():
    r = _rng(7)
    u = r.uniform((N,), -1.0, 3.0)
    assert u.dtype == torch.float32 and u.min() >= -1.0 and u.max() < 3.0
    assert r.uniform((10,), dtype=torch.float64).dtype == torch.float64
    ui = r.uniform_int((N,), 5, 10)
    assert ui.dtype == torch.int32 and set(ui.unique().tolist()) == {5, 6, 7, 8, 9}
    assert r.uniform_int((8,), 0, 3, dtype=torch.int64).dtype == torch.int64
    ni = r.normal_int((N,), 10, 3)
    assert ni.dtype == torch.int32 and abs(float(ni.float().mean()) - 10) < 0.05
    mu = np.array([1.0, -2.0, 5.0], np.float32)
    t = r.normal_table(N, mu, np.array([0.1, 1.0, 2.0], np.float32))
    assert t.shape == (N, 3) and t.dtype == torch.float32
    np.testing.assert_allclose(t.mean(0).numpy(), mu, atol=0.02)
    np.testing.assert_allclose(t.std(0).numpy(), [0.1, 1.0, 2.0], rtol=0.01)
    t2 = r.normal_table(100, mu, sigma=0.5)
    assert t2.shape == (100, 3)
    f = r.fill((4, 2), 7.5)
    assert f.dtype == torch.float32 and (f == 7.5).all()
    b = r.bernoulli((N,), 0.3)
    assert b.dtype == torch.bool and abs(float(b.float().mean()) - 0.3) < 0.005
    sb = r.scaled_bernoulli((N,), 0.25, 2.0)
    assert sb.dtype == torch.float32 and set(sb.unique().tolist()) == {-2.0, 2.0}
    assert abs(float((sb > 0).float().mean()) - 0.25) < 0.005
    assert (r.lognormal((N,)) > 0).all() and (r.exponential((N,)) >= 0).all()
    assert (r.rayleigh((N,)) >= 0).all()
    for fn in (r.gumbel, r.logistic, r.laplace, r.normal):
        assert torch.isfinite(fn((N,))).all()


def test_draws_follow_the_seed():
    a, b = _rng(3), _rng(3)
    assert torch.equal(a.normal((100,)), b.normal((100,)))
    assert not torch.equal(a.normal((100,)), _rng(4).normal((100,)))
    # each draw advances the generator; seed() starts it over
    first = a.uniform((5,))
    assert not torch.equal(first, a.uniform((5,)))
    a.seed(9)
    c = _rng(9)
    assert torch.equal(a.uniform((5,)), c.uniform((5,)))
    for g in GeneratorType:
        assert Rng(1, g, device="cpu").gtype == g


def test_sample_without_replacement_unweighted():
    r = _rng(5)
    items = np.arange(100, 200, dtype=np.int64)
    got, idx = r.sample_without_replacement(items, 40)
    assert idx.dtype == torch.int32 and len(torch.unique(idx)) == 40
    assert torch.equal(got, torch.from_numpy(items)[idx.long()])
    ref_items, ref_idx = JRng(seed=5).sample_without_replacement(jnp.asarray(items), 40)
    assert np.asarray(ref_idx).shape == tuple(idx.shape) and len(np.unique(ref_idx)) == 40
    with pytest.raises(RaftError):
        r.sample_without_replacement(items, 0)
    with pytest.raises(RaftError):
        r.sample_without_replacement(items, 101)


def test_sample_without_replacement_weighted():
    # the first pick follows w / sum(w); the heaviest item is in nearly
    # every sample of 3 (as in the JAX package's draws)
    w = np.array([1.0, 2.0, 3.0, 4.0, 90.0], np.float32)
    items = np.arange(5)
    r, jr = _rng(11), JRng(seed=11)
    trials = 3000
    first = np.zeros(5)
    heavy, jheavy = 0, 0
    for _ in range(trials):
        _, idx = r.sample_without_replacement(items, 1, w)
        first[int(idx[0])] += 1
        _, idx3 = r.sample_without_replacement(items, 3, w)
        heavy += 4 in idx3.tolist()
    for _ in range(300):
        _, jidx = jr.sample_without_replacement(jnp.asarray(items), 3, jnp.asarray(w))
        jheavy += 4 in np.asarray(jidx).tolist()
    p = w / w.sum()
    np.testing.assert_allclose(first / trials, p, atol=6 * np.sqrt(p * (1 - p) / trials).max())
    assert heavy / trials > 0.99 and jheavy / 300 > 0.99


@pytest.mark.parametrize("n", [1, 2, 10, 97, 1000])
def test_affine_transform_params(n):
    r = _rng(n)
    for _ in range(20):
        a, b = r.affine_transform_params(n)
        assert math.gcd(a, n) == 1 and 0 <= b < max(n, 1) and 1 <= a < max(n, 2)
        ja, jb = JRng(seed=n).affine_transform_params(n)
        assert math.gcd(ja, n) == 1
