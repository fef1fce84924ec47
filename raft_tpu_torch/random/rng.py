"""Device RNG with the reference's distribution set.

Port of ``raft_tpu/random/rng.py`` (reference cpp/include/raft/random/rng.hpp:
``Rng`` :66 over the Philox/Taps/Kiss99 generators, the distributions
uniform ... laplace :113-347, ``sampleWithoutReplacement`` :350 and
``affine_transform_params`` :96).

The draws come from an explicit :class:`torch.Generator` on the device
(Philox on the card), seeded with ``seed``; each method advances it, as
the reference's stateful object does.  The JAX package draws from
Threefry keys split on every call, and torch cannot reproduce those
streams: for one seed the two packages give other numbers from the same
distributions, with the same support and dtype.  The transforms of the
uniform draws are the JAX package's (``jax.random``): the Gumbel, the
logistic, the exponential and the Laplace by inverse CDF of one uniform,
the Rayleigh as in the reference.  Weighted sampling without replacement
is the Gumbel-top-k trick: the top k of ``log w + Gumbel noise`` are a
weighted sample without replacement.
"""

from __future__ import annotations

import enum
import math
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects


class GeneratorType(enum.IntEnum):
    """(reference rng.hpp:34 GenPhilox/GenTaps/GenKiss99; all draw from
    the device's Philox generator, kept so that configurations carry
    over)."""

    GenPhilox = 0
    GenTaps = 1
    GenKiss99 = 2


class Rng:
    """A seeded generator on ``device`` (default ``"cuda"``; raises when
    CUDA is missing) with the reference's distributions (rng.hpp:66).
    Every draw lands on that device."""

    def __init__(self, seed: int, gtype: GeneratorType = GeneratorType.GenPhilox,
                 device="cuda"):
        self.gtype = gtype
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device)
        self.seed(seed)

    def seed(self, s: int) -> None:
        """Re-seed (reference rng.hpp:83)."""
        self._gen.manual_seed(int(s) % 2**64)

    def _uniform(self, shape, dtype=torch.float32, low=0.0) -> torch.Tensor:
        """Uniform in [low, 1): ``low`` the smallest normal number where a
        transform takes a logarithm (jax.random's ``minval=tiny``)."""
        u = torch.rand(shape, generator=self._gen, dtype=dtype, device=self.device)
        return torch.clamp(u, min=low) if low else u

    def _randn(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.randn(shape, generator=self._gen, dtype=dtype, device=self.device)

    def affine_transform_params(self, n: int) -> Tuple[int, int]:
        """Random (a, b) for the affine index map ``a * i + b (mod n)``,
        with a coprime to n (reference rng.hpp:96)."""
        a = int(torch.randint(1, max(n, 2), (), generator=self._gen, device=self.device))
        while math.gcd(a, n) != 1:
            a = (a + 1) % n or 1
        b = int(torch.randint(0, max(n, 1), (), generator=self._gen, device=self.device))
        return a, b

    # ------------------------------------------------------------------ #
    # distributions (reference rng.hpp:113-347)
    # ------------------------------------------------------------------ #
    def uniform(self, shape, start=0.0, end=1.0, dtype=torch.float32) -> torch.Tensor:
        """Uniform in [start, end) (reference rng.hpp:113)."""
        return start + (end - start) * self._uniform(shape, dtype)

    def uniform_int(self, shape, start, end, dtype=torch.int32) -> torch.Tensor:
        """Integers in [start, end) (reference rng.hpp:118)."""
        return torch.randint(int(start), int(end), tuple(shape) if not isinstance(shape, int)
                             else (shape,), generator=self._gen, dtype=dtype, device=self.device)

    def normal(self, shape, mu=0.0, sigma=1.0, dtype=torch.float32) -> torch.Tensor:
        """(reference rng.hpp:136)"""
        return mu + sigma * self._randn(shape, dtype)

    def normal_int(self, shape, mu, sigma, dtype=torch.int32) -> torch.Tensor:
        """A normal rounded to the nearest integer (reference rng.hpp:141)."""
        return torch.round(mu + sigma * self._randn(shape)).to(dtype)

    def normal_table(self, n_rows: int, mu_vec, sigma_vec=None, sigma=1.0,
                     dtype=torch.float32) -> torch.Tensor:
        """(n_rows, len(mu_vec)): row i ~ N(mu_vec, sigma_vec) a column
        (reference rng.hpp:168 ``normalTable``)."""
        mu_vec = as_tensor(mu_vec, self.device)
        z = self._randn((n_rows, mu_vec.shape[0]), dtype)
        s = as_tensor(sigma_vec, self.device)[None, :] if sigma_vec is not None else sigma
        return mu_vec[None, :] + s * z

    def fill(self, shape, val, dtype=torch.float32) -> torch.Tensor:
        """(reference rng.hpp:189)"""
        return torch.full(tuple(shape) if not isinstance(shape, int) else (shape,), val,
                          dtype=dtype, device=self.device)

    def bernoulli(self, shape, prob, dtype=torch.bool) -> torch.Tensor:
        """P(True) = prob (reference rng.hpp:207)."""
        return (self._uniform(shape) < prob).to(dtype)

    def scaled_bernoulli(self, shape, prob, scale, dtype=torch.float32) -> torch.Tensor:
        """+scale with probability prob, else -scale (reference
        rng.hpp:223: the kernel emits ``u > prob ? -scale : scale``)."""
        u = self._uniform(shape, dtype)
        return torch.where(u > prob, -scale, scale).to(dtype)

    def gumbel(self, shape, mu=0.0, beta=1.0, dtype=torch.float32) -> torch.Tensor:
        """(reference rng.hpp:240)"""
        u = self._uniform(shape, dtype, low=torch.finfo(dtype).tiny)
        return mu + beta * -torch.log(-torch.log(u))

    def lognormal(self, shape, mu=0.0, sigma=1.0, dtype=torch.float32) -> torch.Tensor:
        """exp(N(mu, sigma)) (reference rng.hpp:256)."""
        return torch.exp(self.normal(shape, mu, sigma, dtype))

    def logistic(self, shape, mu=0.0, scale=1.0, dtype=torch.float32) -> torch.Tensor:
        """(reference rng.hpp:272)"""
        u = self._uniform(shape, dtype, low=torch.finfo(dtype).tiny)
        return mu + scale * (torch.log(u) - torch.log1p(-u))

    def exponential(self, shape, lam=1.0, dtype=torch.float32) -> torch.Tensor:
        """Rate-lambda exponential (reference rng.hpp:287)."""
        return -torch.log1p(-self._uniform(shape, dtype)) / lam

    def rayleigh(self, shape, sigma=1.0, dtype=torch.float32) -> torch.Tensor:
        """(reference rng.hpp:302)"""
        return sigma * torch.sqrt(-2.0 * torch.log1p(-self._uniform(shape, dtype)))

    def laplace(self, shape, mu=0.0, scale=1.0, dtype=torch.float32) -> torch.Tensor:
        """(reference rng.hpp:318)"""
        # u uniform in (-1, 1), as jax.random.laplace draws it
        u = self._uniform(shape, dtype, low=torch.finfo(dtype).eps / 2) * 2.0 - 1.0
        return mu + scale * torch.sign(u) * torch.log1p(-u.abs())

    # ------------------------------------------------------------------ #
    # sampling (reference rng.hpp:350)
    # ------------------------------------------------------------------ #
    def sample_without_replacement(self, items, sampled_len: int,
                                   weights=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Weighted sampling without replacement by Gumbel-top-k
        (reference rng.hpp:350 perturbs each weight and sorts; the top k
        of ``log w + Gumbel noise`` is the same distribution in one
        top-k).  Returns ``(sampled_items, sampled_indices)``, the
        indices int32."""
        items = as_tensor(items, self.device)
        n = items.shape[0]
        expects(0 < sampled_len <= n,
                "sample_without_replacement: sampled_len %d out of range (0, %d]",
                sampled_len, n)
        keys = self.gumbel((n,))
        if weights is not None:
            w = as_tensor(weights, self.device, torch.float32)
            keys = torch.log(torch.clamp(w, min=1e-37)) + keys
        idx = torch.topk(keys, sampled_len).indices
        return items[idx], idx.to(torch.int32)
