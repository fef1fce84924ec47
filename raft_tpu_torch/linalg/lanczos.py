"""Restarted Lanczos eigensolver.

Port of ``raft_tpu/linalg/lanczos.py`` (reference
cpp/include/raft/linalg/lanczos.hpp, ``computeSmallestEigenvectors``
:754,1033 and ``computeLargestEigenvectors`` :1141).  The algorithm is
the JAX package's: *thick-restart* Lanczos with full
reorthogonalisation.  Each restart grows an orthonormal basis of ``m``
columns by matrix-vector products, each new column orthogonalised
against the whole basis twice (classical Gram-Schmidt, tall-skinny
products), solves the small projected problem with a dense symmetric
eigensolver (Rayleigh-Ritz), and keeps the ``k`` wanted Ritz vectors
plus the next Krylov direction for the next restart.

The JAX package runs the whole solve as one compiled loop.  Here the
loop is Python over work queued on the device, with one host read per
restart: the convergence test.  Within a restart nothing waits for the
card.  Where the Krylov space is exhausted (a new direction of norm
below 1e-10), the column is re-seeded with a random direction
orthogonal to the basis; both candidates are computed and one is taken
by ``torch.where``, so that choice needs no host read either.  Random
directions come from an explicit ``torch.Generator`` seeded with
``seed`` on the device, since the JAX package's Threefry streams cannot
be reproduced: the port's start vector, and so its iterates, differ from
the JAX package's, while the eigenpairs they converge to agree.  Every
product of the solver runs in IEEE float32
(:mod:`raft_tpu_torch.core.precision`): Krylov orthogonality is what
convergence rests on.  The pins are short: one for the products of each
step between two calls of the operator, none around the operator.  So a
callable ``mv`` may make products of either precision itself, and a
TF32 product in another thread waits for one step at most, not for the
solve.

The matrix is a dense tensor or a callable ``mv(x) -> A @ x`` on an
``(n,)`` vector (the ``sparse_matrix_t::mv`` interface, reference
spectral/matrix_wrappers.hpp:180).
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from raft_tpu_torch.core import precision
from raft_tpu_torch.core.debug import check_finite
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import takes_handle

Operator = Union[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]


def _orthonormalize(w: torch.Tensor, vb: torch.Tensor):
    """``w`` orthogonalised against the columns of ``vb`` twice, and its
    norm (inside a pin of the caller's)."""
    for _ in range(2):
        w = w - torch.matmul(vb, torch.matmul(vb.T, w))
    return w, torch.linalg.vector_norm(w)


def _expand_basis(mv, vb, ab, start: int, stop: int, rand: torch.Tensor) -> None:
    """Grow the orthonormal basis ``vb`` (n, m) in place from column
    ``start`` to ``stop``: column ``start`` holds the next direction;
    ``ab`` caches ``mv`` of every processed column, so Rayleigh-Ritz never
    recomputes a product.  ``rand`` (n, m) holds the re-seed draws."""
    for j in range(start, stop):
        av = mv(vb[:, j])
        ab[:, j] = av
        with precision.ieee_fp32():
            w, nrm = _orthonormalize(av, vb)
            r, rn = _orthonormalize(rand[:, j], vb)
        vb[:, j + 1] = torch.where(nrm > 1e-10, w / torch.where(nrm > 0, nrm, 1.0),
                                   r / torch.clamp(rn, min=1e-30))


def _ritz(vb: torch.Tensor, ab: torch.Tensor):
    """Rayleigh-Ritz on the basis and its cached products: Ritz values,
    vectors, the small problem's eigenvectors and the residual norms
    |A y - theta y| of each pair."""
    with precision.ieee_fp32():
        h = torch.matmul(vb.T, ab)
        h = 0.5 * (h + h.T)
        theta, s = torch.linalg.eigh(h)
        y = torch.matmul(vb, s)
        resid = torch.linalg.vector_norm(torch.matmul(ab, s) - y * theta[None, :], dim=0)
    return theta, y, s, resid


def _keep_order(theta: torch.Tensor, which: str) -> torch.Tensor:
    return torch.argsort(theta if which == "smallest" else -theta)


def _converged(theta, resid, keep, tol) -> bool:
    """The one host read of a restart."""
    scale = theta.abs().max()
    scale = torch.where(scale > 0, scale, 1.0)
    return bool(resid[keep].max() <= tol * scale)


def _lanczos(a: Operator, n: int, k: int, which: str, ncv: int, max_restarts: int,
             tol: float, seed: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    expects(0 < k < n, "lanczos: need 0 < k < n (k=%d, n=%d)", k, n)
    m = min(max(ncv, 2 * k + 1), n)
    if m >= n:
        # the basis spans the whole space after one expansion: Rayleigh-Ritz
        # is already the exact decomposition, and restarts only churn noise
        max_restarts = 1
    if callable(a):
        mv, dtype = a, torch.float32
    else:
        expects(tuple(a.shape) == (n, n), "lanczos: expected an (%d, %d) matrix, got %r",
                n, n, tuple(a.shape))
        mv, dtype = (lambda x: precision.matmul(a, x)), a.dtype
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def uniform(*shape):
        return torch.rand(*shape, generator=gen, dtype=dtype, device=device) * 2.0 - 1.0

    def expand(vb, ab, start):
        _expand_basis(mv, vb, ab, start, m - 1, uniform(n, m))
        av_last = mv(vb[:, m - 1])
        ab[:, m - 1] = av_last
        return av_last

    v0 = uniform(n)
    vb = torch.zeros((n, m), dtype=dtype, device=device)
    ab = torch.zeros((n, m), dtype=dtype, device=device)
    vb[:, 0] = v0 / torch.linalg.vector_norm(v0)
    av_last = expand(vb, ab, 0)
    theta, y, s, resid = _ritz(vb, ab)
    restart, n_iter = 0, m
    keep = _keep_order(theta, which)[:k]
    while restart < max_restarts - 1 and not _converged(theta, resid, keep, tol):
        # thick restart: the k wanted Ritz vectors and the next Krylov
        # direction A v_m orthogonalised against the whole basis (a
        # random draw where the Krylov space is exhausted)
        kept = y[:, keep]
        rand = uniform(n)
        with precision.ieee_fp32():
            kept_av = torch.matmul(ab, s[:, keep])
            fresh, fnorm = _orthonormalize(av_last, vb)
            rand = rand - torch.matmul(kept, torch.matmul(kept.T, rand))
        rand = rand / torch.clamp(torch.linalg.vector_norm(rand), min=1e-30)
        fresh = torch.where(fnorm > 1e-10, fresh / torch.clamp(fnorm, min=1e-30), rand)
        vb = torch.zeros_like(vb)
        ab = torch.zeros_like(ab)
        vb[:, :k] = kept
        vb[:, k] = fresh
        ab[:, :k] = kept_av
        av_last = expand(vb, ab, k)
        theta, y, s, resid = _ritz(vb, ab)
        keep = _keep_order(theta, which)[:k]
        restart += 1
        n_iter += m - k
    vals, vecs = theta[keep], y[:, keep]
    srt = _keep_order(vals, which)
    return vals[srt], vecs[:, srt], n_iter


def _solve(a, n, n_eig_vecs, which, maxiter, restart_iter, tol, seed, device):
    ncv = restart_iter if restart_iter > 0 else max(4 * n_eig_vecs, 32)
    ncv = min(ncv, n)
    max_restarts = max(1, maxiter // max(ncv, 1))
    vals, vecs, iters = _lanczos(a, n, n_eig_vecs, which, ncv, max_restarts, tol, seed, device)
    # the opt-in sanitizer: a NaN or an infinity in the operator reaches
    # every Ritz value, so the outputs show it wherever it entered
    check_finite(vals, "lanczos eigenvalues")
    check_finite(vecs, "lanczos eigenvectors")
    return vals, vecs, iters


@takes_handle
def compute_smallest_eigenvectors(a: Operator, n: int, n_eig_vecs: int, maxiter: int = 4000,
                                  restart_iter: int = 0, tol: float = 1e-9,
                                  seed: int = 1234567, *,
                                  device=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Smallest-eigenpair Lanczos (reference lanczos.hpp:754,1033).

    Returns ``(eigenvalues, eigenvectors, iters)``: eigenvalues
    ascending, eigenvectors as columns.  ``restart_iter`` sets the Krylov
    subspace size (0 picks ``max(4k, 32)``); the solve stops when every
    wanted residual is below ``tol`` times the largest |Ritz value|, or
    after ``maxiter // restart_iter`` restarts."""
    return _solve(a, n, n_eig_vecs, "smallest", maxiter, restart_iter, tol, seed, device)


@takes_handle
def compute_largest_eigenvectors(a: Operator, n: int, n_eig_vecs: int, maxiter: int = 4000,
                                 restart_iter: int = 0, tol: float = 1e-9,
                                 seed: int = 1234567, *,
                                 device=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Largest-eigenpair Lanczos (reference lanczos.hpp:1141); eigenvalues
    descending."""
    return _solve(a, n, n_eig_vecs, "largest", maxiter, restart_iter, tol, seed, device)
