"""Numeric sanitizer hooks on the solver paths.

Port of ``raft_tpu/core/debug.py``.  The failure that bites iterative
solvers is a NaN or an infinity spreading silently, so the solvers
(Lanczos) check their outputs with :func:`check_finite` when the checks
are on: :func:`enable_debug_checks`, or ``RAFT_TPU_DEBUG=1`` in the
environment.  A check reads the tensor back to the host, which waits
for the card: you pay for the diagnosis, so the checks are off by
default.

The JAX package's two compiler hooks, ``debug_nans`` (the
``jax_debug_nans`` flag) and ``checkify_checks`` (float checks compiled
into a jitted program), have no PyTorch counterpart and are not ported.
"""

from __future__ import annotations

import os

import torch

from raft_tpu_torch.core.error import RaftError

_enabled = os.environ.get("RAFT_TPU_DEBUG", "") == "1"


class NumericError(RaftError):
    """A debug-mode finiteness check failed (non-finite values where a
    solver requires finite data)."""


def enable_debug_checks(on: bool = True) -> None:
    """Turn the finiteness checks on or off for the process."""
    global _enabled
    _enabled = bool(on)


def debug_checks_enabled() -> bool:
    return _enabled


def check_finite(x: torch.Tensor, name: str) -> torch.Tensor:
    """If the checks are on, raise :class:`NumericError` when ``x`` holds
    a NaN or an infinity.  Returns ``x`` either way."""
    if _enabled and not bool(torch.isfinite(x).all()):
        raise NumericError("debug check failed: '%s' contains non-finite values (shape %s, "
                           "dtype %s)" % (name, tuple(x.shape), x.dtype))
    return x
