"""Full float32 matrix products, pinned per call.

The JAX package asks for ``precision="highest"`` at each of its float32
products (for example ``raft_tpu/spatial/ann.py:375-376``): one TF32 pass
misses the kNN tolerances by 50-100x.  PyTorch has no such argument; what
a float32 product does is set by torch's matmul-precision flags.  So every
float32 product of the port goes through :func:`matmul` or :func:`bmm`,
which pin the flags to IEEE float32 around the single call and give the
caller's setting back in a ``finally``.  Nothing of the port assigns a
flag at import.

The flags: ``torch.set_float32_matmul_precision`` (the legacy setting,
which ``torch.backends.cuda.matmul.allow_tf32`` reads and writes) and,
where this torch has them, the per-backend ``fp32_precision`` settings of
cuBLAS (``torch.backends.cuda.matmul``) and oneDNN
(``torch.backends.mkldnn.matmul``).  Both are pinned, because torch
raises when it finds the two disagree at a product; where the caller's
legacy setting cannot be read (torch raises when the caller mixed the two
kinds), only the per-backend settings are pinned.  When the flags already
ask for IEEE float32 nothing is written.

The flags are process-global, not per thread.  Port calls in several
threads share one pin (a count under a lock: the first call in pins, the
last call out restores), so no port code ever leaves a flag changed or
unpins another port call.  A caller that flips a flag from another
thread while a port call runs can still race with it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0
_saved = None        # what the first call in found, restored by the last out


def _backends():
    """The per-backend matmul settings this torch has (none before it
    had ``fp32_precision``)."""
    if not hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        return ()
    return (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


def _legacy():
    """The legacy setting, or None where torch refuses to read it."""
    try:
        return torch.get_float32_matmul_precision()
    except RuntimeError:
        return None


def is_ieee() -> bool:
    """Whether a float32 product issued now runs in IEEE float32."""
    legacy = _legacy()
    values = [b.fp32_precision for b in _backends()]
    if legacy is None:  # the caller mixed the two kinds of setting
        return bool(values) and all(v == "ieee" for v in values)
    return legacy == "highest" and all(v in ("ieee", "none") for v in values)


def _pin():
    """Pin IEEE float32; returns what to restore, or None where nothing
    was written."""
    if is_ieee():
        return None
    saved = (_legacy(), [(b, b.fp32_precision) for b in _backends()])
    if saved[0] is not None:
        torch.set_float32_matmul_precision("highest")
    for b, _ in saved[1]:
        b.fp32_precision = "ieee"
    return saved


def _restore(saved) -> None:
    legacy, backends = saved
    if legacy is not None:
        torch.set_float32_matmul_precision(legacy)
    for b, value in backends:
        b.fp32_precision = value


@contextlib.contextmanager
def ieee_fp32():
    """Float32 products inside the block run in IEEE float32 (module doc)."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = _pin()
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0 and _saved is not None:
                _restore(_saved)
                _saved = None


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` with float32 operands in IEEE float32."""
    with ieee_fp32():
        return torch.matmul(a, b)


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` with float32 operands in IEEE float32."""
    with ieee_fp32():
        return torch.bmm(a, b)
