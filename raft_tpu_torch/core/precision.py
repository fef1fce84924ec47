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

A product at the JAX package's ``precision="default"`` has two forms in
the port.  The dense library's ``gemm`` runs it in TF32 on the card
(:func:`tf32`, :func:`matmul_tf32`), the analogue of XLA's single-pass
default on the TPU: the same flags, pinned to TF32 for that one call and
restored after; on the CPU, which has no TF32, such a product runs in
float32.  The kNN layer's distance products take the TPU's own
single-pass arithmetic (:func:`matmul_bf16`): each operand rounded to
bfloat16 (to nearest even), the products summed in float32, a float32
result.  A bfloat16 value is exact in float32 (and in TF32), so the
products are exact and only the sums round; the kernels K1, K3, K4 and
K6 compute the same on the tensor cores (``ops/csrc/knn_tile.cuh``).

The flags are process-global, not per thread.  Port calls in several
threads share one pin (a count under a lock: the first call in pins, the
last call out restores), so no port code ever leaves a flag changed or
unpins another port call.  A call that wants the other mode waits until
the pin of the first is released, so a pin is held around one product
(or a few with no caller code between them), never around a callable of
the caller.  A thread that already holds a pin and asks for the other
mode would wait on itself: it raises :class:`RaftError` instead.  A
caller that flips a flag from another thread while a port call runs can
still race with it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from raft_tpu_torch.core.error import RaftError

# the JAX package's precisions the port's products take (module doc)
PRECISIONS = ("highest", "default")

_cond = threading.Condition()
_depth = 0
_mode = None         # "ieee" or "tf32" while pinned
_saved = None        # what the first call in found, restored by the last out
_LEGACY = {"ieee": "highest", "tf32": "high"}
_held = threading.local()   # .depth: the pins this thread holds


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


def _is(mode: str) -> bool:
    legacy = _legacy()
    values = [b.fp32_precision for b in _backends()]
    if legacy is None:  # the caller mixed the two kinds of setting
        return bool(values) and all(v == mode for v in values)
    return legacy == _LEGACY[mode] and all(v in (mode, "none") for v in values)


def is_ieee() -> bool:
    """Whether a float32 product issued now runs in IEEE float32."""
    return _is("ieee")


def _pin(mode: str):
    """Pin ``mode``; returns what to restore, or None where nothing was
    written."""
    if _is(mode):
        return None
    saved = (_legacy(), [(b, b.fp32_precision) for b in _backends()])
    if saved[0] is not None:
        torch.set_float32_matmul_precision(_LEGACY[mode])
    for b, _ in saved[1]:
        b.fp32_precision = mode
    return saved


def _restore(saved) -> None:
    legacy, backends = saved
    if legacy is not None:
        torch.set_float32_matmul_precision(legacy)
    for b, value in backends:
        b.fp32_precision = value


@contextlib.contextmanager
def _pinned(mode: str):
    global _depth, _mode, _saved
    mine = getattr(_held, "depth", 0)
    with _cond:
        if mine and _mode != mode:
            raise RaftError("a %s product inside a pin of %s products in the same thread: the "
                            "two modes do not nest (raft_tpu_torch.core.precision)"
                            % (mode, _mode), collect_stack=False)
        while _depth and _mode != mode:
            _cond.wait()
        if _depth == 0:
            _saved = _pin(mode)
            _mode = mode
        _depth += 1
    _held.depth = mine + 1
    try:
        yield
    finally:
        _held.depth = mine
        with _cond:
            _depth -= 1
            if _depth == 0:
                if _saved is not None:
                    _restore(_saved)
                    _saved = None
                _mode = None
                _cond.notify_all()


def ieee_fp32():
    """Float32 products inside the block run in IEEE float32 (module doc)."""
    return _pinned("ieee")


def tf32():
    """Float32 products inside the block run in TF32 on the card (module
    doc)."""
    return _pinned("tf32")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` with float32 operands in IEEE float32."""
    with ieee_fp32():
        return torch.matmul(a, b)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` with float32 operands in TF32 on the card."""
    with tf32():
        return torch.matmul(a, b)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` as float32 values rounded to bfloat16 (to nearest even)."""
    return t.to(torch.bfloat16).to(torch.float32)


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at the JAX ``precision="default"`` (module doc): the
    float32 product, in IEEE float32, of the operands rounded to
    bfloat16."""
    with ieee_fp32():
        return torch.matmul(round_bf16(a), round_bf16(b))


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` with float32 operands in IEEE float32."""
    with ieee_fp32():
        return torch.bmm(a, b)
