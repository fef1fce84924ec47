"""Tracing ranges and event counters.

Port of ``raft_tpu/core/tracing.py``.  The reference wraps NVTX push/pop
ranges in RAII helpers (cpp/include/raft/common/nvtx.hpp:17-60); the JAX
package puts its ranges on the XLA profiler timeline.  Here a range is a
``torch.profiler.record_function`` (it shows in a ``torch.profiler``
trace) and, while CUDA is initialised, an NVTX range as well
(``torch.cuda.nvtx``), so both PyTorch's profiler and NVTX-aware tools
see the same names.  Ranges can be disabled globally via
:func:`set_enabled` or the ``RAFT_TPU_TRACING`` environment variable
("0" disables).

Event counters are unchanged: named monotonic counters, always on and
thread-safe (the serving worker and the retry watchdog increment them
concurrently with the caller).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Iterator, List

import torch

_enabled = os.environ.get("RAFT_TPU_TRACING", "1") != "0"
# imperative ranges nest per thread: a watchdog thread's push/pop must
# not close the main thread's open ranges
_ranges = threading.local()
_counters: Dict[str, int] = {}
_counter_lock = threading.Lock()


def _range_stack() -> List[object]:
    stack = getattr(_ranges, "stack", None)
    if stack is None:
        stack = _ranges.stack = []
    return stack


def set_enabled(on: bool) -> None:
    """Globally enable/disable tracing ranges (CMake NVTX flag analog)."""
    global _enabled
    _enabled = on


def is_enabled() -> bool:
    return _enabled


class _Range:
    """One open range: a profiler ``record_function`` and, once CUDA is
    initialised, an NVTX push/pop of the same name."""

    __slots__ = ("_rf", "_nvtx")

    def __init__(self, name: str):
        self._rf = torch.profiler.record_function(name)
        # never initialise CUDA just to name a range
        self._nvtx = torch.cuda.is_initialized()
        self._rf.__enter__()
        if self._nvtx:
            torch.cuda.nvtx.range_push(name)

    def close(self) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(None, None, None)


@contextlib.contextmanager
def annotate(fmt: str, *args) -> Iterator[None]:
    """Scoped trace range (analog of nvtx::range RAII, common/nvtx.hpp:60).

    Printf-style message formatting mirrors the reference's
    ``push_range("name %d", i)`` usage.
    """
    if not _enabled:
        yield
        return
    rng = _Range(fmt % args if args else fmt)
    try:
        yield
    finally:
        rng.close()


def range_push(fmt: str, *args) -> None:
    """Imperative push (analog of nvtx::push_range, common/nvtx.hpp:40)."""
    if not _enabled:
        return
    _range_stack().append(_Range(fmt % args if args else fmt))


def range_pop() -> None:
    """Imperative pop (analog of nvtx::pop_range, common/nvtx.hpp:50).

    Pops regardless of the enabled flag: an already-entered range must be
    closed even if tracing was disabled between push and pop.
    """
    stack = _range_stack()
    if stack:
        stack.pop().close()


# ---------------------------------------------------------------------- #
# event counters (always on, thread-safe)
# ---------------------------------------------------------------------- #
def counter_inc(name: str, n: int = 1) -> int:
    """Increment the named monotonic counter, returning the new value."""
    with _counter_lock:
        _counters[name] = _counters.get(name, 0) + n
        return _counters[name]


def get_counter(name: str) -> int:
    with _counter_lock:
        return _counters.get(name, 0)


def counters() -> Dict[str, int]:
    """Snapshot of every counter (copy; safe to iterate/serialize)."""
    with _counter_lock:
        return dict(_counters)


def reset_counters() -> None:
    """Zero all counters (test isolation / stats-window rollover)."""
    with _counter_lock:
        _counters.clear()


@contextlib.contextmanager
def event(name: str, fmt: str = "", *args) -> Iterator[None]:
    """Span + counter for one resilience event: increments ``name`` and
    opens an :func:`annotate` range carrying the formatted detail."""
    counter_inc(name)
    detail = (fmt % args) if args else fmt
    with annotate("%s%s" % (name, " " + detail if detail else "")):
        yield
