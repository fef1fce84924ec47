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

:func:`kernel_phases` has no counterpart in the reference: while it is
open on a thread, the fused tile kernel's wrappers (K1, K3, K4, K6)
launch its phase-timed instance, which counts the cycles each of the
kernel's roles spends in each phase (``ops/csrc/knn_tile.cuh``).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence

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


# ---------------------------------------------------------------------- #
# phase counters of the fused tile kernel
# ---------------------------------------------------------------------- #
# The timed instance's counter buffer, int64 words (ops/csrc/knn_tile.cuh,
# kPh*): the blocks, then each role's total cycles followed by its phases'
# cycles, then the instance, N | NR << 8 | mode << 16 | bf16 << 24.  A
# role's cycles are summed over its warps.
PHASES = (("mma", ("wait_load", "wait_tensor", "fill", "wait_select", "epilogue")),
          ("select", ("wait_tile", "gate", "merge", "write")),
          ("producer", ("wait_slot",)))
PHASE_WORDS = 1 + sum(1 + len(p) for _, p in PHASES) + 1
# the template's mode argument: which kernel an instance is
TILE_MODES = {0: "K1", 1: "K6", 2: "K3", 3: "K4"}

_phase_state = threading.local()


class PhaseLaunch:
    """One launch of the timed instance: its counter buffer and the
    events around it on the current stream."""

    __slots__ = ("counts", "start", "end")

    def __init__(self, device: torch.device):
        self.counts = torch.zeros(PHASE_WORDS, dtype=torch.int64, device=device)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def run(self, fn, *args) -> int:
        """``fn(*args, counters)``: the timed entry point, its counter
        buffer last, between the two events."""
        self.start.record()
        try:
            return fn(*args, self.counts.data_ptr())
        finally:
            self.end.record()


def phase_launch(device: torch.device) -> Optional[PhaseLaunch]:
    """The record of one timed launch on ``device`` while
    :func:`kernel_phases` is open on this thread; None otherwise (and on
    the CPU), when the wrapper launches the default instance."""
    launches = getattr(_phase_state, "launches", None)
    if launches is None or device.type != "cuda":
        return None
    rec = PhaseLaunch(device)
    launches.append(rec)
    return rec


def instance_name(word: int) -> str:
    """The template instance that the counter buffer's last word names,
    as a trace names the kernel: ``knn_tile_kernel<64, 4, 0, false>``."""
    return "knn_tile_kernel<%d, %d, %d, %s>" % (
        word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF,
        "true" if (word >> 24) & 0xFF else "false")


def reduce_phases(rows: Sequence[Sequence[int]], seconds: Sequence[float]) -> Dict[str, dict]:
    """:func:`kernel_phases`'s table from the launches' counter buffers
    (``rows``, :data:`PHASE_WORDS` each) and their device seconds.  A
    buffer that names no instance (a launch that never ran) is left out.
    Each role's ``issue`` is its total less its phases."""
    table: Dict[str, dict] = {}
    for row, sec in zip(rows, seconds):
        row = [int(v) for v in row]
        if not row[-1]:
            continue
        e = table.get(instance_name(row[-1]))
        if e is None:
            e = table[instance_name(row[-1])] = {
                "kernel": TILE_MODES.get((row[-1] >> 16) & 0xFF, "?"), "calls": 0, "blocks": 0,
                "seconds": 0.0, "cycles": {role: dict.fromkeys(("total",) + phases, 0)
                                           for role, phases in PHASES}}
        e["calls"] += 1
        e["blocks"] += row[0]
        e["seconds"] += sec
        w = 1
        for role, phases in PHASES:
            for name in ("total",) + phases:
                e["cycles"][role][name] += row[w]
                w += 1
    for e in table.values():
        e["shares"] = {}
        for role, phases in PHASES:
            c = e["cycles"][role]
            c["issue"] = c["total"] - sum(c[p] for p in phases)
            e["shares"][role] = {p: 100.0 * c[p] / c["total"] if c["total"] else 0.0
                                 for p in phases + ("issue",)}
    return table


@contextlib.contextmanager
def kernel_phases() -> Iterator[Dict[str, dict]]:
    """Count where the fused tile kernel's roles spend their cycles.

    While the block runs, every launch of K1, K3, K4 and K6 from this
    thread on a CUDA device takes the kernel's phase-timed instance (its
    library is built at its first use); its answers are the default
    instance's, bit for bit.  On exit the devices are synchronised once
    and the yielded dict is filled, one entry per instance (named as the
    trace names it, ``knn_tile_kernel<N, NR, mode, bf16>``):

    - ``kernel`` (``"K1"``, ``"K3"``, ...), ``calls`` (launches) and
      ``blocks``; ``seconds``, the launches' device time between events;
    - ``cycles``, ``{role: {phase: n}}`` summed over every warp of the
      role and every block, with each role's ``total`` (its start to its
      exit) and ``issue`` (the total less the phases);
    - ``shares``, each phase's percentage of its role's total.

    The roles are ``mma`` (the multiplying warpgroup: ``wait_load`` for
    the ring, ``wait_tensor`` for the wgmmas, ``fill`` for the queries'
    refills, ``wait_select`` for a free distance tile, ``epilogue``),
    ``select`` (``wait_tile``, ``gate``, ``merge``, ``write``) and
    ``producer`` (``wait_slot``).  Launches on CPU tensors take the plain
    versions and count nothing: the dict stays empty.  Nested blocks:
    the innermost counts.
    """
    prev = getattr(_phase_state, "launches", None)
    launches: List[PhaseLaunch] = []
    _phase_state.launches = launches
    table: Dict[str, dict] = {}
    try:
        yield table
    finally:
        _phase_state.launches = prev
    by_device: Dict[torch.device, List[PhaseLaunch]] = {}
    for rec in launches:
        by_device.setdefault(rec.counts.device, []).append(rec)
    rows: List[list] = []
    seconds: List[float] = []
    for dev, recs in by_device.items():
        torch.cuda.synchronize(dev)
        rows += torch.stack([rec.counts for rec in recs]).cpu().tolist()
        seconds += [rec.start.elapsed_time(rec.end) * 1e-3 for rec in recs]
    table.update(reduce_phases(rows, seconds))
