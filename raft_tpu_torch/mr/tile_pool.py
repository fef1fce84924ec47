"""TilePool: budgeted host-to-device tile streaming (out-of-core tier).

Port of ``raft_tpu/mr/tile_pool.py``.  The out-of-core index tier keeps
the bulk of an index in **host** memory and streams the slots a query
batch probes through a small, fixed budget of device tiles.  This module
owns the streaming; the search driver (:mod:`raft_tpu_torch.spatial.ooc`)
decides what to stream and when.

On the card, in the order it matters:

- **Pinned memory.**  ``stage()`` gathers ``store[slot_ids]`` into a
  *pinned* host block (``torch.index_select(..., out=block)`` over
  ``torch.from_numpy(store)``, which also takes the copy-on-write
  ``np.memmap`` of a memory-mapped snapshot, viewed as one row a slot:
  over the 3-D store ``index_select`` copies element by element, many
  times slower) and copies the block to the card with
  ``non_blocking=True``.  A copy from pageable memory (what
  ``store[ids]`` gives) would run synchronously, and nothing would
  overlap.  The pool keeps a ring of pinned blocks (three, more if more
  threads stage at once; allocated at the first stage of a store's slot
  shape).  A block is gathered into again only after the event of the
  copy that last read it has completed, so the host never overwrites
  bytes the DMA is still reading.
- **A side stream and an event per tile.**  The copy runs on the pool's
  own ``torch.cuda.Stream`` and records an event after it.  ``take()``
  is the one wait: it blocks the host on that event (the stall), then
  makes the caller's current stream wait for the event on the card and
  marks the tile's tensors as used there (``record_stream``), so the
  caching allocator never hands a tile's memory to a later copy while a
  scan still reads it.
- **The budget.**  ``budget_bytes`` bounds the bytes staged and not yet
  taken; a ``stage()`` that would exceed it waits for a concurrent
  ``take()`` a bounded time (``stage_wait_s``), then raises
  :class:`~raft_tpu_torch.core.error.AllocationError`: a single thread
  that stages past the budget without taking fails loudly instead of
  deadlocking.  The ``raft_tpu_tile_staged_bytes`` gauge's high water
  shows the budget held.  ``discard()`` releases a tile's charge without
  taking it (the unwind path of a failed scan).

A pool on the CPU (``device="cpu"``) copies synchronously and has no
stream, event or pinned block; that route exists only where the caller
asks for the CPU.  A pool on ``"cuda"`` that cannot pin or copy raises;
it never carries on in pageable memory.

Metrics (labelled ``pool=``): ``raft_tpu_h2d_bytes_total``,
``raft_tpu_h2d_seconds`` (stage to observed ready, per tile: an upper
bound under the overlapped loop), ``raft_tpu_h2d_stall_seconds`` (the
exposed part: the wait in ``take()`` while the card was idle, plus the
stage's host time when nothing overlapped it) and the
``raft_tpu_tile_staged_bytes`` gauge.  The hidden share of the transfer
is ``1 - stall / h2d``.  ``stage()`` and ``take()`` run in the
``ooc.prefetch`` span of the default profiler.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable

import numpy as np
import torch

from raft_tpu_torch.core import metrics as _metrics
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.error import AllocationError, expects
from raft_tpu_torch.core.profiler import default_profiler

__all__ = ["StagedTile", "TilePool"]


def _pool_counter(name: str, help: str, pool: str):
    return _metrics.default_registry().counter(name, help=help, labels=("pool",)).labels(pool=pool)


def _pool_gauge(name: str, help: str, pool: str):
    return _metrics.default_registry().gauge(name, help=help, labels=("pool",)).labels(pool=pool)


def _pool_timer(name: str, help: str, pool: str):
    return _metrics.default_registry().timer(name, help=help, labels=("pool",)).labels(pool=pool)


class StagedTile:
    """One in-flight host-to-device tile (what ``stage()`` returns and
    ``take()`` consumes).  Not constructed by callers."""

    __slots__ = ("vecs", "ids", "event", "nbytes", "t_issue", "stage_s", "hidden", "taken")

    def __init__(self, vecs, ids, event, nbytes, t_issue, stage_s, hidden):
        self.vecs = vecs          # (tile_slots, cap, d) tensor, copy in flight
        self.ids = ids            # (tile_slots,) int32 slot ids, -1 pad
        self.event = event        # CUDA event after the copy (None on the CPU)
        self.nbytes = nbytes
        self.t_issue = t_issue
        self.stage_s = stage_s    # host seconds of the gather and the issue
        self.hidden = hidden      # was compute in flight to hide it?
        self.taken = False


class _Block:
    """A pinned host block of the ring and the event of the copy that
    last read it."""

    __slots__ = ("vecs", "ids", "event")

    def __init__(self, shape, dtype, tile_slots):
        self.vecs = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.ids = torch.empty((tile_slots,), dtype=torch.int32, pin_memory=True)
        expects(self.vecs.is_pinned() and self.ids.is_pinned(),
                "TilePool: the host staging block could not be pinned")
        self.event = None


class TilePool:
    """Budgeted staging pool for host-resident slot stores.

    Parameters
    ----------
    tile_slots:
        Slots per staged tile: the fixed leading dimension of every tile.
    budget_bytes:
        Cap on bytes staged and not yet taken.  Must hold at least two
        tiles of the largest store streamed through the pool, or double
        buffering cannot form (checked per ``stage``).
    name:
        The ``pool=`` metric label (services pass their name).
    device:
        Where tiles land (default ``"cuda"``; ``"cpu"`` copies
        synchronously).
    clock:
        Injectable monotonic clock (tests).
    stage_wait_s:
        How long a ``stage()`` waits for room before it raises.

    The pool is thread-safe and passive: it owns no thread and no store.
    Callers pass the host store to each ``stage()``, so an atomic index
    swap (compaction) never races a stream in flight: a search that began
    on the old snapshot keeps gathering from the old store.
    """

    RING = 3

    def __init__(self, tile_slots: int, budget_bytes: int, *, name: str = "tilepool",
                 device="cuda", clock: Callable[[], float] = time.monotonic,
                 stage_wait_s: float = 30.0):
        expects(tile_slots >= 1, "TilePool: tile_slots=%d", tile_slots)
        expects(budget_bytes >= 1, "TilePool: budget_bytes=%d", budget_bytes)
        self.tile_slots = int(tile_slots)
        self.budget_bytes = int(budget_bytes)
        self.name = name
        self.device = resolve_device(device)
        self._clock = clock
        self._stage_wait_s = float(stage_wait_s)
        self._lock = threading.Condition()
        self._staged_bytes = 0
        self.n_staged = 0
        self.n_taken = 0
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda" else None)
        # the pinned ring, free blocks oldest first; a block is out of the
        # deque while a thread gathers into it
        self._free: "collections.deque[_Block]" = collections.deque()
        self._block_key = None

    def staged_bytes(self) -> int:
        with self._lock:
            return self._staged_bytes

    def tile_bytes(self, store: np.ndarray) -> int:
        """Bytes one staged tile of ``store`` occupies (vectors and ids)."""
        per_slot = int(np.prod(store.shape[1:], dtype=np.int64)) * store.dtype.itemsize
        return self.tile_slots * (per_slot + 4)

    def _gauge(self):
        return _pool_gauge("raft_tpu_tile_staged_bytes",
                           "bytes staged on device and not yet taken (high_water "
                           "proves the budget held)", self.name)

    def _acquire_block(self, src: torch.Tensor) -> _Block:
        """A pinned block for one tile of ``src``'s slot shape, once the
        copy that last read it has completed."""
        key = (tuple(src.shape[1:]), src.dtype)
        shape = (self.tile_slots,) + key[0]
        with self._lock:
            if self._block_key != key:
                # another slot shape (a compaction's store): the old ring
                # goes once its copies are done
                for blk in self._free:
                    if blk.event is not None:
                        blk.event.synchronize()
                self._free.clear()
                self._block_key = key
                for _ in range(self.RING):
                    self._free.append(_Block(shape, src.dtype, self.tile_slots))
            blk = self._free.popleft() if self._free else None
        if blk is None:
            # more threads staging at once than the ring has blocks
            blk = _Block(shape, src.dtype, self.tile_slots)
        elif blk.event is not None:
            blk.event.synchronize()
        return blk

    def _release_block(self, blk: _Block, src: torch.Tensor) -> None:
        with self._lock:
            if self._block_key == (tuple(src.shape[1:]), src.dtype):
                self._free.append(blk)

    def stage(self, store: np.ndarray, slot_ids: np.ndarray, *,
              hidden: bool = True) -> StagedTile:
        """Gather ``store[slot_ids]`` into a tile and issue its copy to the
        device (asynchronous on the card).  ``slot_ids`` shorter than
        ``tile_slots`` is padded with -1 (pad rows hold slot 0's content;
        the scan never reads them).  ``hidden=False`` marks a stage that
        nothing overlaps (the synchronous arm, or a batch's first tile
        with no hot scan before it), so the stall accounting stays honest.

        Waits while the budget is full (a concurrent ``take`` makes room);
        raises :class:`AllocationError` after ``stage_wait_s``.
        """
        ids = np.asarray(slot_ids, np.int32).ravel()
        expects(ids.shape[0] <= self.tile_slots,
                "TilePool.stage: %d slot ids exceed tile_slots=%d", ids.shape[0],
                self.tile_slots)
        nbytes = self.tile_bytes(store)
        expects(2 * nbytes <= self.budget_bytes,
                "TilePool.stage: budget_bytes=%d cannot double-buffer %d-byte tiles "
                "(need >= 2 tiles)", self.budget_bytes, nbytes)
        deadline = self._clock() + self._stage_wait_s
        with self._lock:
            while self._staged_bytes + nbytes > self.budget_bytes:
                remaining = deadline - self._clock()
                if remaining <= 0.0:
                    raise AllocationError(
                        "TilePool(%s).stage: budget %d bytes full (%d staged) and no take() "
                        "freed room within %.1fs" % (self.name, self.budget_bytes,
                                                     self._staged_bytes, self._stage_wait_s),
                        requested_bytes=nbytes, live_bytes=self._staged_bytes)
                self._lock.wait(timeout=min(remaining, 0.05))
            self._staged_bytes += nbytes
            self.n_staged += 1
            self._gauge().set(self._staged_bytes)
        t0 = self._clock()
        try:
            with default_profiler().span("ooc.prefetch", layer="ooc"):
                if ids.shape[0] < self.tile_slots:
                    ids = np.concatenate([ids, np.full(self.tile_slots - ids.shape[0], -1,
                                                       np.int32)])
                src = torch.from_numpy(store)
                rows = torch.from_numpy(np.clip(ids, 0, store.shape[0] - 1).astype(np.int64))
                if self._stream is None:
                    vecs = torch.index_select(src.view(src.shape[0], -1), 0, rows).view(
                        (self.tile_slots,) + src.shape[1:])
                    ids_d, event = torch.from_numpy(ids), None
                else:
                    vecs, ids_d, event = self._copy_to_card(src, rows, ids)
        except BaseException:
            with self._lock:
                self._staged_bytes -= nbytes
                self._gauge().set(self._staged_bytes)
                self._lock.notify_all()
            raise
        stage_s = self._clock() - t0
        _pool_counter("raft_tpu_h2d_bytes_total", "bytes streamed host-to-device by tile pools",
                      self.name).inc(nbytes)
        return StagedTile(vecs, ids_d, event, nbytes, t0, stage_s, hidden)

    def _copy_to_card(self, src, rows, ids):
        """Gather into a pinned block and copy it on the side stream;
        returns the device tensors and the event after the copy."""
        blk = self._acquire_block(src)
        try:
            torch.index_select(src.view(src.shape[0], -1), 0, rows,
                               out=blk.vecs.view(self.tile_slots, -1))
            blk.ids.copy_(torch.from_numpy(ids))
            # the copy reads only the pinned block and writes fresh memory
            # of the side stream: it waits for nothing of the caller's
            # stream, so it overlaps the scan running there
            with torch.cuda.stream(self._stream):
                vecs = blk.vecs.to(self.device, non_blocking=True)
                ids_d = blk.ids.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            blk.event = event
        finally:
            self._release_block(blk, src)
        return vecs, ids_d, event

    def take(self, tile: StagedTile, busy: bool = False):
        """Wait for the tile's copy and hand over its ``(vecs, ids)``
        tensors, ordered on the caller's current stream.  Records the
        transfer's wall time (``h2d_seconds``, stage to ready) and the
        exposed stall: the time blocked here counts as stalled only when
        ``busy`` is False (the caller says whether device compute was in
        flight at the call: a wait that overlaps a running scan is hidden
        time, the point of the double buffer), plus the stage's host time
        when the stage itself overlapped nothing."""
        expects(not tile.taken, "TilePool.take: tile already taken")
        t0 = self._clock()
        try:
            with default_profiler().span("ooc.prefetch", layer="ooc"):
                if tile.event is not None:
                    tile.event.synchronize()
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(tile.event)
                    tile.vecs.record_stream(cur)
                    tile.ids.record_stream(cur)
        except BaseException:
            # a failed transfer releases its budget charge, or the pool
            # shrinks for good
            self.discard(tile)
            raise
        now = self._clock()
        wait_s = now - t0
        _pool_timer("raft_tpu_h2d_seconds",
                    "tile transfer wall, stage to observed-ready (upper bound under the "
                    "overlapped loop)", self.name).observe(max(0.0, now - tile.t_issue))
        _pool_timer("raft_tpu_h2d_stall_seconds",
                    "transfer time NOT hidden behind compute (take block while the device "
                    "was idle, plus stage host time when unoverlapped)", self.name).observe(
                        (0.0 if busy else wait_s) + (0.0 if tile.hidden else tile.stage_s))
        self._release(tile)
        self.n_taken += 1
        return tile.vecs, tile.ids

    def discard(self, tile: StagedTile) -> None:
        """Release a staged tile's budget charge without consuming it (the
        unwind path of a driver whose scan failed between ``stage`` and
        ``take``); idempotent, and a no-op on a taken tile."""
        self._release(tile)

    def _release(self, tile: StagedTile) -> None:
        with self._lock:
            if tile.taken:
                return
            tile.taken = True
            self._staged_bytes -= tile.nbytes
            self._gauge().set(self._staged_bytes)
            self._lock.notify_all()
