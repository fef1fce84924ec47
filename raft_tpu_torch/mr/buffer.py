"""Owning buffers, a pool allocator and shared zero blocks.

Port of ``raft_tpu/mr/buffer.py`` (see the package doc for the mapping
to the reference's mr/allocator.hpp:35 and buffer_base.hpp:39).

Memory accounting, as in the JAX package: every owning buffer reports
into the default metrics registry: ``raft_tpu_mr_live_bytes{space=}``
(a gauge; its ``high_water`` is the peak), ``raft_tpu_mr_alloc_total``,
``raft_tpu_mr_free_total`` and ``raft_tpu_mr_alloc_bytes_total``
(counters), and the pools' hit, miss and eviction counters.  An
allocation that fails raises
:class:`~raft_tpu_torch.core.error.AllocationError` carrying the
requested bytes and the live bytes, instead of PyTorch's own error."""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import metrics as _metrics
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.error import AllocationError, expects

__all__ = ["DeviceBuffer", "HostBuffer", "PoolAllocator", "ZerosPool", "default_zeros_pool",
           "device_memory_stats", "zeros_cached"]


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _gauge_live(space: str):
    return _metrics.default_registry().gauge(
        "raft_tpu_mr_live_bytes",
        help="bytes held by live raft_tpu buffers (high_water = peak)",
        labels=("space",)).labels(space=space)


def _account_alloc(space: str, nbytes: int):
    """Record an allocation; returns (bytes accounted, registry
    generation).  The bytes are None when recording is disabled (not 0:
    a zero-size allocation still records its alloc and free pair), so
    the buffer schedules the free of exactly what was recorded: the pair
    balances even if recording is toggled in the buffer's lifetime, and
    is dropped if the registry was reset in between."""
    reg = _metrics.default_registry()
    if not _metrics.is_enabled():
        return None, reg.generation
    # under the registry lock, so that the generation returned is the one
    # the gauge update landed in; _add_raw, not inc: both halves of the
    # pair bypass the enable gate alike
    with reg.locked():
        _gauge_live(space)._add_raw(nbytes)
        reg.counter("raft_tpu_mr_alloc_total", help="buffer allocations",
                    labels=("space",)).labels(space=space).inc()
        reg.counter("raft_tpu_mr_alloc_bytes_total", help="cumulative bytes allocated",
                    labels=("space",)).labels(space=space).inc(nbytes)
        return nbytes, reg.generation


def _account_free(space: str, nbytes: int, generation: int) -> None:
    reg = _metrics.default_registry()
    # the generation check is atomic with the adjustment; the gauge half
    # bypasses the enable gate (it balances an alloc that was recorded),
    # the free counter stays gated (a rate metric)
    with reg.locked():
        if generation != reg.generation:
            return  # the recorded alloc died with a registry reset
        _gauge_live(space)._add_raw(-nbytes)
        reg.counter("raft_tpu_mr_free_total", help="buffer frees",
                    labels=("space",)).labels(space=space).inc()


def device_memory_stats(device=None) -> Dict[str, int]:
    """Bytes in use, the limit and the peak for a CUDA device
    (``cudaMemGetInfo``'s role, reference cudart_utils.h), from
    ``torch.cuda.mem_get_info`` (the limit: the card's total) and
    ``torch.cuda.memory_stats`` (in use and peak: the caching allocator's
    allocated bytes).  A CPU device has no such statistics: {}."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    _, total = torch.cuda.mem_get_info(dev)
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(total),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0))}


def _released(t: torch.Tensor) -> bool:
    """Whether a tensor's storage was freed under it (resized to 0)."""
    return t.numel() > 0 and t.untyped_storage().nbytes() == 0


class DeviceBuffer:
    """Owning device allocation with an explicit lifetime (reference
    ``device_buffer``, mr/buffer_base.hpp:39): a zero-filled tensor on
    ``device`` (default ``"cuda"``).

    ``deallocate()`` drops the buffer's tensor now, rather than when the
    garbage collector gets to the buffer: its memory goes back to
    PyTorch's caching allocator once no other reference holds it (an
    adopted tensor the caller still holds stays valid, unlike the JAX
    package's ``delete``).
    """

    _space = "device"

    def __init__(self, shape: Tuple[int, ...], dtype=torch.float32, device="cuda",
                 _array: Optional[torch.Tensor] = None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        self._accounted, self._accounted_gen = None, 0
        if _array is not None:
            self._array: Optional[torch.Tensor] = _array
        else:
            try:
                self._array = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
            except RuntimeError as e:       # torch.OutOfMemoryError included
                raise AllocationError(
                    "DeviceBuffer allocation failed on %s: %s" % (self.device, e),
                    requested_bytes=self.size_bytes(),
                    live_bytes=int(_gauge_live(self._space).value)) from e
        self._accounted, self._accounted_gen = _account_alloc(self._space, self.size_bytes())

    @classmethod
    def from_array(cls, array: torch.Tensor) -> "DeviceBuffer":
        """Adopt an existing tensor, on its device (reference buffer_base's
        pointer-adopting constructor)."""
        return cls(array.shape, array.dtype, array.device, _array=array)

    @property
    def data(self) -> torch.Tensor:
        """The live tensor (reference ``buffer.data()``)."""
        expects(self._array is not None, "DeviceBuffer: use after deallocate")
        return self._array

    def size_bytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * torch.empty(
            0, dtype=self.dtype).element_size()

    @property
    def deallocated(self) -> bool:
        return self._array is None

    def deallocate(self) -> None:
        """Drop the buffer's tensor now; idempotent."""
        self._array = None
        self._release_accounting()

    def _release_accounting(self) -> None:
        if self._accounted is not None:
            _account_free(self._space, self._accounted, self._accounted_gen)
            self._accounted = None

    def __enter__(self) -> "DeviceBuffer":
        return self

    def __exit__(self, *exc) -> None:
        self.deallocate()

    def __del__(self):
        # the garbage collector is a legal end of the lifetime: the
        # accounting follows it, or the live gauge drifts upward for every
        # buffer dropped without deallocate(); guarded for interpreter
        # shutdown, when the metrics module may be gone
        try:
            if getattr(self, "_accounted", None) is not None:
                self._release_accounting()
        except Exception:  # noqa: BLE001 — nothing to report to at shutdown
            pass


class HostBuffer(DeviceBuffer):
    """Host-side owning buffer (reference ``host_buffer``): a zero-filled
    CPU tensor with the same explicit-lifetime interface."""

    _space = "host"

    def __init__(self, shape: Tuple[int, ...], dtype=torch.float32,
                 _array: Optional[torch.Tensor] = None):
        super().__init__(shape, dtype, "cpu", _array=_array)

    @classmethod
    def from_array(cls, array) -> "HostBuffer":
        """Adopt a numpy array or CPU tensor without a copy."""
        t = torch.from_numpy(array) if isinstance(array, np.ndarray) else array
        expects(t.device.type == "cpu", "HostBuffer.from_array: a CPU array is required")
        return cls(t.shape, t.dtype, _array=t)


class PoolAllocator:
    """Freelist reuse of same-(shape, dtype) device buffers (the role of
    RMM's pool resource for repeated workspace allocations).

    ``allocate`` returns a pooled buffer when one matches, else a fresh
    one; ``deallocate`` returns the buffer to the pool (its memory stays
    held for reuse); ``release`` frees everything pooled.  As with RMM's
    pool, a hit returns the buffer with its previous contents; only a
    fresh allocation is zero-filled.

    ``max_bytes`` bounds the bytes pooled across every key: when a
    ``deallocate`` would exceed it, the least recently pooled buffers are
    freed (oldest first, across keys) until it holds; a buffer alone
    over the bound is never pooled.  ``None`` keeps the per-key count as
    the only bound.  Evictions are counted (``n_evictions``,
    ``raft_tpu_mr_pool_evictions_total``).
    """

    def __init__(self, device="cuda", max_pooled_per_key: int = 4,
                 max_bytes: Optional[int] = None):
        expects(max_bytes is None or max_bytes >= 1, "PoolAllocator: max_bytes=%r", max_bytes)
        self.device = resolve_device(device)
        self.max_pooled_per_key = max_pooled_per_key
        self.max_bytes = max_bytes
        self._free: Dict[Tuple, List[DeviceBuffer]] = {}
        # pooled buffers in pooling order (oldest first): the byte bound's
        # eviction order, kept in step with _free
        self._order: List[DeviceBuffer] = []
        self._bytes = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_evictions = 0

    @staticmethod
    def _key(shape, dtype):
        return (tuple(int(s) for s in shape), torch_dtype(dtype))

    def allocate(self, shape, dtype=torch.float32) -> DeviceBuffer:
        reg = _metrics.default_registry()
        bucket = self._free.get(self._key(shape, dtype))
        if bucket:
            self.n_hits += 1
            reg.counter("raft_tpu_mr_pool_hits_total",
                        help="pool allocations served from freelist").inc()
            buf = bucket.pop()
            self._order.remove(buf)
            self._bytes -= buf.size_bytes()
            return buf
        self.n_misses += 1
        reg.counter("raft_tpu_mr_pool_misses_total",
                    help="pool allocations needing fresh memory").inc()
        return DeviceBuffer(shape, dtype, self.device)

    def _evict_oldest(self) -> None:
        buf = self._order.pop(0)
        self._free[self._key(buf.shape, buf.dtype)].remove(buf)
        self._bytes -= buf.size_bytes()
        self.n_evictions += 1
        _metrics.default_registry().counter(
            "raft_tpu_mr_pool_evictions_total",
            help="pooled buffers freed to hold the byte budget").inc()
        buf.deallocate()

    def deallocate(self, buf: DeviceBuffer) -> None:
        expects(not buf.deallocated, "PoolAllocator: cannot pool a deallocated buffer")
        nbytes = buf.size_bytes()
        if self.max_bytes is not None and nbytes > self.max_bytes:
            # a buffer alone over the bound can never be pooled: freeing
            # the whole pool for it would be strictly worse
            buf.deallocate()
            return
        bucket = self._free.setdefault(self._key(buf.shape, buf.dtype), [])
        if len(bucket) >= self.max_pooled_per_key:
            buf.deallocate()
            return
        bucket.append(buf)
        self._order.append(buf)
        self._bytes += nbytes
        if self.max_bytes is not None:
            while self._bytes > self.max_bytes:
                self._evict_oldest()

    def pooled_bytes(self) -> int:
        return self._bytes

    def release(self) -> None:
        """Free all pooled memory (RMM pool release)."""
        for bs in self._free.values():
            for b in bs:
                b.deallocate()
        self._free.clear()
        self._order.clear()
        self._bytes = 0


class ZerosPool:
    """Shared zero blocks keyed by (shape, dtype, device).

    The padding paths keep needing the same constant zero blocks (a
    served batch's pad rows, staging rows); one cached block per key,
    shared by every reader, replaces a fresh ``torch.zeros`` per call.
    Torch tensors are mutable, so a block is read-only by convention:
    compose it (``torch.cat``, ``torch.where``), never write into it.  A
    block whose storage a consumer freed is replaced.  (Contrast
    :class:`PoolAllocator`, whose buffers are owned exclusively and carry
    stale contents.)

    A bounded LRU, by block count (``max_entries``) and by bytes
    (``max_bytes``); a block larger than ``max_bytes`` is returned fresh
    and never cached.  Thread-safe; hits and misses are counted
    (``raft_tpu_mr_zeros_pool_{hits,misses}_total``).  ``device`` is the
    blocks' device when a call names none (default ``"cuda"``).
    """

    def __init__(self, max_entries: int = 64, max_bytes: int = 64 << 20, device=None):
        expects(max_entries >= 1, "ZerosPool: max_entries=%d", max_entries)
        expects(max_bytes >= 1, "ZerosPool: max_bytes=%d", max_bytes)
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.device = device
        self._lock = threading.Lock()
        self._blocks: "collections.OrderedDict[Tuple, torch.Tensor]" = collections.OrderedDict()
        self._bytes = 0
        self.n_hits = 0
        self.n_misses = 0

    @staticmethod
    def _key_bytes(key) -> int:
        shape, dtype, _ = key
        return int(np.prod(shape, dtype=np.int64)) * torch.empty(0, dtype=dtype).element_size()

    def _counter(self, name: str):
        return _metrics.default_registry().counter(name, help="zeros-pool block reuse")

    def get(self, shape, dtype=torch.float32, device=None) -> torch.Tensor:
        """The shared zero block for (shape, dtype) on ``device`` (default:
        the pool's, else ``"cuda"``).  Read-only by convention."""
        dev = resolve_device(device or self.device or "cuda")
        key = (tuple(int(s) for s in shape), torch_dtype(dtype), dev)
        nbytes = self._key_bytes(key)
        with self._lock:
            blk = self._blocks.get(key)
            if blk is not None and not _released(blk):
                self._blocks.move_to_end(key)
                self.n_hits += 1
                self._counter("raft_tpu_mr_zeros_pool_hits_total").inc()
                return blk
            self.n_misses += 1
            self._counter("raft_tpu_mr_zeros_pool_misses_total").inc()
        # allocate outside the lock; a racing duplicate is harmless (the
        # last writer keeps the slot)
        blk = torch.zeros(key[0], dtype=key[1], device=dev)
        if nbytes > self.max_bytes:
            return blk                 # oversize: never cached
        with self._lock:
            old = self._blocks.get(key)
            if old is None:
                self._bytes += nbytes
            self._blocks[key] = blk
            self._blocks.move_to_end(key)
            while self._blocks and (len(self._blocks) > self.max_entries
                                    or self._bytes > self.max_bytes):
                old_key, _ = self._blocks.popitem(last=False)
                self._bytes -= self._key_bytes(old_key)
        return blk

    def pooled_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._blocks)

    def release(self) -> None:
        """Drop every cached block (readers still holding one keep it)."""
        with self._lock:
            self._blocks.clear()
            self._bytes = 0


_default_zeros_pool = ZerosPool()


def default_zeros_pool() -> ZerosPool:
    """The process-wide shared zeros cache (what :func:`zeros_cached`
    reads)."""
    return _default_zeros_pool


def zeros_cached(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """The shared zero block of (shape, dtype) on ``device`` (default
    ``"cuda"``) from the default :class:`ZerosPool`: a drop-in for
    ``torch.zeros`` on hot paths that re-create the same constant block."""
    return _default_zeros_pool.get(shape, dtype, device)
