"""Memory resources: owning buffers, pooling and out-of-core tile streaming.

Port of ``raft_tpu/mr`` (reference ``raft::mr``, cpp/include/raft/mr/:
``base_allocator`` at mr/allocator.hpp:35 with its device and host
variants, and the owning ``buffer_base`` at mr/buffer_base.hpp:39).
PyTorch's caching allocator owns the card's heap (RMM's role), so what
carries over is the lifetime and reuse story:

- :class:`DeviceBuffer` / :class:`HostBuffer`: owning buffers with an
  explicit ``deallocate()``;
- :class:`PoolAllocator`: freelist reuse of same-(shape, dtype) buffers
  under a count and a byte bound;
- :class:`ZerosPool` / :func:`zeros_cached`: shared zero blocks keyed by
  (shape, dtype, device);
- :class:`TilePool`: budgeted, double-buffered host-to-device tile
  streaming for the out-of-core IVF-Flat tier (pinned blocks, a side
  stream, an event per tile);
- :func:`device_memory_stats`: bytes in use, the limit and the peak
  (``cudaMemGetInfo``'s role).

Every class takes ``device=`` (default ``"cuda"``); ``device="cpu"``
holds CPU tensors.
"""

from raft_tpu_torch.mr.buffer import (DeviceBuffer, HostBuffer, PoolAllocator, ZerosPool,
                                      default_zeros_pool, device_memory_stats, zeros_cached)
from raft_tpu_torch.mr.tile_pool import StagedTile, TilePool

__all__ = [
    "DeviceBuffer",
    "HostBuffer",
    "PoolAllocator",
    "StagedTile",
    "TilePool",
    "ZerosPool",
    "default_zeros_pool",
    "device_memory_stats",
    "zeros_cached",
]
