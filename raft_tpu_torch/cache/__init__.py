"""Set-associative vector cache (reference cpp/include/raft/cache/)."""

from raft_tpu_torch.cache.cache import CacheState, VecCache  # noqa: F401
