"""Durable ANN serving state: snapshots and a write-ahead log.

Port of ``raft_tpu/persist``, on the same on-disk format (a snapshot or a
log that either package writes, the other reads):

- :mod:`~raft_tpu_torch.persist.snapshot`: versioned, manifest-driven,
  per-chunk CRC32-checksummed snapshots of the IVF indexes (raw
  little-endian arrays and a JSON manifest, no pickle), written
  atomically (tmp + fsync + rename, then ``CURRENT``) and loaded with
  every checksum verified;
- :mod:`~raft_tpu_torch.persist.wal`: the write-ahead log that
  ``ANNService.insert`` appends to before it acknowledges (checksummed
  records, the ``persist_fsync`` policy), replayed on restart: a torn
  trailing record is tolerated, interior corruption raises
  :class:`~raft_tpu_torch.core.error.DataCorruptionError`;
- :mod:`~raft_tpu_torch.persist.manager`: :class:`PersistManager`, which
  ties both to a service's maintenance seam (interval snapshots that
  never tear a batch, WAL truncation, restore, incremental scrubbing).

Services use it through ``ANNService(persist_dir=...)``, the out-of-core
arm too: its host store is chunked per slot, restored into memory or as a
copy-on-write memory map (``persist_mmap``), and scrubbed slot by slot.
"""

from raft_tpu_torch.persist.manager import PersistManager, RestoredState
from raft_tpu_torch.persist.snapshot import current_manifest, load_current, write_snapshot
from raft_tpu_torch.persist.wal import FSYNC_POLICIES, WriteAheadLog, replay_wal

__all__ = [
    "PersistManager", "RestoredState",
    "write_snapshot", "load_current", "current_manifest",
    "WriteAheadLog", "replay_wal", "FSYNC_POLICIES",
]
