"""Write-ahead log for acknowledged streaming inserts.

Port of ``raft_tpu/persist/wal.py``, byte for byte the same format: a
log written by either package replays in the other.  The durability
half of :meth:`raft_tpu_torch.serve.ANNService.insert`: every accepted ``(ids, vectors)`` batch is
appended here — with a per-record checksum — **before** the insert is
acknowledged, so a crash can lose only work the caller was never told
succeeded.  The fsync policy knob (``persist_fsync``) picks the
acknowledge contract: ``"always"`` fsyncs before every ack (no
acknowledged loss, ever), ``"batch"`` defers the fsync to the next
maintenance tick (bounded loss window, much cheaper), ``"off"`` leaves
durability to the OS page cache (process-crash-safe, power-loss-unsafe).

File layout, raw binary, no pickle:

- **file header** (32 bytes): ``b"RTPUWAL1"``, version u32, dim u32,
  8-byte dtype tag (numpy ``.str`` padded with NULs), header CRC32.
- **record** (24-byte header + payload): ``b"RREC"``, seq u64, rows
  u32, header CRC32 (over seq+rows — a bit-flipped length field must
  not reclassify interior corruption as a torn tail), payload CRC32;
  payload = ids ``int32`` LE then vectors ``dtype`` LE, row-major.

Replay tolerates exactly one failure shape: a **torn trailing
record** — the file ends before the declared bytes complete (the
crash cut an append short); the valid prefix is returned and the torn
bytes are truncated away.  *Any* other failure — bad record magic, a
header or payload checksum mismatch on a complete record — is interior
corruption and raises a typed
:class:`~raft_tpu_torch.core.error.DataCorruptionError` naming file, offset,
and expected-vs-actual checksum: silently skipping an interior record
would silently lose an acknowledged insert.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import List, Optional, Tuple

import numpy as np

from raft_tpu_torch.core.error import DataCorruptionError, expects

FILE_MAGIC = b"RTPUWAL1"
FILE_VERSION = 1
REC_MAGIC = b"RREC"
_FILE_HDR = struct.Struct("<8sII8sI")   # magic, version, dim, dtype, crc
_REC_HDR = struct.Struct("<4sQIII")     # magic, seq, rows, hdr crc, crc

FSYNC_POLICIES = ("always", "batch", "off")

__all__ = ["WriteAheadLog", "replay_wal", "FSYNC_POLICIES"]


def _dtype_tag(dtype: np.dtype) -> bytes:
    tag = np.dtype(dtype).str.encode()
    expects(len(tag) <= 8, "WAL: dtype tag %r too long", tag)
    return tag.ljust(8, b"\0")


# Chaos/test seam: when set, called (no args) immediately before every
# fsync; the fleet's chaos hooks (raft_tpu_torch/fleet/worker.py) inject
# fsync stalls here.  None in production.
FSYNC_HOOK = None


def _fsync(f) -> None:
    hook = FSYNC_HOOK
    if hook is not None:
        hook()
    f.flush()
    os.fsync(f.fileno())


def _file_header(dim: int, dtype: np.dtype) -> bytes:
    body = _FILE_HDR.pack(FILE_MAGIC, FILE_VERSION, dim,
                          _dtype_tag(dtype), 0)[:-4]
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def _parse_file_header(path: str, data: bytes) -> Tuple[int, np.dtype]:
    magic, version, dim, tag, crc = _FILE_HDR.unpack_from(data)
    actual = zlib.crc32(data[:_FILE_HDR.size - 4]) & 0xFFFFFFFF
    if magic != FILE_MAGIC or version != FILE_VERSION or actual != crc:
        raise DataCorruptionError(
            "WAL file header is corrupt", path, offset=0,
            expected_crc=crc, actual_crc=actual)
    return int(dim), np.dtype(tag.rstrip(b"\0").decode())


def replay_wal(path: str, *, min_seq: int = 0):
    """Scan ``path`` and return ``(records, info)``.

    ``records`` is ``[(seq, ids int32 (n,), vecs (n, dim)), ...]`` for
    every valid record with ``seq > min_seq``; ``info`` carries
    ``dim``, ``dtype``, ``last_seq`` (across ALL valid records, not
    just the returned ones), ``valid_end`` (byte offset of the last
    valid record's end — the truncation point when ``torn``), and
    ``torn`` (a trailing record was cut short by a crash).  Interior
    corruption raises :class:`DataCorruptionError` (module doc).
    Returns ``(None, None)`` for a missing or zero-length file.
    """
    if not os.path.isfile(path) or os.path.getsize(path) == 0:
        return None, None
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FILE_HDR.size:
        # the very first header write was itself torn: nothing was
        # ever acknowledged through this file — treat as empty
        return None, {"dim": None, "dtype": None, "last_seq": 0,
                      "valid_end": 0, "torn": True,
                      "total_records": 0}
    dim, dtype = _parse_file_header(path, data)
    itemsize = dtype.itemsize
    records: List[Tuple[int, np.ndarray, np.ndarray]] = []
    off = _FILE_HDR.size
    last_seq = 0
    torn = False
    valid_end = off
    total = 0
    size = len(data)
    while off < size:
        if size - off < _REC_HDR.size:
            torn = True
            break
        magic, seq, rows, hcrc, pcrc = _REC_HDR.unpack_from(data, off)
        if magic != REC_MAGIC:
            raise DataCorruptionError(
                "WAL record magic mismatch (interior corruption)",
                path, offset=off,
                expected_crc=int.from_bytes(REC_MAGIC, "little"),
                actual_crc=int.from_bytes(magic, "little"))
        hdr_actual = zlib.crc32(data[off + 4:off + 16]) & 0xFFFFFFFF
        if hdr_actual != hcrc:
            # a complete 24-byte header with a bad CRC cannot be a
            # torn append (appends write sequentially) — corruption
            raise DataCorruptionError(
                "WAL record header failed its checksum", path,
                offset=off, expected_crc=hcrc, actual_crc=hdr_actual)
        need = rows * 4 + rows * dim * itemsize
        body_off = off + _REC_HDR.size
        if size - body_off < need:
            torn = True
            break
        body = data[body_off:body_off + need]
        actual = zlib.crc32(body) & 0xFFFFFFFF
        if actual != pcrc:
            raise DataCorruptionError(
                "WAL record payload failed its checksum", path,
                offset=body_off, expected_crc=pcrc, actual_crc=actual)
        if seq > min_seq:
            ids = np.frombuffer(body, np.dtype("<i4"),
                                count=rows).astype(np.int32)
            vecs = np.frombuffer(
                body, dtype, count=rows * dim,
                offset=rows * 4).reshape(rows, dim).copy()
            records.append((int(seq), ids, vecs))
        last_seq = max(last_seq, int(seq))
        total += 1
        off = body_off + need
        valid_end = off
    return records, {"dim": dim, "dtype": dtype, "last_seq": last_seq,
                     "valid_end": valid_end, "torn": torn,
                     "total_records": total}


class WriteAheadLog:
    """Append handle over one WAL file (thread-safe).

    Created fresh (``dim``/``dtype`` known from the first append) or
    re-opened after :func:`replay_wal` validated the file; a torn tail
    must be truncated away (``os.truncate`` to ``valid_end``) before
    re-opening for append.
    """

    def __init__(self, path: str, dim: int, dtype, *,
                 fsync: str = "always", start_seq: int = 0):
        expects(fsync in FSYNC_POLICIES,
                "WriteAheadLog: fsync=%r not in %r", fsync,
                FSYNC_POLICIES)
        self.path = path
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.fsync_policy = fsync
        self._lock = threading.Lock()
        self._seq = int(start_seq)
        self._unsynced = False
        fresh = (not os.path.isfile(path)
                 or os.path.getsize(path) == 0)
        self._f = open(path, "ab")
        if fresh:
            self._f.write(_file_header(self.dim, self.dtype))
            _fsync(self._f)

    @property
    def seq(self) -> int:
        return self._seq

    def tell(self) -> int:
        with self._lock:
            return self._f.tell()

    def append(self, ids: np.ndarray, vecs: np.ndarray) -> int:
        """Append one record; returns its sequence number.  Durable
        per the fsync policy BEFORE returning (the acknowledge
        contract — the caller acks its insert only after this)."""
        ids = np.ascontiguousarray(ids, np.dtype("<i4"))
        vecs = np.ascontiguousarray(np.asarray(vecs),
                                    self.dtype.newbyteorder("<"))
        expects(vecs.ndim == 2 and vecs.shape[1] == self.dim,
                "WAL append: expected (rows, %d) vectors, got %r",
                self.dim, tuple(vecs.shape))
        expects(ids.shape[0] == vecs.shape[0],
                "WAL append: %d ids for %d rows", ids.shape[0],
                vecs.shape[0])
        body = ids.tobytes() + vecs.tobytes()
        with self._lock:
            self._seq += 1
            seq = self._seq
            hdr_body = struct.pack("<QI", seq, ids.shape[0])
            rec = (REC_MAGIC + hdr_body
                   + struct.pack("<II",
                                 zlib.crc32(hdr_body) & 0xFFFFFFFF,
                                 zlib.crc32(body) & 0xFFFFFFFF)
                   + body)
            self._f.write(rec)
            if self.fsync_policy == "always":
                _fsync(self._f)
            else:
                self._f.flush()
                self._unsynced = True
        return seq

    def sync(self) -> bool:
        """Flush deferred writes to disk (the ``"batch"`` policy's
        maintenance-tick fsync); True when a sync was actually due."""
        with self._lock:
            if not self._unsynced or self._f.closed:
                return False
            _fsync(self._f)
            self._unsynced = False
            return True

    def truncate_through(self, min_seq: int) -> int:
        """Drop every record with ``seq <= min_seq`` (they are now
        contained in a durable snapshot) by atomically rewriting the
        file with only the newer records; returns how many survive.
        Runs entirely under the append lock, so a concurrent
        :meth:`append` can never be read half-written (and thus
        misclassified as a torn tail) or lost by the rewrite."""
        with self._lock:
            self._f.flush()
            records, _info = replay_wal(self.path, min_seq=min_seq)
            keep = records or []
            self._rewrite_locked(keep)
            return len(keep)

    def _rewrite_locked(self, keep_records) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_file_header(self.dim, self.dtype))
            for seq, ids, vecs in keep_records:
                ids_b = np.ascontiguousarray(
                    ids, np.dtype("<i4")).tobytes()
                vecs_b = np.ascontiguousarray(
                    vecs, self.dtype.newbyteorder("<")).tobytes()
                hdr_body = struct.pack("<QI", int(seq),
                                       int(np.shape(ids)[0]))
                f.write(REC_MAGIC + hdr_body + struct.pack(
                    "<II", zlib.crc32(hdr_body) & 0xFFFFFFFF,
                    zlib.crc32(ids_b + vecs_b) & 0xFFFFFFFF)
                    + ids_b + vecs_b)
            _fsync(f)
        self._f.close()
        os.replace(tmp, self.path)
        d = os.path.dirname(os.path.abspath(self.path))
        try:
            fd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass
        self._f = open(self.path, "ab")
        self._unsynced = False

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                if self._unsynced:
                    _fsync(self._f)
                self._f.close()

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0
