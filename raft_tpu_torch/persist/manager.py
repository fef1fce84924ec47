"""PersistManager: one durability authority per serving index.

Port of ``raft_tpu/persist/manager.py``.  Glues the snapshot format (:mod:`raft_tpu_torch.persist.snapshot`) and
the write-ahead log (:mod:`raft_tpu_torch.persist.wal`) into the serving
lifecycle:

- :meth:`wal_append`: called by ``ANNService.insert`` under the delta
  lock, before the insert is acknowledged (the acknowledge contract
  follows the ``persist_fsync`` policy);
- :meth:`maintenance_tick`: on the serve worker's maintenance seam,
  takes an interval-gated snapshot of the service's immutable
  ``_AnnState`` (so snapshotting never tears a batch), truncates the WAL
  of everything the snapshot now holds, and runs one scrub step;
- :meth:`restore`: load the CURRENT snapshot (every chunk CRC
  verified), then replay the WAL tail (records newer than the
  snapshot's ``wal_seq``), tolerating a torn trailing record but
  raising :class:`~raft_tpu_torch.core.error.DataCorruptionError` on
  interior corruption;
- :meth:`scrub_step`: re-checksum a few snapshot chunks a tick against
  the manifest; for an out-of-core service the store's chunks are per
  slot, and a host-store slot whose bytes in memory no longer match is
  **quarantined and rebuilt** from the (verified) snapshot copy instead
  of serving corrupt distances.  A mismatch is counted
  (``raft_tpu_scrub_*`` metrics) and recorded with a flight-recorder
  black box; one that cannot be repaired fails
  ``stats()["corruption_detected"]``.

Every wall-clock read goes through the injected ``clock`` (the owning
service's), so tests drive snapshot intervals with a fake clock.
"""

from __future__ import annotations

import os
import time
import zlib
from typing import NamedTuple, Optional

import numpy as np

from raft_tpu_torch import config
from raft_tpu_torch.core import flight
from raft_tpu_torch.core import metrics as _metrics
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.persist import snapshot as _snap
from raft_tpu_torch.persist import wal as _wal

__all__ = ["PersistManager", "RestoredState"]

WAL_NAME = "wal.log"


class RestoredState(NamedTuple):
    """What :meth:`PersistManager.restore` recovered from disk."""

    index: object                 # rebuilt index, or None (WAL-only)
    delta_vecs: Optional[np.ndarray]
    delta_ids: Optional[np.ndarray]
    delta_rows: int
    wal_seq: int                  # last seq contained in the snapshot
    wal_records: list             # [(seq, ids, vecs)] to replay
    manifest: Optional[dict]


class _ScrubUnit(NamedTuple):
    path: str
    array: str
    offset: int
    length: int
    crc: int
    slot: Optional[int]           # store slot id (out-of-core) or None


def _labeled_metric(kind: str, name: str, help: str, service: str):
    return getattr(_metrics.default_registry(), kind)(
        name, help=help, labels=("service",)).labels(service=service)


class PersistManager:
    """Durability authority for one service (module doc).

    Parameters
    ----------
    root:
        The persist directory (created if missing): ``snapshots/`` +
        ``CURRENT`` + ``wal.log`` live under it.  One service per
        directory.
    service:
        Metric/flight label (the owning service's name).
    fsync:
        WAL fsync policy (``"always"`` | ``"batch"`` | ``"off"``);
        None resolves the ``persist_fsync`` knob: ``"always"`` fsyncs
        before every acknowledge, ``"batch"`` at the next maintenance
        tick, ``"off"`` leaves it to the OS.
    snapshot_interval_s:
        Minimum seconds between interval-driven snapshots (a dirty
        state older than this snapshots on the next maintenance tick);
        None resolves ``persist_snapshot_interval_s``.
    scrub_chunks:
        Integrity-scrub units (snapshot chunks, and store slots of an
        out-of-core index) verified per maintenance tick; ``0`` disables scrubbing.  None resolves
        ``persist_scrub_chunks``.
    clock:
        Monotonic-seconds callable shared with the owning service.
    device:
        Where a restored index's tensors go (default ``"cuda"``; an
        out-of-core store stays on the host).
    """

    def __init__(self, root: str, *, service: str,
                 fsync: Optional[str] = None,
                 snapshot_interval_s: Optional[float] = None,
                 scrub_chunks: Optional[int] = None,
                 clock=None, device="cuda"):
        self.device = resolve_device(device)
        self.root = str(root)
        self.service = str(service)
        os.makedirs(os.path.join(self.root, _snap.SNAPSHOTS_DIR),
                    exist_ok=True)
        if fsync is None:
            fsync = config.get("persist_fsync")
        expects(fsync in _wal.FSYNC_POLICIES,
                "PersistManager: persist_fsync=%r not in %r", fsync,
                _wal.FSYNC_POLICIES)
        self.fsync_policy = fsync
        if snapshot_interval_s is None:
            snapshot_interval_s = config.get_float(
                "persist_snapshot_interval_s")
        expects(snapshot_interval_s > 0,
                "PersistManager: snapshot_interval_s=%r",
                snapshot_interval_s)
        self.snapshot_interval_s = float(snapshot_interval_s)
        if scrub_chunks is None:
            scrub_chunks = config.get_int("persist_scrub_chunks")
        expects(scrub_chunks >= 0,
                "PersistManager: scrub_chunks=%d", scrub_chunks)
        self.scrub_chunks = int(scrub_chunks)
        self._clock = clock if clock is not None else time.monotonic
        self._wal_path = os.path.join(self.root, WAL_NAME)
        self._wal: Optional[_wal.WriteAheadLog] = None
        self._wal_depth = 0
        self._base_seq = 0            # seq floor for a fresh WAL file
        self._next_snap_seq = 1
        self._last_snapshot_t: Optional[float] = None
        self._snapshot_bytes = 0
        self._snapshot_seq = 0
        self._dirty = False
        self._replayed = 0
        self._restore_torn = False
        # scrub state
        self._scrub_units: list = []
        self._scrub_cursor = 0
        self._scrub_cycles = 0
        self._store_ref = None        # the out-of-core store the plan describes
        self._store_dtype = None
        self._store_shape = None
        self.corruption_detected = False
        self.last_scrub: dict = {"checked": 0, "errors": 0,
                                 "rebuilt": 0, "cycles": 0,
                                 "last_error": None}

    @property
    def snapshot_seq(self) -> int:
        """Sequence of the CURRENT snapshot (0 = none on disk yet)."""
        return self._snapshot_seq

    # ------------------------------------------------------------------ #
    # restore
    # ------------------------------------------------------------------ #
    def has_state(self) -> bool:
        return (os.path.isfile(os.path.join(self.root,
                                            _snap.CURRENT_NAME))
                or (os.path.isfile(self._wal_path)
                    and os.path.getsize(self._wal_path) > 0))

    def restore(self, *, mmap_store: bool = False) -> RestoredState:
        """Load snapshot + WAL tail (module doc).  The torn-tail case
        truncates the file so later appends start from a clean end.
        ``mmap_store`` backs an out-of-core store with a copy-on-write
        ``np.memmap`` (:func:`~raft_tpu_torch.persist.snapshot.load_current`)."""
        t0 = self._clock()
        index = None
        dvecs = dids = None
        rows = 0
        wal_seq = 0
        manifest = None
        loaded = _snap.load_current(self.root, mmap_store=mmap_store, device=self.device)
        if loaded is not None:
            index, dvecs, dids, manifest = loaded
            rows = int(manifest["delta_rows"])
            wal_seq = int(manifest["wal_seq"])
            self._next_snap_seq = int(manifest["seq"]) + 1
            self._snapshot_seq = int(manifest["seq"])
            self._snapshot_bytes = int(manifest["total_bytes"])
            self._last_snapshot_t = self._clock()
            self._install_scrub_plan(manifest, index)
        records, info = _wal.replay_wal(self._wal_path,
                                        min_seq=wal_seq)
        records = records or []
        last_seq = wal_seq
        if info is not None:
            if info["torn"]:
                # the tolerated failure: the crash cut the final
                # append short — nothing past valid_end was ever
                # acknowledged, so truncating it loses nothing
                self._restore_torn = True
                os.truncate(self._wal_path, info["valid_end"])
                flight.record("wal_torn", service=self.service,
                              valid_end=int(info["valid_end"]))
            if info["dim"] is not None:
                last_seq = max(wal_seq, int(info["last_seq"]))
                self._wal = _wal.WriteAheadLog(
                    self._wal_path, info["dim"], info["dtype"],
                    fsync=self.fsync_policy, start_seq=last_seq)
                # depth = records NOT yet contained in a snapshot: a
                # crash between write_snapshot and truncate_through
                # leaves already-covered records (seq <= wal_seq) in
                # the file — replay skips them and so must the gauge
                # (counting them would also make final_snapshot write
                # a spurious snapshot for a clean state)
                self._wal_depth = len(records)
        self._base_seq = last_seq
        self._replayed = len(records)
        if records:
            self._dirty = True
        _labeled_metric("counter", "raft_tpu_persist_restores_total",
                    "crash-restart restores from the persist "
                    "directory", self.service).inc()
        if records:
            _labeled_metric("counter",
                        "raft_tpu_persist_wal_replayed_total",
                        "WAL records replayed into the delta segment "
                        "at restore", self.service).inc(len(records))
        _labeled_metric("timer", "raft_tpu_persist_restore_seconds",
                    "snapshot-load + WAL-replay restore latency",
                    self.service).observe(
                        max(0.0, self._clock() - t0))
        self._publish_wal_gauges()
        flight.record("restore", service=self.service,
                      snapshot_seq=self._snapshot_seq,
                      delta_rows=rows, wal_records=len(records),
                      torn=self._restore_torn)
        return RestoredState(index, dvecs, dids, rows, wal_seq,
                             records, manifest)

    # ------------------------------------------------------------------ #
    # WAL
    # ------------------------------------------------------------------ #
    def wal_append(self, ids: np.ndarray, vecs: np.ndarray) -> int:
        """Append one acknowledged-insert record (durable per the
        fsync policy before returning); returns its sequence number.
        The caller (``ANNService.insert``) holds its delta lock, so
        appends are ordered exactly like the delta mirror writes."""
        if self._wal is None:
            v = np.asarray(vecs)
            self._wal = _wal.WriteAheadLog(
                self._wal_path, int(v.shape[1]), v.dtype,
                fsync=self.fsync_policy, start_seq=self._base_seq)
        seq = self._wal.append(np.asarray(ids), np.asarray(vecs))
        self._wal_depth += 1
        self._dirty = True
        _labeled_metric("counter", "raft_tpu_persist_wal_appends_total",
                    "insert batches appended to the write-ahead log",
                    self.service).inc()
        self._publish_wal_gauges()
        return seq

    def _publish_wal_gauges(self) -> None:
        _labeled_metric("gauge", "raft_tpu_persist_wal_records",
                    "insert records in the WAL not yet contained in a "
                    "snapshot", self.service).set(self._wal_depth)
        _labeled_metric("gauge", "raft_tpu_persist_wal_bytes",
                    "write-ahead-log file size", self.service).set(
                        self._wal.size_bytes()
                        if self._wal is not None else 0)

    def note_dirty(self) -> None:
        """Mark durable state stale (a compaction swap: the snapshot
        on disk no longer matches the served index)."""
        self._dirty = True

    # ------------------------------------------------------------------ #
    # snapshot
    # ------------------------------------------------------------------ #
    def snapshot(self, state) -> dict:
        """Write one atomic snapshot of the immutable serving
        ``state`` (an ``_AnnState``) and truncate the WAL of
        everything it contains; returns the manifest."""
        t0 = self._clock()
        rows = int(state.delta_rows)
        delta = None
        if rows:
            delta = (state.delta_vecs[:rows].cpu().numpy(),
                     state.delta_ids[:rows].cpu().numpy())
        wal_seq = int(getattr(state, "wal_seq", 0))
        manifest = _snap.write_snapshot(
            self.root, state.index, seq=self._next_snap_seq,
            wal_seq=wal_seq, delta=delta)
        self._next_snap_seq += 1
        self._snapshot_seq = int(manifest["seq"])
        self._snapshot_bytes = int(manifest["total_bytes"])
        if self._wal is not None:
            kept = self._wal.truncate_through(wal_seq)
            dropped = max(0, self._wal_depth - kept)
            self._wal_depth = kept
            if dropped:
                _labeled_metric("counter",
                            "raft_tpu_persist_wal_truncated_total",
                            "WAL records dropped because a snapshot "
                            "now contains them", self.service).inc(
                                dropped)
        self._dirty = False
        self._last_snapshot_t = self._clock()
        self._install_scrub_plan(manifest, state.index)
        dt = max(0.0, self._clock() - t0)
        _labeled_metric("counter", "raft_tpu_persist_snapshots_total",
                    "snapshots written", self.service).inc()
        _labeled_metric("gauge", "raft_tpu_persist_snapshot_bytes",
                    "bytes in the CURRENT snapshot",
                    self.service).set(self._snapshot_bytes)
        _labeled_metric("gauge", "raft_tpu_persist_snapshot_seq",
                    "sequence number of the CURRENT snapshot",
                    self.service).set(self._snapshot_seq)
        _labeled_metric("timer", "raft_tpu_persist_snapshot_seconds",
                    "atomic snapshot write latency",
                    self.service).observe(dt)
        self._publish_wal_gauges()
        flight.record("snapshot", service=self.service,
                      seq=self._snapshot_seq, delta_rows=rows,
                      bytes=self._snapshot_bytes,
                      seconds=round(dt, 6))
        return manifest

    def final_snapshot(self, state) -> bool:
        """The clean-shutdown snapshot (``Service.close``): persist
        the final state so a restart never needs WAL replay; True
        when a snapshot was actually written (dirty state or pending
        WAL records)."""
        if not (self._dirty or self._wal_depth):
            if self._wal is not None:
                self._wal.sync()
            return False
        self.snapshot(state)
        return True

    # ------------------------------------------------------------------ #
    # the maintenance seam
    # ------------------------------------------------------------------ #
    def maintenance_tick(self, state, ooc=None) -> None:
        """One pass on the serve worker's maintenance seam: deferred
        WAL fsync (the ``"batch"`` policy), interval-gated snapshot of
        a dirty state, one scrub step, age gauge."""
        if self._wal is not None and self.fsync_policy == "batch":
            self._wal.sync()
        now = self._clock()
        if self._dirty and (
                self._last_snapshot_t is None
                or now - self._last_snapshot_t
                >= self.snapshot_interval_s):
            self.snapshot(state)
        self.scrub_step(ooc)
        age = (0.0 if self._last_snapshot_t is None
               else max(0.0, self._clock() - self._last_snapshot_t))
        _labeled_metric("gauge", "raft_tpu_persist_snapshot_age_seconds",
                    "seconds since the CURRENT snapshot was written "
                    "(0 before the first)", self.service).set(age)

    # ------------------------------------------------------------------ #
    # integrity scrubbing
    # ------------------------------------------------------------------ #
    def _install_scrub_plan(self, manifest: dict, index) -> None:
        sdir = manifest.get("_dir") or _snap.snapshot_dir(
            self.root, "snapshot-%010d" % manifest["seq"])
        units = []
        is_ooc = manifest["kind"] == _snap.OOC_KIND
        for entry in manifest["arrays"]:
            path = os.path.join(sdir, entry["file"])
            cb = int(entry["chunk_bytes"])
            nb = int(entry["nbytes"])
            # the out-of-core store is chunked per slot: a chunk index is
            # a slot id
            per_slot = is_ooc and entry["name"] == "store"
            for i, crc in enumerate(entry["crc32s"]):
                off = i * cb
                units.append(_ScrubUnit(path, entry["name"], off,
                                        min(cb, max(nb - off, 0)), int(crc),
                                        i if per_slot else None))
            if per_slot:
                self._store_dtype = np.dtype(entry["dtype"])
                self._store_shape = tuple(entry["shape"])
        self._scrub_units = units
        self._scrub_cursor = 0
        self._store_ref = getattr(index, "store", None)

    def _scrub_failure(self, unit: _ScrubUnit, actual, where: str,
                       repaired: bool) -> None:
        self.last_scrub["errors"] += 1
        self.last_scrub["last_error"] = {
            "array": unit.array, "file": unit.path,
            "offset": unit.offset, "where": where,
            "expected_crc": unit.crc, "actual_crc": actual,
            "repaired": repaired,
        }
        if not repaired:
            self.corruption_detected = True
        _labeled_metric("counter", "raft_tpu_scrub_corruption_total",
                    "integrity-scrub checksum mismatches (snapshot "
                    "chunks or host-store slots)", self.service).inc()
        flight.record("scrub_corruption", service=self.service,
                      array=unit.array, offset=unit.offset, where=where,
                      repaired=repaired)
        flight.default_recorder().blackbox("scrub_corruption",
                                           service=self.service)

    def scrub_step(self, ooc=None) -> None:
        """Verify the next ``scrub_chunks`` units of the CURRENT snapshot
        and, for an out-of-core service (``ooc``, the served
        ``OocIVFFlat``), the matching in-memory host-store slots: a slot
        whose bytes no longer match is quarantined and rebuilt from the
        verified snapshot copy.  Never raises: findings land in metrics,
        flight black boxes and :attr:`last_scrub`."""
        units = self._scrub_units
        if self.scrub_chunks <= 0 or not units:
            return
        checked = 0
        for _ in range(min(self.scrub_chunks, len(units))):
            unit = units[self._scrub_cursor]
            self._scrub_cursor += 1
            if self._scrub_cursor >= len(units):
                self._scrub_cursor = 0
                self._scrub_cycles += 1
                self.last_scrub["cycles"] = self._scrub_cycles
            checked += 1
            try:
                with open(unit.path, "rb") as f:
                    f.seek(unit.offset)
                    data = f.read(unit.length)
            except OSError:
                self._scrub_failure(unit, None, "snapshot-file-io", repaired=False)
                continue
            actual = zlib.crc32(data) & 0xFFFFFFFF
            file_ok = actual == unit.crc and len(data) == unit.length
            if not file_ok:
                self._scrub_failure(unit, actual, "snapshot-file", repaired=False)
            if (unit.slot is not None and ooc is not None
                    and ooc.store is self._store_ref
                    and unit.slot < ooc.store.shape[0]):
                self._scrub_slot(ooc.store, unit, data, file_ok)
        self.last_scrub["checked"] += checked
        _labeled_metric("counter", "raft_tpu_scrub_checked_total",
                    "snapshot chunks / store slots integrity-checked",
                    self.service).inc(checked)
        _labeled_metric("gauge", "raft_tpu_scrub_progress",
                    "position in the current scrub cycle (fraction "
                    "of units verified)", self.service).set(
                        self._scrub_cursor / max(len(units), 1))

    def _scrub_slot(self, store: np.ndarray, unit: _ScrubUnit, data: bytes,
                    file_ok: bool) -> None:
        """Check one host-store slot against its snapshot chunk; rebuild it
        from the snapshot's bytes when those verified (the corrupt bytes
        never serve another distance), else report it unrepairable."""
        mem_crc = zlib.crc32(np.ascontiguousarray(store[unit.slot]).tobytes()) & 0xFFFFFFFF
        if mem_crc == unit.crc:
            return
        if not (file_ok and store.flags.writeable):
            # both copies bad: health fails until a compaction rewrites
            # the slot and a fresh snapshot lands
            self._scrub_failure(unit, mem_crc, "host-store-slot", repaired=False)
            return
        store[unit.slot] = np.frombuffer(data, self._store_dtype).reshape(self._store_shape[1:])
        self._scrub_failure(unit, mem_crc, "host-store-slot", repaired=True)
        self.last_scrub["rebuilt"] += 1
        _labeled_metric("counter", "raft_tpu_scrub_rebuilt_slots_total",
                        "poisoned host-store slots rebuilt from the snapshot copy",
                        self.service).inc()
        flight.record("slot_rebuilt", service=self.service, slot=int(unit.slot))

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        age = (None if self._last_snapshot_t is None
               else round(max(0.0,
                              self._clock() - self._last_snapshot_t),
                          3))
        return {
            "dir": self.root,
            "fsync": self.fsync_policy,
            "snapshot_seq": self._snapshot_seq,
            "snapshot_bytes": self._snapshot_bytes,
            "snapshot_age_s": age,
            # stale = dirty state that has outlived 3 intervals
            # without a snapshot landing (surfaced, not ok-failing;
            # corruption is what fails health)
            "snapshot_stale": bool(
                self._dirty and age is not None
                and age > 3.0 * self.snapshot_interval_s),
            "snapshot_interval_s": self.snapshot_interval_s,
            "wal_records": self._wal_depth,
            "wal_bytes": (self._wal.size_bytes()
                          if self._wal is not None else 0),
            "wal_seq": (self._wal.seq if self._wal is not None
                        else self._base_seq),
            "replayed_records": self._replayed,
            "restore_torn_tail": self._restore_torn,
            "dirty": self._dirty,
            "corruption_detected": self.corruption_detected,
            "last_scrub": dict(self.last_scrub),
        }

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
