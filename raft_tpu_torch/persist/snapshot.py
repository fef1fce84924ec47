"""Versioned, manifest-driven, CRC-checksummed index snapshots.

Port of ``raft_tpu/persist/snapshot.py``, byte for byte the same format:
a snapshot that either package writes loads in the other, and the two
write the same bytes for the same index, seq and delta.  One snapshot is
a directory of **raw little-endian array files** plus a JSON
``MANIFEST.json`` (``sort_keys``) describing them: dtype, shape and a
per-chunk CRC32 list per array.  It is written **atomically**: arrays
and manifest land in a hidden temp directory, every file is fsynced, the
directory is renamed into place, and only then does the ``CURRENT``
pointer file (itself written tmp + fsync + rename) name it.  A crash at
any point leaves the old snapshot or the new one whole; stray temp
directories are ignored by the loader and swept by the next writer.

No pickle: every array round-trips as raw C-order little-endian bytes,
so a snapshot never executes code on load.  Per-chunk checksums (1 MiB
by default; the out-of-core slot store is chunked **per slot**, so a
chunk index is a slot id) let a corruption error name the failing byte
offset, and let the scrubber (:mod:`raft_tpu_torch.persist.manager`)
re-verify the snapshot a few chunks at a time and rebuild single slots.

Load rebuilds the index that was saved (IVF-Flat, IVF-PQ, IVF-SQ, or the
out-of-core :class:`~raft_tpu_torch.spatial.ooc.OocIVFFlat`) on the
caller's ``device`` with every chunk's CRC verified; a mismatch raises
:class:`~raft_tpu_torch.core.error.DataCorruptionError` naming the file,
the offset and both checksums.  Tensors are read back to the host for
writing.  An out-of-core store stays a host numpy array, and with
``mmap_store=True`` an ``np.memmap`` in mode ``"c"`` (copy-on-write: a
scrub repair changes memory, never the snapshot file), verified by CRC
as the file streams past and never read into memory whole.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.error import DataCorruptionError, expects
from raft_tpu_torch.distance.distance_type import DistanceType

SNAPSHOT_FORMAT = "raft_tpu-snapshot"
SNAPSHOT_VERSION = 1
DEFAULT_CHUNK_BYTES = 1 << 20
MANIFEST_NAME = "MANIFEST.json"
CURRENT_NAME = "CURRENT"
SNAPSHOTS_DIR = "snapshots"

__all__ = ["write_snapshot", "load_current", "current_manifest",
           "snapshot_dir", "SNAPSHOT_VERSION"]

OOC_KIND = "OocIVFFlat"


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Durably record directory-entry changes (the rename)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platforms without O_RDONLY dirs: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _as_le(arr) -> np.ndarray:
    """Host C-order little-endian view/copy of any array input (a tensor
    is read back from its device)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return a


def snapshot_dir(root: str, name: str) -> str:
    return os.path.join(root, SNAPSHOTS_DIR, name)


# --------------------------------------------------------------------- #
# array codec
# --------------------------------------------------------------------- #
def _write_array(dirpath: str, name: str, arr,
                 chunk_bytes: int) -> Dict:
    """Stream one array to ``<name>.bin`` computing per-chunk CRC32s;
    returns its manifest entry.  Chunks are sliced from a flat byte
    view, never a ``tobytes()`` copy."""
    a = _as_le(arr)
    fname = "%s.bin" % name
    crcs = []
    nbytes = int(a.nbytes)
    view = memoryview(a).cast("B") if nbytes else memoryview(b"")
    with open(os.path.join(dirpath, fname), "wb") as f:
        for off in range(0, max(nbytes, 1), chunk_bytes):
            chunk = view[off:off + chunk_bytes]
            crcs.append(zlib.crc32(chunk) & 0xFFFFFFFF)
            f.write(chunk)
        _fsync_file(f)
    return {"name": name, "file": fname, "dtype": a.dtype.str,
            "shape": list(a.shape), "nbytes": nbytes,
            "chunk_bytes": int(chunk_bytes), "crc32s": crcs}


def _read_array(dirpath: str, entry: Dict, *, mmap: bool = False) -> np.ndarray:
    """Read one array file into a fresh buffer, verifying every chunk's
    CRC; a mismatch, or a file of another length than the manifest
    says, is typed corruption.  ``mmap`` verifies the file through one
    chunk-sized buffer and returns a copy-on-write ``np.memmap`` of it."""
    path = os.path.join(dirpath, entry["file"])
    chunk_bytes = int(entry["chunk_bytes"])
    crcs = entry["crc32s"]
    nbytes = int(entry["nbytes"])
    dtype, shape = np.dtype(entry["dtype"]), tuple(entry["shape"])
    buf = np.empty(min(chunk_bytes, nbytes) if mmap else nbytes, np.uint8)
    view = memoryview(buf)
    read_total = 0
    with open(path, "rb") as f:
        for i, expected in enumerate(crcs):
            off = i * chunk_bytes
            want = min(chunk_bytes, max(nbytes - off, 0))
            at = 0 if mmap else off          # the mmap arm reuses one chunk's buffer
            got = f.readinto(view[at:at + want]) if want else 0
            actual = zlib.crc32(view[at:at + got]) & 0xFFFFFFFF
            if actual != expected or got < want:
                raise DataCorruptionError(
                    "snapshot array %r failed its chunk checksum"
                    % entry["name"], path, offset=off,
                    expected_crc=expected, actual_crc=actual)
            read_total += got
        if f.read(1):
            read_total += 1
    if read_total != nbytes:
        raise DataCorruptionError(
            "snapshot array %r is not %d bytes long, as the manifest says"
            % (entry["name"], nbytes), path, offset=min(read_total, nbytes))
    if mmap:
        if nbytes == 0:
            return np.zeros(shape, dtype)
        return np.memmap(path, dtype=dtype, mode="c", shape=shape)
    return buf.view(dtype).reshape(shape)


# --------------------------------------------------------------------- #
# index kind registry
# --------------------------------------------------------------------- #
def _kind_of(index) -> str:
    return type(index).__name__


def _flat_fields(index):
    arrays = {"centroids": index.centroids, "slot_vecs": index.slot_vecs,
              "slot_ids": index.slot_ids,
              "slot_centroid": index.slot_centroid,
              "cent_slots": index.cent_slots,
              "list_sizes": index.list_sizes}
    if index.slot_norms is not None:
        arrays["slot_norms"] = index.slot_norms
    return arrays, {"metric": int(index.metric),
                    "nprobe": int(index.nprobe)}


def _pq_fields(index):
    arrays = {"centroids": index.centroids, "codebooks": index.codebooks,
              "slot_codes": index.slot_codes, "slot_ids": index.slot_ids,
              "slot_centroid": index.slot_centroid,
              "cent_slots": index.cent_slots,
              "list_sizes": index.list_sizes}
    if index.vectors is not None:
        arrays["vectors"] = index.vectors
    return arrays, {"metric": int(index.metric),
                    "nprobe": int(index.nprobe),
                    "refine_ratio": int(index.refine_ratio)}


def _sq_fields(index):
    arrays = {"centroids": index.centroids, "slot_q": index.slot_q,
              "scale": index.scale, "offset": index.offset,
              "slot_ids": index.slot_ids,
              "slot_centroid": index.slot_centroid,
              "cent_slots": index.cent_slots,
              "list_sizes": index.list_sizes}
    return arrays, {"metric": int(index.metric),
                    "nprobe": int(index.nprobe),
                    "encode_residual": bool(index.encode_residual)}


def _ooc_fields(index):
    arrays = {"centroids": index.centroids, "slot_ids": index.slot_ids,
              "slot_norms": index.slot_norms,
              "cent_slots": index.cent_slots,
              "slot_centroid": index.slot_centroid,
              "list_sizes": index.list_sizes, "store": index.store}
    return arrays, {"metric": int(index.metric),
                    "nprobe": int(index.nprobe)}


_FIELDS = {"IVFFlatIndex": _flat_fields, "IVFPQIndex": _pq_fields,
           "IVFSQIndex": _sq_fields, OOC_KIND: _ooc_fields}


def _rebuild_flat(a, meta, t):
    from raft_tpu_torch.spatial.ann import IVFFlatIndex

    norms = a.get("slot_norms")
    return IVFFlatIndex(
        t(a["centroids"]), t(a["slot_vecs"]), t(a["slot_ids"]), t(a["slot_centroid"]),
        t(a["cent_slots"]), t(a["list_sizes"]), DistanceType(int(meta["metric"])),
        int(meta["nprobe"]), slot_norms=None if norms is None else t(norms))


def _rebuild_pq(a, meta, t):
    from raft_tpu_torch.spatial.ann import IVFPQIndex

    vecs = a.get("vectors")
    return IVFPQIndex(
        t(a["centroids"]), t(a["codebooks"]), t(a["slot_codes"]), t(a["slot_ids"]),
        t(a["slot_centroid"]), t(a["cent_slots"]), t(a["list_sizes"]),
        DistanceType(int(meta["metric"])), int(meta["nprobe"]),
        vectors=None if vecs is None else t(vecs),
        refine_ratio=int(meta.get("refine_ratio", 1)))


def _rebuild_sq(a, meta, t):
    from raft_tpu_torch.spatial.ann import IVFSQIndex

    return IVFSQIndex(
        t(a["centroids"]), t(a["slot_q"]), t(a["scale"]), t(a["offset"]), t(a["slot_ids"]),
        t(a["slot_centroid"]), t(a["cent_slots"]), t(a["list_sizes"]),
        DistanceType(int(meta["metric"])), int(meta["nprobe"]), bool(meta["encode_residual"]))


def _rebuild_ooc(a, meta, t):
    from raft_tpu_torch.spatial.ooc import OocIVFFlat

    # the store stays on the host (a memmap where the loader was asked
    # for one); only the small metadata goes to the device
    return OocIVFFlat(
        t(a["centroids"]), t(a["slot_ids"]), t(a["slot_norms"]), t(a["cent_slots"]),
        np.asarray(a["slot_centroid"], np.int32), t(a["list_sizes"]),
        DistanceType(int(meta["metric"])), int(meta["nprobe"]), a["store"])


_REBUILD = {"IVFFlatIndex": _rebuild_flat, "IVFPQIndex": _rebuild_pq,
            "IVFSQIndex": _rebuild_sq, OOC_KIND: _rebuild_ooc}


# --------------------------------------------------------------------- #
# write
# --------------------------------------------------------------------- #
def write_snapshot(root: str, index, *, seq: int, wal_seq: int,
                   delta: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                   chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> Dict:
    """Write one atomic snapshot of ``index`` (+ the live delta rows)
    under ``root`` and flip ``CURRENT`` to it; returns the manifest.

    ``wal_seq`` is the last write-ahead-log sequence number whose
    insert is *contained* in this snapshot's state — restart replays
    only records beyond it.  ``delta=(vecs, ids)`` are the delta
    segment's live rows (host arrays, already sliced to the fill
    count).  Older snapshot directories are swept after the flip.
    """
    kind = _kind_of(index)
    expects(kind in _FIELDS,
            "write_snapshot: unsupported index kind %s", kind)
    arrays, meta = _FIELDS[kind](index)
    name = "snapshot-%010d" % int(seq)
    snaps = os.path.join(root, SNAPSHOTS_DIR)
    os.makedirs(snaps, exist_ok=True)
    tmp = os.path.join(snaps, ".tmp-%s" % name)
    if os.path.isdir(tmp):  # stale garbage from a crashed writer
        _rmtree(tmp)
    os.makedirs(tmp)
    entries = []
    total = 0
    for aname, arr in arrays.items():
        cb = chunk_bytes
        if kind == OOC_KIND and aname == "store":
            # the bulk store chunked per slot: a chunk index is a slot id,
            # which lets the scrubber verify and rebuild single slots
            cb = max(int(arr.shape[1]) * int(arr.shape[2]) * arr.dtype.itemsize, 1)
        e = _write_array(tmp, aname, arr, cb)
        entries.append(e)
        total += e["nbytes"]
    delta_rows = 0
    if delta is not None and delta[0].shape[0]:
        dvecs, dids = delta
        delta_rows = int(dvecs.shape[0])
        for aname, arr in (("delta_vecs", dvecs), ("delta_ids", dids)):
            e = _write_array(tmp, aname, arr, chunk_bytes)
            entries.append(e)
            total += e["nbytes"]
    manifest = {"format": SNAPSHOT_FORMAT, "version": SNAPSHOT_VERSION,
                "kind": kind, "seq": int(seq), "wal_seq": int(wal_seq),
                "meta": meta, "delta_rows": delta_rows,
                "total_bytes": total, "arrays": entries}
    mbytes = json.dumps(manifest, indent=1, sort_keys=True).encode()
    with open(os.path.join(tmp, MANIFEST_NAME), "wb") as f:
        f.write(mbytes)
        _fsync_file(f)
    _fsync_dir(tmp)
    final = os.path.join(snaps, name)
    if os.path.isdir(final):
        # orphan from a crash between a previous writer's directory
        # rename and its CURRENT flip: CURRENT still names the older
        # snapshot, so this seq was re-issued — the orphan is garbage
        # and rename(2) cannot replace a non-empty directory
        _rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(snaps)
    # flip CURRENT (tmp + fsync + rename): its manifest CRC is what
    # lets the loader detect a tampered/corrupt manifest
    cur_tmp = os.path.join(root, CURRENT_NAME + ".tmp")
    with open(cur_tmp, "w", encoding="utf-8") as f:
        f.write("%s %d\n" % (name, zlib.crc32(mbytes) & 0xFFFFFFFF))
        _fsync_file(f)
    os.replace(cur_tmp, os.path.join(root, CURRENT_NAME))
    _fsync_dir(root)
    # sweep superseded snapshots (and crashed writers' temp dirs)
    for other in os.listdir(snaps):
        if other != name:
            _rmtree(os.path.join(snaps, other))
    return manifest


def _rmtree(path: str) -> None:
    try:
        for fname in os.listdir(path):
            os.unlink(os.path.join(path, fname))
        os.rmdir(path)
    except OSError:
        pass  # sweep is best-effort; a leftover dir is inert


# --------------------------------------------------------------------- #
# load
# --------------------------------------------------------------------- #
def _read_current(root: str):
    cur = os.path.join(root, CURRENT_NAME)
    if not os.path.isfile(cur):
        return None
    with open(cur, encoding="utf-8") as f:
        line = f.read().strip()
    parts = line.split()
    if len(parts) != 2 or not parts[1].isdigit():
        raise DataCorruptionError(
            "CURRENT pointer is unparseable: %r" % line, cur)
    return parts[0], int(parts[1])


def current_manifest(root: str) -> Optional[Dict]:
    """Read + verify the CURRENT snapshot's manifest (no array IO);
    None when the directory holds no snapshot."""
    cur = _read_current(root)
    if cur is None:
        return None
    name, crc = cur
    mpath = os.path.join(snapshot_dir(root, name), MANIFEST_NAME)
    try:
        with open(mpath, "rb") as f:
            mbytes = f.read()
    except OSError:
        raise DataCorruptionError(
            "CURRENT names snapshot %s but its manifest is unreadable"
            % name, mpath) from None
    actual = zlib.crc32(mbytes) & 0xFFFFFFFF
    if actual != crc:
        raise DataCorruptionError(
            "snapshot manifest failed its checksum", mpath, offset=0,
            expected_crc=crc, actual_crc=actual)
    try:
        manifest = json.loads(mbytes)
    except ValueError:
        raise DataCorruptionError(
            "snapshot manifest is not valid JSON", mpath) from None
    if (manifest.get("format") != SNAPSHOT_FORMAT
            or manifest.get("version") != SNAPSHOT_VERSION):
        raise DataCorruptionError(
            "snapshot manifest format/version mismatch: %r/%r"
            % (manifest.get("format"), manifest.get("version")), mpath)
    manifest["_dir"] = snapshot_dir(root, name)
    manifest["_name"] = name
    return manifest


def load_current(root: str, *, mmap_store: bool = False, device="cuda"):
    """Load the CURRENT snapshot: ``(index, delta_vecs, delta_ids,
    manifest)`` with every chunk CRC verified, the index's tensors on
    ``device`` and the delta rows as numpy, or None when no snapshot
    exists.  ``mmap_store`` backs an out-of-core store with a
    copy-on-write ``np.memmap`` instead of reading it into memory (the
    file is still read once to verify it)."""
    dev = resolve_device(device)
    manifest = current_manifest(root)
    if manifest is None:
        return None
    sdir = manifest["_dir"]
    kind = manifest["kind"]
    expects(kind in _REBUILD, "load_current: unknown index kind %s",
            kind)
    arrays = {}
    for entry in manifest["arrays"]:
        arrays[entry["name"]] = _read_array(
            sdir, entry, mmap=mmap_store and kind == OOC_KIND and entry["name"] == "store")
    delta_vecs = arrays.pop("delta_vecs", None)
    delta_ids = arrays.pop("delta_ids", None)
    index = _REBUILD[kind](arrays, manifest["meta"],
                           lambda a: torch.from_numpy(a).to(dev))
    return index, delta_vecs, delta_ids, manifest
