"""Durable ANN serving state of the port (``raft_tpu_torch.persist``) and
its byte compatibility with the JAX package's (``raft_tpu.persist``).

- Snapshots cross both ways: one that the JAX package writes loads in the
  port with equal arrays and dtypes, and the reverse; for the same index,
  seq, WAL seq and delta the two snapshot directories are byte-identical
  (IVF-Flat, IVF-PQ with its vectors, IVF-SQ).  A write-ahead log that
  one writes replays in the other, and the same appends give the same
  file.
- The corruption matrix of the JAX suite: a flipped byte of a manifest,
  an array file, the ``CURRENT`` pointer or a WAL record raises
  ``DataCorruptionError`` naming the file and offset; a torn WAL tail is
  tolerated.
- ``ANNService(persist_dir=...)`` threadless under a fake clock: the
  insert is journaled before it is acknowledged, interval snapshots
  truncate the WAL, and a service restored from the snapshot plus the
  WAL answers every acknowledged insert, with searches bitwise equal to
  those before the crash; a directory the JAX service wrote restores in
  the port.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.persist import replay_wal as jax_replay_wal
from raft_tpu.persist import snapshot as jsnap
from raft_tpu.persist.wal import WriteAheadLog as JaxWriteAheadLog
from raft_tpu.serve import ANNService as JaxANNService
from raft_tpu.spatial import ann as jann
from raft_tpu.spatial import ooc as jooc
from raft_tpu_torch import ANNService, LogicError, RaftError
from raft_tpu_torch.convert import (ivf_flat_index_from_reference, ivf_pq_index_from_reference,
                                    ivf_sq_index_from_reference, ooc_ivf_flat_from_reference)
from raft_tpu_torch.core.error import DataCorruptionError
from raft_tpu_torch.persist import (FSYNC_POLICIES, PersistManager, WriteAheadLog,
                                    current_manifest, load_current, replay_wal, write_snapshot)
from raft_tpu_torch.spatial.ann import IVFFlatIndex, approx_knn_search

SEED = 1234
DIM = 16


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def rng():
    # another stream than the index data's: an insert that duplicated an
    # indexed row would lose the tie to the base copy
    return np.random.default_rng(SEED + 1)


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(SEED).standard_normal((900, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_indexes(data):
    X = jnp.asarray(data)
    return {
        "flat": jann.ivf_flat_build(X, jann.IVFFlatParams(nlist=8, nprobe=4), seed=SEED),
        "pq": jann.ivf_pq_build(X, jann.IVFPQParams(nlist=8, nprobe=4, M=4, refine_ratio=2),
                                seed=SEED),
        "sq": jann.ivf_sq_build(X, jann.IVFSQParams(nlist=8, nprobe=4), seed=SEED),
    }


CARRY = {"flat": ivf_flat_index_from_reference, "pq": ivf_pq_index_from_reference,
         "sq": ivf_sq_index_from_reference}


@pytest.fixture(scope="module")
def port_indexes(jax_indexes):
    return {kind: CARRY[kind](idx, device="cpu") for kind, idx in jax_indexes.items()}


@pytest.fixture
def flat_index(port_indexes):
    return port_indexes["flat"]


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)

    def same(dc):
        _, mismatch, errors = filecmp.cmpfiles(dc.left, dc.right, dc.common_files,
                                               shallow=False)
        return (not dc.left_only and not dc.right_only and not dc.funny_files
                and not mismatch and not errors
                and all(same(sub) for sub in dc.subdirs.values()))
    return same(cmp)


def _assert_index_equal(got, ref):
    assert type(got).__name__ == type(ref).__name__
    for name in type(got)._fields:
        g, r = getattr(got, name), getattr(ref, name)
        if name in ("metric", "nprobe", "refine_ratio", "encode_residual"):
            assert int(g) == int(r), name
            continue
        assert (g is None) == (r is None), name
        if g is None:
            continue
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = r.cpu().numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, name)


def _delta(rng, rows=7):
    return (rng.standard_normal((rows, DIM)).astype(np.float32),
            np.arange(100, 100 + rows, dtype=np.int32))


# --------------------------------------------------------------------- #
# snapshots across the two packages
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["flat", "pq", "sq"])
def test_same_state_gives_byte_identical_snapshot_directories(jax_indexes, port_indexes, rng,
                                                              tmp_path, kind):
    delta = _delta(rng)
    jm = jsnap.write_snapshot(str(tmp_path / "jax"), jax_indexes[kind], seq=3, wal_seq=9,
                              delta=delta)
    pm = write_snapshot(str(tmp_path / "port"), port_indexes[kind], seq=3, wal_seq=9,
                        delta=(torch.from_numpy(delta[0]), torch.from_numpy(delta[1])))
    assert pm == jm
    assert _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("kind", ["flat", "pq", "sq"])
def test_jax_snapshot_loads_in_the_port(jax_indexes, rng, tmp_path, kind):
    delta = _delta(rng)
    jsnap.write_snapshot(str(tmp_path), jax_indexes[kind], seq=1, wal_seq=4, delta=delta)
    idx, dv, di, manifest = load_current(str(tmp_path), device="cpu")
    _assert_index_equal(idx, jax_indexes[kind])
    assert manifest["delta_rows"] == 7 and manifest["wal_seq"] == 4
    np.testing.assert_array_equal(dv, delta[0])
    np.testing.assert_array_equal(di, delta[1])


@pytest.mark.parametrize("kind", ["flat", "pq", "sq"])
def test_port_snapshot_loads_in_jax(port_indexes, tmp_path, kind):
    write_snapshot(str(tmp_path), port_indexes[kind], seq=2, wal_seq=0)
    idx, dv, di, manifest = jsnap.load_current(str(tmp_path))
    _assert_index_equal(idx, port_indexes[kind])
    assert dv is None and di is None and manifest["kind"] == type(idx).__name__


@pytest.mark.parametrize("kind", ["flat", "pq", "sq"])
def test_round_trip_searches_bitwise(port_indexes, rng, tmp_path, kind):
    write_snapshot(str(tmp_path), port_indexes[kind], seq=1, wal_seq=0)
    idx, _, _, _ = load_current(str(tmp_path), device="cpu")
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    a = approx_knn_search(port_indexes[kind], q, 5, 4, device="cpu")
    b = approx_knn_search(idx, q, 5, 4, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_supersede_sweeps_old_and_stray_directories(flat_index, tmp_path):
    write_snapshot(str(tmp_path), flat_index, seq=1, wal_seq=0)
    snaps = tmp_path / "snapshots"
    (snaps / ".tmp-snapshot-0000000099").mkdir()
    orphan = snaps / "snapshot-0000000002"     # a crash between rename and flip
    orphan.mkdir()
    (orphan / "half-written.bin").write_bytes(b"junk")
    write_snapshot(str(tmp_path), flat_index, seq=2, wal_seq=0)
    assert sorted(os.listdir(snaps)) == ["snapshot-0000000002"]
    assert current_manifest(str(tmp_path))["seq"] == 2
    assert load_current(str(tmp_path), device="cpu") is not None


def test_out_of_core_kind_raises_naming_its_item(jax_indexes, tmp_path):
    # the out-of-core kind and the memory-mapped store were refused until
    # they were ported; both round-trip now and nothing names queue 1 item 5
    ooc = ooc_ivf_flat_from_reference(jooc.ivf_flat_to_ooc(jax_indexes["flat"]), device="cpu")
    write_snapshot(str(tmp_path), ooc, seq=1, wal_seq=0)
    idx, _, _, manifest = load_current(str(tmp_path), mmap_store=True, device="cpu")
    assert manifest["kind"] == "OocIVFFlat" and isinstance(idx.store, np.memmap)
    _assert_index_equal(idx, ooc)


# --------------------------------------------------------------------- #
# the out-of-core kind (OocIVFFlat): a host store chunked per slot
# --------------------------------------------------------------------- #
@pytest.fixture
def ooc_pair(jax_indexes):
    jo = jooc.ivf_flat_to_ooc(jax_indexes["flat"])
    return jo, ooc_ivf_flat_from_reference(jo, device="cpu")


@pytest.mark.parametrize("with_delta", [False, True])
def test_ooc_snapshot_directories_are_byte_identical(ooc_pair, rng, tmp_path, with_delta):
    jo, po = ooc_pair
    delta = _delta(rng) if with_delta else None
    jm = jsnap.write_snapshot(str(tmp_path / "jax"), jo, seq=5, wal_seq=2, delta=delta)
    pm = write_snapshot(str(tmp_path / "port"), po, seq=5, wal_seq=2, delta=delta)
    assert pm == jm
    assert _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    store = [e for e in pm["arrays"] if e["name"] == "store"][0]
    # chunked per slot: a chunk index is a slot id
    assert store["chunk_bytes"] == po.slot_bytes() and len(store["crc32s"]) == po.n_slots


@pytest.mark.parametrize("mmap_store", [False, True])
def test_ooc_snapshots_cross_both_ways(ooc_pair, tmp_path, mmap_store):
    jo, po = ooc_pair
    jsnap.write_snapshot(str(tmp_path / "jax"), jo, seq=1, wal_seq=0)
    idx, _, _, _ = load_current(str(tmp_path / "jax"), mmap_store=mmap_store, device="cpu")
    _assert_index_equal(idx, po)
    assert isinstance(idx.store, np.memmap) == mmap_store
    assert isinstance(idx.slot_centroid, np.ndarray) and idx.store.flags.writeable
    write_snapshot(str(tmp_path / "port"), po, seq=1, wal_seq=0)
    jidx, _, _, _ = jsnap.load_current(str(tmp_path / "port"), mmap_store=mmap_store)
    _assert_index_equal(jidx, po)


def test_mmap_store_is_copy_on_write_and_verified(ooc_pair, tmp_path):
    _, po = ooc_pair
    write_snapshot(str(tmp_path), po, seq=1, wal_seq=0)
    idx, _, _, manifest = load_current(str(tmp_path), mmap_store=True, device="cpu")
    path = os.path.join(manifest["_dir"], "store.bin")
    before = open(path, "rb").read()
    idx.store[0, 0, 0] += 1.0              # a repair changes memory, never the file
    assert open(path, "rb").read() == before
    del idx
    _flip_byte(path, po.slot_bytes() * 3 + 5)
    with pytest.raises(DataCorruptionError, match="store.bin") as ei:
        load_current(str(tmp_path), mmap_store=True, device="cpu")
    assert ei.value.offset == po.slot_bytes() * 3


def _ooc_budget(index):
    """Half the store: three tiles and a hot set of a few slots."""
    return int(index.store_bytes() * 0.5)


def _ooc_svc(index, tmp, **kw):
    return make_svc(index, tmp, ooc=True, device_budget_bytes=_ooc_budget(index), **kw)


def test_ooc_service_restores_with_a_memory_mapped_store(ooc_pair, rng, tmp_path):
    _, po = ooc_pair
    svc = _ooc_svc(po, tmp_path, snapshot_interval_s=1e9)
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    svc.insert(np.arange(7000, 7004), rng.standard_normal((4, DIM)).astype(np.float32))
    want = _state_search(svc, q)
    svc.close(snapshot=False)
    back = make_svc(None, tmp_path, ooc=True, device_budget_bytes=_ooc_budget(po),
                    persist_mmap=True, snapshot_interval_s=1e9)
    try:
        assert isinstance(back.index.store, np.memmap) and back.stats()["kind"] == "OocIVFFlat"
        assert back.delta_rows == 4
        got = _state_search(back, q)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    finally:
        back.close(snapshot=False)
    with pytest.raises(LogicError, match="persist_mmap"):
        make_svc(po, None, ooc=True, device_budget_bytes=_ooc_budget(po), persist_mmap=True)


def test_scrub_quarantines_and_rebuilds_a_host_store_slot(ooc_pair, rng, tmp_path):
    _, po = ooc_pair
    svc = _ooc_svc(po, tmp_path, scrub_chunks=10_000)
    try:
        store = svc._ooc.store
        assert store.flags.writeable
        q = rng.standard_normal((6, DIM)).astype(np.float32)
        want = _state_search(svc, q)
        slot = svc._ooc.n_slots - 1           # a cold slot (the hot set is the largest lists)
        clean = store[slot].copy()
        store[slot, 0, 0] += 1000.0           # a poisoned host-memory slot
        svc.worker.run_maintenance()
        ps = svc.stats()["persist"]
        assert ps["last_scrub"]["rebuilt"] == 1 and not ps["corruption_detected"]
        assert ps["last_scrub"]["last_error"]["where"] == "host-store-slot"
        assert ps["last_scrub"]["last_error"]["repaired"] is True
        np.testing.assert_array_equal(store[slot], clean)
        got = _state_search(svc, q)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        # the snapshot's copy bad as well: reported, not repaired
        name = "snapshot-%010d" % svc._persist.snapshot_seq
        _flip_byte(os.path.join(str(tmp_path), "snapshots", name, "store.bin"),
                   po.slot_bytes() * slot + 9)
        store[slot, 0, 1] += 1000.0
        svc.worker.run_maintenance()
        assert svc.stats()["persist"]["corruption_detected"]
        assert svc.stats()["persist"]["last_scrub"]["rebuilt"] == 1
    finally:
        svc.close(snapshot=False)


# --------------------------------------------------------------------- #
# the write-ahead log across the two packages
# --------------------------------------------------------------------- #
def _appends(rng):
    return [(np.arange(3, dtype=np.int32), rng.standard_normal((3, DIM)).astype(np.float32)),
            (np.arange(3, 5, dtype=np.int32), rng.standard_normal((2, DIM)).astype(np.float32))]


def test_wal_files_are_byte_identical_and_replay_across(rng, tmp_path):
    recs = _appends(rng)
    paths = {"port": str(tmp_path / "p.log"), "jax": str(tmp_path / "j.log")}
    for name, cls in (("port", WriteAheadLog), ("jax", JaxWriteAheadLog)):
        w = cls(paths[name], DIM, np.float32, fsync="always")
        assert [w.append(ids, v) for ids, v in recs] == [1, 2]
        w.close()
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    for replay, path in ((replay_wal, paths["jax"]), (jax_replay_wal, paths["port"])):
        got, info = replay(path)
        assert [s for s, _, _ in got] == [1, 2] and not info["torn"]
        for (_, ids, v), (ids0, v0) in zip(got, recs):
            np.testing.assert_array_equal(ids, ids0)
            np.testing.assert_array_equal(v, v0)


def test_wal_min_seq_and_truncate_through(rng, tmp_path):
    wp = str(tmp_path / "wal.log")
    w = WriteAheadLog(wp, 8, np.float32, fsync="always")
    for i in range(4):
        w.append(np.arange(2 * i, 2 * i + 2), rng.standard_normal((2, 8)).astype(np.float32))
    recs, info = replay_wal(wp, min_seq=1)
    assert [s for s, _, _ in recs] == [2, 3, 4] and info["last_seq"] == 4
    assert w.truncate_through(2) == 2
    w.close()
    assert [s for s, _, _ in replay_wal(wp)[0]] == [3, 4]


def test_wal_torn_tail_tolerated(rng, tmp_path):
    wp = str(tmp_path / "wal.log")
    w = WriteAheadLog(wp, 8, np.float32, fsync="always")
    for i in range(2):
        w.append(np.arange(2 * i, 2 * i + 2), rng.standard_normal((2, 8)).astype(np.float32))
    w.close()
    os.truncate(wp, os.path.getsize(wp) - 5)
    recs, info = replay_wal(wp)
    assert info["torn"] and [s for s, _, _ in recs] == [1]
    os.truncate(wp, info["valid_end"])
    w2 = WriteAheadLog(wp, 8, np.float32, fsync="always", start_seq=info["last_seq"])
    assert w2.append(np.arange(4, 6), rng.standard_normal((2, 8)).astype(np.float32)) == 2
    w2.close()
    recs, info = replay_wal(wp)
    assert [s for s, _, _ in recs] == [1, 2] and not info["torn"]


@pytest.mark.parametrize("where", ["payload", "magic", "rows"])
def test_wal_interior_corruption_raises(rng, tmp_path, where):
    wp = str(tmp_path / "wal.log")
    w = WriteAheadLog(wp, 8, np.float32, fsync="always")
    start = w.tell()
    w.append(np.arange(2), rng.standard_normal((2, 8)).astype(np.float32))
    end_first = w.tell()
    w.append(np.arange(2, 4), rng.standard_normal((2, 8)).astype(np.float32))
    w.close()
    _flip_byte(wp, {"payload": end_first - 3, "magic": start, "rows": start + 12}[where])
    with pytest.raises(DataCorruptionError) as e:
        replay_wal(wp)
    assert e.value.path == wp and e.value.offset is not None
    if where == "magic":
        assert "magic" in str(e.value)


def test_wal_bad_fsync_policy(tmp_path):
    assert FSYNC_POLICIES == ("always", "batch", "off")
    with pytest.raises(LogicError):
        WriteAheadLog(str(tmp_path / "w.log"), 8, np.float32, fsync="sometimes")


# --------------------------------------------------------------------- #
# snapshot corruption
# --------------------------------------------------------------------- #
def test_manifest_bitflip(flat_index, tmp_path):
    write_snapshot(str(tmp_path), flat_index, seq=1, wal_seq=0)
    _flip_byte(str(tmp_path / "snapshots" / "snapshot-0000000001" / "MANIFEST.json"), 40)
    with pytest.raises(DataCorruptionError, match="MANIFEST.json"):
        load_current(str(tmp_path), device="cpu")


@pytest.mark.parametrize("array", ["slot_vecs", "slot_ids", "centroids"])
def test_array_payload_bitflip_names_file_and_offset(flat_index, tmp_path, array):
    write_snapshot(str(tmp_path), flat_index, seq=1, wal_seq=0, chunk_bytes=256)
    path = tmp_path / "snapshots" / "snapshot-0000000001" / (array + ".bin")
    _flip_byte(str(path), 300)
    with pytest.raises(DataCorruptionError) as e:
        load_current(str(tmp_path), device="cpu")
    err = e.value
    assert err.path.endswith(array + ".bin") and err.offset == 256    # the chunk's offset
    assert err.expected_crc is not None and err.expected_crc != err.actual_crc


def test_short_array_file_raises(flat_index, tmp_path):
    write_snapshot(str(tmp_path), flat_index, seq=1, wal_seq=0)
    path = str(tmp_path / "snapshots" / "snapshot-0000000001" / "list_sizes.bin")
    os.truncate(path, os.path.getsize(path) - 4)
    with pytest.raises(DataCorruptionError):
        load_current(str(tmp_path), device="cpu")


def test_current_pointer_garbage_and_version_mismatch(flat_index, tmp_path):
    import json
    import zlib

    write_snapshot(str(tmp_path), flat_index, seq=1, wal_seq=0)
    (tmp_path / "CURRENT").write_text("what even is this\n")
    with pytest.raises(DataCorruptionError):
        load_current(str(tmp_path), device="cpu")
    mpath = tmp_path / "snapshots" / "snapshot-0000000001" / "MANIFEST.json"
    doc = json.loads(mpath.read_bytes())
    doc["version"] = 999
    raw = json.dumps(doc).encode()
    mpath.write_bytes(raw)
    (tmp_path / "CURRENT").write_text("snapshot-0000000001 %d\n" % (zlib.crc32(raw) & 0xFFFFFFFF))
    with pytest.raises(DataCorruptionError, match="version"):
        load_current(str(tmp_path), device="cpu")


# --------------------------------------------------------------------- #
# ANNService(persist_dir=...)
# --------------------------------------------------------------------- #
def make_svc(index, tmp=None, clock=None, **kw):
    kw.setdefault("max_batch_rows", 32)
    kw.setdefault("bucket_rungs", (8, 32))
    kw.setdefault("max_wait_ms", 1.0)
    kw.setdefault("nprobe_ladder", (4, 8))
    kw.setdefault("delta_cap", 64)
    kw.setdefault("compact_rows", 0)
    if tmp is not None:
        kw.setdefault("persist_dir", str(tmp))
    if clock is not None:
        kw["clock"] = clock
    return ANNService(index, 5, start=False, device="cpu", **kw)


def _state_search(svc, q, nprobe=4):
    st = svc._ann_state
    delta = (st.delta_vecs, st.delta_ids) if st.delta_rows else None
    return svc._snapshot_search(st, torch.from_numpy(q), nprobe, delta)


def test_insert_journaled_before_ack(flat_index, rng, tmp_path):
    svc = make_svc(flat_index, tmp_path)
    assert svc.stats()["persist"]["snapshot_seq"] == 1           # the bootstrap snapshot
    svc.insert(np.arange(1000, 1004), rng.standard_normal((4, DIM)).astype(np.float32))
    ps = svc.stats()["persist"]
    assert ps["wal_records"] == 1 and ps["wal_seq"] == 1 and svc._ann_state.wal_seq == 1
    svc.close()


def test_wal_failure_fails_insert_without_state_change(flat_index, rng, tmp_path):
    svc = make_svc(flat_index, tmp_path)

    def boom(ids, vecs):
        raise OSError("disk gone")

    svc._persist.wal_append = boom
    with pytest.raises(OSError):
        svc.insert(np.arange(1000, 1004), rng.standard_normal((4, DIM)).astype(np.float32))
    assert svc.delta_rows == 0 and svc._delta_count == 0
    svc.close(snapshot=False)


def test_interval_snapshot_truncates_wal(flat_index, rng, tmp_path):
    clock = FakeClock()
    svc = make_svc(flat_index, tmp_path, clock=clock, snapshot_interval_s=10.0)
    svc.insert(np.arange(1000, 1008), rng.standard_normal((8, DIM)).astype(np.float32))
    svc.worker.run_maintenance()
    ps = svc.stats()["persist"]
    assert ps["snapshot_seq"] == 1 and ps["wal_records"] == 1 and ps["dirty"]
    clock.advance(11.0)
    svc.worker.run_maintenance()
    ps = svc.stats()["persist"]
    assert ps["snapshot_seq"] == 2 and ps["wal_records"] == 0 and not ps["dirty"]
    assert current_manifest(str(tmp_path))["delta_rows"] == 8
    svc.close(snapshot=False)


@pytest.mark.parametrize("kind", ["flat", "pq", "sq"])
def test_crash_restart_bitwise_and_no_loss(port_indexes, rng, tmp_path, kind):
    svc = make_svc(port_indexes[kind], tmp_path, snapshot_interval_s=1e9)
    first, second = np.arange(2000, 2012), np.arange(3000, 3006)
    v1 = rng.standard_normal((12, DIM)).astype(np.float32)
    v2 = rng.standard_normal((6, DIM)).astype(np.float32)
    svc.insert(first, v1)
    svc._persist.snapshot(svc._ann_state)       # the snapshot holds the first rows
    svc.insert(second, v2)                      # the WAL alone holds these
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    ref = _state_search(svc, q)
    svc.close(snapshot=False)                   # a crash: no last snapshot
    again = make_svc(None, tmp_path)
    ps = again.stats()["persist"]
    assert ps["replayed_records"] == 1 and again.delta_rows == 18
    assert type(again.index) is type(port_indexes[kind])
    got = _state_search(again, q)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    # every acknowledged insert answers a query of itself
    allv, allid = np.concatenate([v1, v2]), np.concatenate([first, second])
    for row in range(len(allv)):
        d, i = _state_search(again, allv[row:row + 1])
        assert int(i[0, 0]) == allid[row] and float(d[0, 0]) <= 1e-4
    again.close()


def test_clean_close_leaves_empty_wal(flat_index, rng, tmp_path):
    svc = make_svc(flat_index, tmp_path)
    svc.insert(np.arange(4000, 4006), rng.standard_normal((6, DIM)).astype(np.float32))
    svc.close()
    again = make_svc(None, tmp_path)
    ps = again.stats()["persist"]
    assert ps["replayed_records"] == 0 and ps["wal_records"] == 0 and again.delta_rows == 6
    again.close()


def test_restore_overflow_folds_into_a_flat_index(flat_index, rng, tmp_path):
    svc = make_svc(flat_index, tmp_path, delta_cap=32, snapshot_interval_s=1e9)
    ids_a = np.arange(5000, 5032)
    svc.insert(ids_a, rng.standard_normal((32, DIM)).astype(np.float32))
    svc.compact()                               # the WAL keeps the record
    ids_b = np.arange(6000, 6020)
    svc.insert(ids_b, rng.standard_normal((20, DIM)).astype(np.float32))
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    ref = _state_search(svc, q)
    svc.close(snapshot=False)
    again = make_svc(None, tmp_path, delta_cap=32)
    assert again.stats()["persist"]["replayed_records"] == 2 and again.delta_rows == 20
    got = _state_search(again, q)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    _, gt_ids = again.ground_truth_store()
    assert set(ids_a.tolist()) | set(ids_b.tolist()) <= set(gt_ids.tolist())
    again.close()


def test_restore_overflow_of_a_pq_index_raises(port_indexes, rng, tmp_path):
    svc = make_svc(port_indexes["pq"], tmp_path, delta_cap=16, snapshot_interval_s=1e9)
    svc.insert(np.arange(10), rng.standard_normal((10, DIM)).astype(np.float32))
    svc.close(snapshot=False)
    with pytest.raises(LogicError, match="PQ/SQ"):
        make_svc(None, tmp_path, delta_cap=8)


def test_construction_errors(flat_index, rng, tmp_path):
    with pytest.raises(LogicError, match="persist_dir"):
        make_svc(flat_index, None, persist_fsync="always")
    with pytest.raises(LogicError):
        make_svc(flat_index, tmp_path / "a", persist_fsync="sometimes")
    with pytest.raises(LogicError, match="index=None"):
        make_svc(None, tmp_path / "b")
    svc = make_svc(flat_index, tmp_path / "c", delta_cap=64)
    svc.insert(np.arange(7000, 7040), rng.standard_normal((40, DIM)).astype(np.float32))
    svc.close()
    with pytest.raises(LogicError, match="delta_cap"):
        make_svc(None, tmp_path / "c", delta_cap=16)
    other = IVFFlatIndex(*[t[:, :8] if name == "centroids" else t
                           for name, t in zip(IVFFlatIndex._fields, flat_index)])
    with pytest.raises(LogicError, match="dim"):
        make_svc(other, tmp_path / "c")


def test_scrub_detects_a_corrupt_snapshot_chunk(flat_index, tmp_path):
    svc = make_svc(flat_index, tmp_path, scrub_chunks=10_000)
    name = "snapshot-%010d" % svc._persist.snapshot_seq
    _flip_byte(os.path.join(str(tmp_path), "snapshots", name, "slot_vecs.bin"), 10)
    svc.worker.run_maintenance()
    ps = svc.stats()["persist"]
    assert ps["corruption_detected"]
    assert ps["last_scrub"]["last_error"]["where"] == "snapshot-file"
    svc.close(snapshot=False)
    quiet = make_svc(flat_index, tmp_path / "q", scrub_chunks=0)
    quiet.worker.run_maintenance()
    assert quiet.stats()["persist"]["last_scrub"]["checked"] == 0
    quiet.close(snapshot=False)


def test_restore_of_a_corrupt_snapshot_raises(flat_index, tmp_path):
    svc = make_svc(flat_index, tmp_path)
    svc.close()
    name = "snapshot-%010d" % current_manifest(str(tmp_path))["seq"]
    _flip_byte(os.path.join(str(tmp_path), "snapshots", name, "slot_ids.bin"), 5)
    with pytest.raises(DataCorruptionError, match="slot_ids.bin"):
        make_svc(None, tmp_path)


def test_restore_depth_skips_snapshot_covered_records(flat_index, rng, tmp_path):
    w = WriteAheadLog(str(tmp_path / "wal.log"), DIM, np.float32, fsync="always")
    for i in range(3):
        w.append(np.arange(2 * i, 2 * i + 2), rng.standard_normal((2, DIM)).astype(np.float32))
    w.close()
    write_snapshot(str(tmp_path), flat_index, seq=1, wal_seq=2)
    mgr = PersistManager(str(tmp_path), service="t", fsync="always", snapshot_interval_s=30.0,
                         scrub_chunks=0, device="cpu")
    restored = mgr.restore()
    assert len(restored.wal_records) == 1
    assert mgr.stats()["replayed_records"] == 1 and mgr.stats()["wal_records"] == 1
    mgr.close()


@pytest.mark.parametrize("kind", ["flat", "pq", "sq"])
def test_a_jax_service_directory_restores_in_the_port(jax_indexes, rng, tmp_path, kind):
    kw = dict(max_batch_rows=32, bucket_rungs=(8, 32), nprobe_ladder=(4, 8), delta_cap=64,
              compact_rows=0, snapshot_interval_s=1e9)
    theirs = JaxANNService(jax_indexes[kind], k=5, start=False, persist_dir=str(tmp_path), **kw)
    ids = np.arange(8000, 8010)
    vecs = rng.standard_normal((10, DIM)).astype(np.float32)
    theirs.insert(ids[:6], jnp.asarray(vecs[:6]))
    theirs._persist.snapshot(theirs._ann_state)
    theirs.insert(ids[6:], jnp.asarray(vecs[6:]))
    theirs.close(snapshot=False)
    ours = make_svc(None, tmp_path, snapshot_interval_s=1e9)
    assert ours.stats()["persist"]["replayed_records"] == 1 and ours.delta_rows == 10
    _assert_index_equal(ours.index, jax_indexes[kind])
    for row in range(10):
        d, i = _state_search(ours, vecs[row:row + 1])
        assert int(i[0, 0]) == ids[row] and float(d[0, 0]) <= 1e-4
    # and back: the port's next snapshot restores in the JAX service
    ours.insert([8100], vecs[:1] + 1.0)
    ours.close()
    back = JaxANNService(None, k=5, start=False, persist_dir=str(tmp_path), **kw)
    assert back.delta_rows == 11 and back.stats()["persist"]["replayed_records"] == 0
    back.close(snapshot=False)


@pytest.mark.parametrize("name", ["persist_fsync", "persist_snapshot_interval_s",
                                  "persist_scrub_chunks"])
def test_persist_knobs_resolve_like_jax(monkeypatch, name):
    from raft_tpu import config as jax_config
    from raft_tpu_torch import config

    assert config.knob_default(name) == jax_config.knob_default(name)
    monkeypatch.setenv("RAFT_TPU_" + name.upper(), "7")
    assert config.get(name) == jax_config.get(name) == "7"
