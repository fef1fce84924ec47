"""Port parity: memory resources (``raft_tpu_torch/mr``) against the JAX
package's ``raft_tpu/mr``, on ``device="cpu"``.

The cases of the JAX ``tests/test_mr.py`` for ``DeviceBuffer``,
``HostBuffer``, ``PoolAllocator``, ``ZerosPool`` and ``TilePool``, and the
memory-accounting cases of ``tests/test_metrics_profiler.py``: the
pools' reuse, bounds and eviction order decided alike by both packages on
the same call sequence; a staged tile holding the same bytes as the JAX
pool's; the budget's bounded wait and ``AllocationError``; ``discard``
and a failed stage giving the budget back; concurrent staging under the
budget (the staged-bytes gauge's high water); the h2d and stall metrics.
Counters are read per pool (``pool=`` label), never process-wide."""

import gc
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import mr as jmr
from raft_tpu_torch.core import metrics
from raft_tpu_torch.core.error import AllocationError, RaftError
from raft_tpu_torch.mr import (DeviceBuffer, HostBuffer, PoolAllocator, TilePool, ZerosPool,
                               default_zeros_pool, device_memory_stats, zeros_cached)
from raft_tpu_torch.mr import buffer as mr_buffer

CPU = "cpu"


def _live(space):
    return metrics.default_registry().gauge("raft_tpu_mr_live_bytes",
                                            labels=("space",)).labels(space=space)


def _pool_series(name, pool):
    fam = metrics.default_registry().get(name)
    assert fam is not None, name
    for labels, series in fam.series():
        if labels.get("pool") == pool:
            return series
    raise AssertionError("no %s series for pool %s" % (name, pool))


def _store(n_slots=16, cap=4, dim=3):
    return np.random.default_rng(7).standard_normal((n_slots, cap, dim)).astype(np.float32)


# --------------------------------------------------------------------- #
# buffers
# --------------------------------------------------------------------- #
def test_device_buffer_alloc_use_free():
    jbuf = jmr.DeviceBuffer((128, 64), jnp.float32)
    buf = DeviceBuffer((128, 64), torch.float32, device=CPU)
    assert tuple(buf.data.shape) == tuple(jbuf.data.shape) == (128, 64)
    assert buf.size_bytes() == jbuf.size_bytes() == 128 * 64 * 4
    assert not buf.deallocated and float(buf.data.abs().sum()) == 0.0
    buf.deallocate()
    assert buf.deallocated
    with pytest.raises(RaftError, match="use after deallocate"):
        _ = buf.data
    buf.deallocate()  # idempotent
    jbuf.deallocate()


def test_device_buffer_from_array_and_context():
    x = torch.arange(16.0)
    buf = DeviceBuffer.from_array(x)
    assert float(buf.data[3]) == 3.0 and buf.device.type == "cpu"
    buf.deallocate()
    # dropping the buffer's reference leaves the caller's tensor alive
    assert float(x[3]) == 3.0
    with DeviceBuffer((8,), np.int32, device=CPU) as b:
        assert b.data.dtype == torch.int32
    assert b.deallocated


def test_host_buffer_alloc_use_free():
    buf = HostBuffer((4, 4), np.float64)
    buf.data[1, 2] = 7.0
    assert buf.data[1, 2] == 7.0 and buf.data.device.type == "cpu"
    assert buf.size_bytes() == jmr.HostBuffer((4, 4), jnp.float64).size_bytes()
    buf.deallocate()
    assert buf.deallocated
    adopted = HostBuffer.from_array(np.ones(3, np.float32))
    assert adopted.data.dtype == torch.float32 and float(adopted.data.sum()) == 3.0


def test_live_gauge_tracks_alloc_free_and_peak():
    g, h = _live("device"), _live("host")
    before, hbefore = g.value, h.value
    buf = DeviceBuffer((64, 64), torch.float32, device=CPU)
    assert g.value == before + 64 * 64 * 4 and g.high_water >= before + 64 * 64 * 4
    peak = g.high_water
    buf.deallocate()
    buf.deallocate()  # no double-free accounting
    assert g.value == before and g.high_water == peak
    hb = HostBuffer((32, 32), torch.float32)
    assert h.value == hbefore + 32 * 32 * 4
    hb.deallocate()
    assert h.value == hbefore


def test_gc_reclaims_accounting_and_keeps_adopted_tensor():
    g = _live("device")
    before = g.value
    bufs = [DeviceBuffer((32, 32), torch.float32, device=CPU) for _ in range(3)]
    assert g.value == before + 3 * 32 * 32 * 4
    del bufs
    gc.collect()
    assert g.value == before
    x = torch.ones(8, 8)
    buf = DeviceBuffer.from_array(x)
    del buf
    gc.collect()
    assert float(x.sum()) == 64.0


def test_accounting_balances_across_disable():
    g = _live("device")
    before = g.value
    buf = DeviceBuffer((64, 64), torch.float32, device=CPU)
    metrics.set_enabled(False)
    try:
        buf.deallocate()  # the paired free applies despite the gate
        assert g.value == before
        buf2 = DeviceBuffer((32, 32), torch.float32, device=CPU)  # not recorded
    finally:
        metrics.set_enabled(True)
    buf2.deallocate()  # no free of an alloc that was never recorded
    assert g.value == before


def test_allocation_error_carries_context(monkeypatch):
    def explode(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(mr_buffer.torch, "zeros", explode)
    before = _live("device").value
    with pytest.raises(AllocationError) as ei:
        DeviceBuffer((128, 128), torch.float32, device=CPU)
    err = ei.value
    assert err.requested_bytes == 128 * 128 * 4 and err.live_bytes >= 0
    assert "128" in str(err) and "live" in str(err)
    assert _live("device").value == before


def test_memory_stats_on_the_cpu():
    assert device_memory_stats(CPU) == {}
    if not torch.cuda.is_available():
        with pytest.raises(RaftError, match="CUDA"):
            device_memory_stats()


# --------------------------------------------------------------------- #
# pool allocator: both packages decide alike on one call sequence
# --------------------------------------------------------------------- #
def _run_pool(pool, dtypes, script):
    """Replay ``script`` (("alloc", name, shape, dtype) / ("free", name))
    on a pool; returns the buffers and the (hits, misses, evictions,
    pooled bytes, deallocated names) trail after each step."""
    bufs, trail = {}, []
    for op in script:
        if op[0] == "alloc":
            bufs[op[1]] = pool.allocate(op[2], dtypes[op[3]])
        else:
            pool.deallocate(bufs[op[1]])
        trail.append((pool.n_hits, pool.n_misses, getattr(pool, "n_evictions", 0),
                      pool.pooled_bytes(),
                      tuple(sorted(n for n, b in bufs.items() if b.deallocated))))
    return bufs, trail


SCRIPTS = {
    "reuse": (dict(), [("alloc", "a", (256, 32), "f"), ("free", "a"),
                       ("alloc", "b", (256, 32), "f"), ("alloc", "c", (256, 32), "f")]),
    "key_isolation": (dict(), [("alloc", "a", (16,), "f"), ("free", "a"),
                               ("alloc", "b", (16,), "i")]),
    "per_key_cap": (dict(max_pooled_per_key=1), [("alloc", "a", (8,), "f"),
                                                 ("alloc", "b", (8,), "f"), ("free", "a"),
                                                 ("free", "b")]),
    "byte_budget": (dict(max_pooled_per_key=8, max_bytes=64),
                    [("alloc", n, (4,), "f") for n in "abcdef"]
                    + [("free", n) for n in "abcdef"]),
    "eviction_order": (dict(max_pooled_per_key=8, max_bytes=40),
                       [("alloc", "a", (4,), "f"), ("alloc", "b", (2,), "f"),
                        ("alloc", "c", (4,), "f"), ("free", "a"), ("free", "b"), ("free", "c"),
                        ("alloc", "d", (2, 2), "f"), ("free", "d"), ("alloc", "f", (8,), "f"),
                        ("free", "f")]),
    "reuse_leaves_order": (dict(max_bytes=64), [("alloc", "a", (4,), "f"), ("free", "a"),
                                                ("alloc", "b", (4,), "f")]),
    "oversize": (dict(max_bytes=8), [("alloc", "a", (4,), "f"), ("free", "a")]),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_pool_allocator_decides_like_jax(case):
    kw, script = SCRIPTS[case]
    jbufs, jtrail = _run_pool(jmr.PoolAllocator(**kw), {"f": jnp.float32, "i": jnp.int32},
                              script)
    pbufs, ptrail = _run_pool(PoolAllocator(device=CPU, **kw),
                              {"f": torch.float32, "i": torch.int32}, script)
    assert ptrail == jtrail
    # a freelist hit returns the very buffer that was pooled
    for name, buf in pbufs.items():
        for other, obuf in pbufs.items():
            assert (buf is obuf) == (jbufs[name] is jbufs[other])


def test_pool_allocator_release_and_dead_buffer():
    pool = PoolAllocator(device=CPU, max_bytes=1024)
    a = pool.allocate((4,))
    pool.deallocate(a)
    pool.release()
    assert a.deallocated and pool.pooled_bytes() == 0
    pool.deallocate(pool.allocate((4,)))   # usable after release
    assert pool.pooled_bytes() == 16
    dead = pool.allocate((8,))
    dead.deallocate()
    with pytest.raises(RaftError):
        pool.deallocate(dead)


# --------------------------------------------------------------------- #
# zeros pool
# --------------------------------------------------------------------- #
def test_zeros_pool_shared_block_and_keys():
    pool = ZerosPool(device=CPU)
    a = pool.get((4, 3), torch.float32)
    assert pool.get((4, 3), np.float32) is a
    assert pool.n_hits == 1 and pool.n_misses == 1 and float(a.sum()) == 0.0
    assert pool.get((4, 3), torch.int32) is not a
    assert pool.get((5, 3), torch.float32) is not a
    assert pool.n_misses == 3


def test_zeros_pool_lru_and_byte_bounds_like_jax():
    for kw, shapes in ((dict(max_entries=2), [(1,), (2,), (1,), (3,), (1,), (2,)]),
                       (dict(max_entries=64, max_bytes=4096),
                        [(2048,)] + [(256, i) for i in range(1, 9)])):
        jpool, pool = jmr.ZerosPool(**kw), ZerosPool(device=CPU, **kw)
        for shape in shapes:
            jpool.get(shape)
            pool.get(shape)
            assert (len(pool), pool.pooled_bytes(), pool.n_hits, pool.n_misses) == (
                len(jpool), jpool.pooled_bytes(), jpool.n_hits, jpool.n_misses)
    big = ZerosPool(device=CPU, max_bytes=4096).get((2048,))
    assert float(big.sum()) == 0.0          # oversize: returned, never cached


def test_zeros_pool_release_and_freed_block_replaced():
    pool = ZerosPool(device=CPU)
    blk = pool.get((16,), torch.float32)
    assert pool.pooled_bytes() == 64
    pool.release()
    assert len(pool) == 0 and pool.pooled_bytes() == 0 and float(blk.sum()) == 0.0
    a = pool.get((5,))
    a.untyped_storage().resize_(0)          # a consumer freed the storage
    b = pool.get((5,))
    assert b is not a and b.numel() == 5 and float(b.sum()) == 0.0


def test_zeros_cached_reads_the_default_pool():
    blk = zeros_cached((7, 2), torch.int32, device=CPU)
    assert zeros_cached((7, 2), torch.int32, device=CPU) is blk
    assert default_zeros_pool().get((7, 2), torch.int32, CPU) is blk
    assert blk.dtype == torch.int32 and tuple(blk.shape) == (7, 2)
    out = torch.cat([torch.ones(2, 2, dtype=torch.int32), blk[:3]])
    assert out.data_ptr() != blk.data_ptr() and int(blk.sum()) == 0


# --------------------------------------------------------------------- #
# TilePool
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("ids", [[3, 1, 5], [0], [15, 14, 13, 12], []])
def test_stage_take_round_trip_like_jax(ids):
    store = _store()
    jpool = jmr.TilePool(4, 1 << 20, name="tp-rt-jax")
    pool = TilePool(4, 1 << 20, name="tp-rt", device=CPU)
    jv, ji = jpool.take(jpool.stage(store, np.array(ids, np.int64)))
    tile = pool.stage(store, np.array(ids, np.int64))
    assert pool.staged_bytes() == tile.nbytes == pool.tile_bytes(store) == 4 * (4 * 3 * 4 + 4)
    vecs, tids = pool.take(tile)
    assert tuple(vecs.shape) == (4, 4, 3)           # padded to tile_slots
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vecs.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(vecs.numpy()[:len(ids)], store[ids])
    assert pool.staged_bytes() == 0 and pool.n_staged == 1 and pool.n_taken == 1


def test_double_take_rejected():
    pool = TilePool(2, 1 << 20, name="tp-dt", device=CPU)
    tile = pool.stage(_store(), np.array([0]))
    pool.take(tile)
    with pytest.raises(RaftError, match="already taken"):
        pool.take(tile)


def test_budget_must_hold_two_tiles():
    with pytest.raises(RaftError, match="double-buffer"):
        TilePool(8, 64, name="tp-tiny", device=CPU).stage(_store(), np.array([0]))
    with pytest.raises(RaftError, match="exceed tile_slots"):
        TilePool(2, 1 << 20, name="tp-many", device=CPU).stage(_store(), np.arange(3))


def test_overstage_from_one_thread_fails_after_a_bounded_wait():
    store = _store()
    tile_b = 4 * (store.shape[1] * store.shape[2] * 4 + 4)
    pool = TilePool(4, 2 * tile_b, name="tp-over", device=CPU, stage_wait_s=0.2)
    a = pool.stage(store, np.array([0]))
    b = pool.stage(store, np.array([1]))
    with pytest.raises(AllocationError) as ei:
        pool.stage(store, np.array([2]))
    assert ei.value.requested_bytes == tile_b and ei.value.live_bytes == 2 * tile_b
    assert pool.staged_bytes() == 2 * tile_b   # the refused stage took no charge
    pool.take(a)
    pool.take(b)
    assert pool.staged_bytes() == 0


def test_a_waiting_stage_proceeds_when_a_take_frees_room():
    store = _store()
    tile_b = 4 * (store.shape[1] * store.shape[2] * 4 + 4)
    pool = TilePool(4, 2 * tile_b, name="tp-wait", device=CPU, stage_wait_s=10.0)
    a, b = pool.stage(store, np.array([0])), pool.stage(store, np.array([1]))
    got = []
    th = threading.Thread(target=lambda: got.append(pool.stage(store, np.array([2]))))
    th.start()
    th.join(0.2)
    assert th.is_alive()                  # blocked on the full budget
    pool.take(a)
    th.join(10)
    assert not th.is_alive() and len(got) == 1
    pool.take(b)
    pool.take(got[0])
    assert pool.staged_bytes() == 0


def test_discard_and_a_failed_stage_release_the_budget(monkeypatch):
    store = _store()
    pool = TilePool(2, 1 << 20, name="tp-disc", device=CPU)
    tile = pool.stage(store, np.array([0]))
    assert pool.staged_bytes() > 0
    pool.discard(tile)
    assert pool.staged_bytes() == 0
    pool.discard(tile)                    # idempotent
    assert pool.staged_bytes() == 0
    with pytest.raises(RaftError, match="already taken"):
        pool.take(tile)

    def explode(*a, **k):
        raise RuntimeError("gather failed")

    monkeypatch.setattr(sys.modules[TilePool.__module__].torch, "index_select", explode)
    with pytest.raises(RuntimeError, match="gather failed"):
        pool.stage(store, np.array([1]))
    assert pool.staged_bytes() == 0


def test_budget_holds_under_concurrent_staging():
    store = _store(n_slots=64)
    pool = TilePool(4, 3 * (4 * (store.shape[1] * store.shape[2] * 4 + 4)), name="tp-conc",
                    device=CPU, stage_wait_s=10.0)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(25):
                ids = rng.integers(0, 64, 3)
                vecs, tids = pool.take(pool.stage(store, ids))
                np.testing.assert_array_equal(vecs.numpy()[:3], store[ids])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert pool.staged_bytes() == 0 and pool.n_staged == pool.n_taken == 200
    gauge = _pool_series("raft_tpu_tile_staged_bytes", "tp-conc")
    assert 0 < gauge.high_water <= pool.budget_bytes


def test_h2d_bytes_and_stall_accounting():
    store = _store()
    pool = TilePool(2, 1 << 20, name="tp-met", device=CPU)
    pool.take(pool.stage(store, np.array([0, 1])))
    assert _pool_series("raft_tpu_h2d_bytes_total", "tp-met").value == pool.tile_bytes(store)
    assert _pool_series("raft_tpu_h2d_seconds", "tp-met").count == 1
    # hidden=False charges the stage's host time to the stall timer; a
    # hidden stage taken while compute was busy charges nothing
    pool.take(pool.stage(store, np.array([0]), hidden=False))
    stall = _pool_series("raft_tpu_h2d_stall_seconds", "tp-met")
    total = stall.total
    assert total > 0.0
    pool.take(pool.stage(store, np.array([1]), hidden=True), busy=True)
    assert stall.total == total


def test_prefetch_span_on_the_default_profiler():
    from raft_tpu_torch.core import default_profiler

    before = default_profiler().tree().get("ooc.prefetch", {}).get("count", 0)
    pool = TilePool(2, 1 << 20, name="tp-span", device=CPU)
    pool.take(pool.stage(_store(), np.array([0])))
    assert default_profiler().tree()["ooc.prefetch"]["count"] == before + 2
