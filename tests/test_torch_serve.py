"""Port parity of the serving layer (raft_tpu_torch.serve and the modules
it stands on) against the JAX package's serving layer, on the CPU.

Deterministic halves drive a fake clock through the injectable-clock seam
and step the worker by hand (``start=False``, ``worker.run_once()``), as
the JAX package's own serving tests do; the threaded half uses real worker
threads.  Served results are held to the JAX services with a tolerance
and id sets, and bitwise to the port's own call on the same padded batch,
sliced: on the CPU a matmul's rounding may depend on the row count, so a
served row is not promised bitwise equal to a call of other shape.
"""

import contextlib
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_knn_close
from raft_tpu import config as jax_config
from raft_tpu.cache import VecCache as JaxVecCache
from raft_tpu.serve import BucketPolicy as JaxBucketPolicy
from raft_tpu.serve import KNNService as JaxKNNService
from raft_tpu.serve import MicroBatcher as JaxMicroBatcher
from raft_tpu.serve import PairwiseService as JaxPairwiseService
from raft_tpu.serve import resolve_rungs as jax_resolve_rungs
from raft_tpu.distance.distance_type import DistanceType as JD
from raft_tpu_torch import (CommTimeoutError, DistanceType, LogicError, ServiceOverloadError,
                            ServiceUnavailableError, brute_force_knn, config, pairwise_distance)
from raft_tpu_torch.cache import VecCache
from raft_tpu_torch.comms import faults
from raft_tpu_torch.comms.resilience import RetryPolicy
from raft_tpu_torch.core import flight
from raft_tpu_torch.core.metrics import default_registry
from raft_tpu_torch.serve import (BreakerState, BucketPolicy, CircuitBreaker, KNNService,
                                  MicroBatcher, PairwiseService, Service, coalesce,
                                  inject_worker, pad_rows, resolve_rungs, split_rows)

D = DistanceType
DIM = 16
# expanded-form distances from two float32 products: a few ulps of the
# norms (|q|^2 + |x|^2 <= ~100 here)
RTOL, ATOL = 1e-5, 1e-4


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def index(rng):
    return rng.standard_normal((300, DIM)).astype(np.float32)


def _blocks(rng, rows, dim=DIM):
    return [rng.standard_normal((r, dim)).astype(np.float32) for r in rows]


# ---------------------------------------------------------------------- #
# bucketing
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("spec,max_rows", [("pow2", 64), (None, 100), ("pow2", 4),
                                           ("16,4,16", 32), ([32, 8], 32), ("3,5,7", 7)])
def test_rungs_equal_the_jax_ladder(spec, max_rows):
    rungs = resolve_rungs(spec, max_rows)
    assert rungs == jax_resolve_rungs(spec, max_rows)
    ours, theirs = BucketPolicy(rungs), JaxBucketPolicy(rungs)
    for rows in range(1, max_rows + 1):
        assert ours.bucket_for(rows) == theirs.bucket_for(rows)
        assert ours.padding_waste(rows) == theirs.padding_waste(rows)


@pytest.mark.parametrize("spec,max_rows", [([64], 32), ([0, 8], 32), ("8,banana", 32)])
def test_rungs_reject_what_jax_rejects(spec, max_rows):
    with pytest.raises((LogicError, ValueError)):
        resolve_rungs(spec, max_rows)


def test_bucket_policy_rejects_bad_ladders():
    for rungs in ((8, 8), ()):
        with pytest.raises(LogicError):
            BucketPolicy(rungs)
    with pytest.raises(LogicError):
        BucketPolicy((8, 16)).bucket_for(17)


def test_coalesce_pad_split_roundtrip(rng):
    blocks = [torch.from_numpy(b) for b in _blocks(rng, (3, 1, 7), dim=5)]
    batch, spans = coalesce(blocks)
    assert batch.shape == (11, 5) and spans == [(0, 3), (3, 4), (4, 11)]
    padded = pad_rows(batch, 16)
    assert padded.shape == (16, 5) and (padded[11:] == 0).all()
    assert torch.equal(padded[:11], batch)
    for orig, back in zip(blocks, split_rows(padded, spans)):
        assert torch.equal(orig, back)
    assert pad_rows(batch, 11) is batch
    # the cached zeros tail is never written through a padded batch
    padded[11:] = 7.0
    assert (pad_rows(batch, 16)[11:] == 0).all()
    with pytest.raises(LogicError):
        pad_rows(batch, 10)


# ---------------------------------------------------------------------- #
# batcher: the same batches as the JAX batcher under the same clock
# ---------------------------------------------------------------------- #
# a script of ("submit", payload, rows, kwargs) / ("advance", dt) /
# ("take",) steps; each batcher's takes are compared
SCRIPTS = {
    "window_and_rows": [("submit", "a", 2, {}), ("take",), ("advance", 0.011), ("take",),
                        ("submit", "b", 10, {}), ("submit", "c", 6, {}), ("take",),
                        ("submit", "d", 10, {}), ("submit", "e", 10, {}), ("advance", 0.02),
                        ("take",), ("take",)],
    "edf_and_tiers": [("submit", "late", 2, {"deadline_t": 5.0}),
                      ("submit", "soon", 2, {"deadline_t": 1.0}),
                      ("submit", "none", 2, {}), ("submit", "urgent", 2, {"tier": -1}),
                      ("advance", 0.02), ("take",)],
    "tenants_drr": [("submit", "b%d" % i, 4, {"tenant": "bulk"}) for i in range(6)]
                   + [("submit", "i0", 2, {"tenant": "inter"}), ("advance", 0.02),
                      ("take",), ("take",), ("take",)],
}


@pytest.mark.parametrize("script", list(SCRIPTS), ids=list(SCRIPTS))
def test_batcher_forms_the_jax_batches(script):
    def run(cls):
        clock = FakeClock()
        b = cls(max_batch_rows=16, max_wait_s=0.010, queue_cap=64, clock=clock,
                tenant_weights={"bulk": 1.0, "inter": 3.0} if script == "tenants_drr" else None)
        takes = []
        for step in SCRIPTS[script]:
            if step[0] == "submit":
                b.submit(step[1], step[2], **step[3])
            elif step[0] == "advance":
                clock.advance(step[1])
            else:
                got = b.take()
                takes.append(None if got is None else [r.payload for r in got])
        return takes

    ours = run(MicroBatcher)
    assert ours == run(JaxMicroBatcher)
    assert any(ours)


def test_batcher_admission_and_drain():
    clock = FakeClock()
    b = MicroBatcher(max_batch_rows=16, max_wait_s=0.01, queue_cap=4, clock=clock)
    for i in range(4):
        b.submit(i, 1)
    with pytest.raises(ServiceOverloadError) as ei:
        b.submit("over", 1)
    assert (ei.value.queue_depth, ei.value.queue_cap) == (4, 4)
    b.begin_drain()
    assert [r.payload for r in b.take()] == [0, 1, 2, 3]
    with pytest.raises(LogicError):
        b.submit("late", 1)
    assert b.shutdown() == [] and b.wait_for_batch() is None


# ---------------------------------------------------------------------- #
# services against the JAX services
# ---------------------------------------------------------------------- #
def _serve_manual(svc, clock, blocks):
    futs = svc.submit_many(blocks)
    assert not any(f.done() for f in futs)
    clock.advance(0.5)
    assert svc.worker.run_once()
    out = [f.result(timeout=0) for f in futs]
    svc.close()
    return out


@pytest.mark.parametrize("metric", [D.L2Expanded, D.L2SqrtExpanded, D.L1, D.CosineExpanded],
                         ids=lambda m: m.name)
def test_knn_service_matches_jax(index, rng, metric):
    blocks = _blocks(rng, (3, 1, 9))
    clock, jclock = FakeClock(), FakeClock()
    kw = dict(k=5, start=False, max_batch_rows=32, max_wait_ms=10.0)
    got = _serve_manual(KNNService(index, metric=metric, device="cpu", clock=clock, **kw),
                        clock, blocks)
    ref = _serve_manual(JaxKNNService(jnp.asarray(index), metric=JD(int(metric)), clock=jclock,
                                      **kw), jclock, [jnp.asarray(b) for b in blocks])
    for (d, i), (rd, ri) in zip(got, ref):
        assert d.shape == (len(i), 5) and i.dtype == torch.int32
        assert_knn_close(np.asarray(rd), np.asarray(ri), d.numpy(), i.numpy(), RTOL, ATOL)
    # bitwise: the port's own call on the same padded batch (13 rows -> 16), sliced
    padded = pad_rows(torch.from_numpy(np.concatenate(blocks)), 16)
    pd, pi = brute_force_knn(index, padded, 5, metric, device="cpu")
    at = 0
    for (d, i), b in zip(got, blocks):
        assert torch.equal(d, pd[at:at + len(b)]) and torch.equal(i, pi[at:at + len(b)])
        at += len(b)


@pytest.mark.parametrize("metric", [D.L2Expanded, D.L1, D.InnerProduct], ids=lambda m: m.name)
def test_pairwise_service_matches_jax(rng, metric):
    y = rng.standard_normal((40, DIM)).astype(np.float32)
    blocks = _blocks(rng, (2, 5))
    clock, jclock = FakeClock(), FakeClock()
    kw = dict(start=False, max_batch_rows=16, max_wait_ms=10.0)
    got = _serve_manual(PairwiseService(y, metric, device="cpu", clock=clock, **kw),
                        clock, blocks)
    ref = _serve_manual(JaxPairwiseService(jnp.asarray(y), JD(int(metric)), clock=jclock, **kw),
                        jclock, [jnp.asarray(b) for b in blocks])
    padded = pad_rows(torch.from_numpy(np.concatenate(blocks)), 8)
    whole = pairwise_distance(padded, y, metric, device="cpu")
    at = 0
    for out, r, b in zip(got, ref, blocks):
        assert out.shape == (len(b), 40)
        np.testing.assert_allclose(out.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
        assert torch.equal(out, whole[at:at + len(b)])
        at += len(b)


def test_deadline_expires_in_queue(index, rng):
    clock = FakeClock()
    svc = KNNService(index, k=5, device="cpu", start=False, clock=clock,
                     max_batch_rows=32, max_wait_ms=10.0)
    q = _blocks(rng, (2,))[0]
    doomed = svc.submit(q, timeout=0.05)
    alive = svc.submit(q)
    clock.advance(0.1)
    assert svc.worker.run_once()
    with pytest.raises(CommTimeoutError):
        doomed.result(timeout=0)
    assert doomed.trace().terminal() == "expired"
    assert alive.result(timeout=0)[0].shape == (2, 5)
    svc.close()


def test_admission_sheds_with_overload(index, rng):
    svc = KNNService(index, k=5, device="cpu", start=False, max_batch_rows=64,
                     max_wait_ms=1000.0, queue_cap=8, name="torch-shed")
    q = _blocks(rng, (1,))[0]
    for _ in range(8):
        svc.submit(q)
    with pytest.raises(ServiceOverloadError) as ei:
        svc.submit(q)
    assert ei.value.retry_after_s > 0
    svc.close()
    assert default_registry().get("raft_tpu_serve_rejected_total") is not None


def test_payload_validation(index):
    svc = KNNService(index, k=5, device="cpu", start=False, max_batch_rows=32)
    with pytest.raises(LogicError):
        svc.submit(np.zeros((2, 7), np.float32))      # wrong dim
    with pytest.raises(LogicError):
        svc.submit(np.zeros((40, DIM), np.float32))   # > max_batch_rows
    one = svc.submit(np.zeros(DIM, np.float32))       # 1-D promotes to one row
    svc.close()                                       # drains: resolves `one`
    assert one.done() and one.exception() is None
    with pytest.raises(LogicError):
        svc.submit(np.zeros((1, DIM), np.float32))    # closed
    with pytest.raises(LogicError):
        KNNService(index, k=301, device="cpu", start=False)


# ---------------------------------------------------------------------- #
# streams: how a request from any CUDA stream is ordered against the
# worker's stream, driven here with stand-in streams and events
# ---------------------------------------------------------------------- #
class _FakeStream:
    def __init__(self):
        self.waited = []

    def wait_stream(self, other):
        self.waited.append(other)


class _FakeEvent:
    def __init__(self):
        self.recorded_on, self.synced = None, False

    def record(self, stream):
        self.recorded_on = stream

    def synchronize(self):
        self.synced = True


@pytest.fixture
def streams(monkeypatch):
    """(worker, caller, log): stand-ins for the CUDA stream calls, the
    caller's stream current until the test changes ``log["current"]``."""
    worker, caller = _FakeStream(), _FakeStream()
    log = {"current": caller, "entered": [], "events": [], "marked": []}

    @contextlib.contextmanager
    def enter(stream):
        log["entered"].append(stream)
        yield

    def event():
        log["events"].append(_FakeEvent())
        return log["events"][-1]

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: log["current"])
    monkeypatch.setattr(torch.cuda, "stream", enter)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda t, s: log["marked"].append((t, s)), raising=False)
    return worker, caller, log


def _stream_service(rng, worker):
    y = rng.standard_normal((40, DIM)).astype(np.float32)
    svc = PairwiseService(y, D.L1, device="cpu", start=False, max_batch_rows=16)
    svc.worker.stream = worker
    return svc, y


def test_submit_from_another_stream_orders_and_marks_both(rng, streams):
    worker, caller, log = streams
    svc, y = _stream_service(rng, worker)
    x = torch.from_numpy(_blocks(rng, (3,))[0])
    fut = svc.submit(x)
    assert worker.waited == [caller]          # the worker waits for the payload's writes
    (payload, on), = log["marked"]
    assert payload.data_ptr() == x.data_ptr() and on is worker
    svc.close()
    assert log["entered"] == [worker]         # coalesce, pad and launch on the worker's
    (done,) = log["events"]
    assert done.recorded_on is worker and done.synced
    (result, on) = log["marked"][1]
    assert on is caller and result.shape == (8, 40)   # the batch's output, read by the caller
    whole = pairwise_distance(pad_rows(x, 8), y, D.L1, device="cpu")
    assert torch.equal(fut.result(timeout=0), whole[:3])


def test_submit_on_the_worker_stream_needs_no_ordering(rng, streams):
    worker, _, log = streams
    log["current"] = worker
    svc, y = _stream_service(rng, worker)
    fut = svc.submit(_blocks(rng, (5,))[0])
    svc.close()
    assert worker.waited == [] and log["marked"] == []
    assert fut.result(timeout=0).shape == (5, 40)


def test_warmup_runs_on_the_worker_stream(rng, streams):
    worker, _, log = streams
    svc, _ = _stream_service(rng, worker)
    svc.warmup()
    assert log["entered"] == [worker] and svc.warmed_rungs == (8, 16)
    svc.close()


# ---------------------------------------------------------------------- #
# resilience: breaker, fault seam, retry
# ---------------------------------------------------------------------- #
def _echo(clock, name="torch-echo", **kw):
    return Service(name, lambda p: p * 2.0, dim=4, device="cpu", start=False,
                   max_batch_rows=8, max_wait_ms=0.0, clock=clock, **kw)


def test_breaker_trips_sheds_and_recloses():
    clock = FakeClock()
    br = CircuitBreaker("torch-echo", failure_threshold=1, cooldown_s=1.0, clock=clock)
    svc = _echo(clock, breaker=br)
    with inject_worker(svc.worker, faults.FailNth(1)) as log:
        f = svc.submit(torch.ones(2, 4))
        svc.worker.run_once()                 # the first batch fails: trip + requeue
        assert br.state is BreakerState.OPEN and not f.done()
        verb = "serve.torch-echo"
        assert len(log.injected) == 1 and log.calls[0] == (verb, (verb, 8))
        with pytest.raises(ServiceUnavailableError) as ei:
            svc.submit(torch.ones(1, 4))
        assert ei.value.reason == "breaker_open"
        assert ei.value.retry_after_s == pytest.approx(1.0)
        assert not svc.worker.run_once()      # dispatch held while open
    clock.advance(1.1)                        # half-open probe
    assert svc.worker.run_once()
    assert torch.equal(f.result(timeout=0), torch.full((2, 4), 2.0))
    assert br.state is BreakerState.CLOSED
    svc.close()


def test_breaker_second_strike_relays():
    clock = FakeClock()
    br = CircuitBreaker("torch-echo", failure_threshold=1, cooldown_s=1.0, clock=clock)
    svc = _echo(clock, breaker=br)
    with inject_worker(svc.worker, faults.FailNth(1, persistent=True)):
        f = svc.submit(torch.ones(2, 4))
        svc.worker.run_once()
        clock.advance(1.1)
        svc.worker.run_once()
        with pytest.raises(faults.InjectedError):
            f.result(timeout=0)
        assert f.trace().terminal() == "failed"
    svc.close()


def test_retry_policy_retries_a_transient_failure():
    calls = {"n": 0}

    def flaky(padded):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return padded * 2.0

    clock = FakeClock()
    svc = Service("torch-flaky", flaky, dim=4, device="cpu", start=False, max_batch_rows=8,
                  max_wait_ms=0.0, clock=clock,
                  retry_policy=RetryPolicy(max_retries=2, base_delay=0.0, sleep=lambda s: None))
    fut = svc.submit(torch.ones(2, 4))
    assert svc.worker.run_once()
    assert calls["n"] == 2 and (fut.result(timeout=0) == 2.0).all()
    assert RetryPolicy(max_retries=3, base_delay=0.05).schedule() == [0.05, 0.1, 0.2]
    svc.close()


def test_failure_without_policy_fails_every_rider():
    def boom(padded):
        raise RuntimeError("device gone")

    clock = FakeClock()
    svc = Service("torch-boom", boom, dim=4, device="cpu", start=False, max_batch_rows=8,
                  max_wait_ms=0.0, clock=clock, breaker=False)
    futs = [svc.submit(torch.ones(1, 4)) for _ in range(2)]
    svc.worker.run_once()
    for f in futs:
        with pytest.raises(RuntimeError, match="device gone"):
            f.result(timeout=0)
    svc.close()


# ---------------------------------------------------------------------- #
# threaded lifecycle
# ---------------------------------------------------------------------- #
def test_threaded_mixed_shapes_resolve_exactly_once(index, rng):
    svc = KNNService(index, k=5, device="cpu", max_batch_rows=64, max_wait_ms=1.0,
                     queue_cap=512, name="torch-threaded")
    svc.warmup()
    rows = [int(r) for r in rng.integers(1, 33, size=60)]
    blocks = _blocks(rng, rows)
    futs = [None] * len(blocks)
    errors = []

    def submitter(lo):
        try:
            for i in range(lo, len(blocks), 6):
                futs[i] = svc.submit(blocks[i])
        except Exception as e:  # noqa: BLE001 — collected
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors and not any(t.is_alive() for t in threads)
    for q, fut in zip(blocks, futs):
        d, i = fut.result(timeout=30)
        rd, ri = brute_force_knn(index, q, 5, device="cpu")
        assert_knn_close(rd.numpy(), ri.numpy(), d.numpy(), i.numpy(), RTOL, ATOL)
        kinds = fut.trace().kinds()
        assert sum(k in flight.TERMINAL_KINDS for k in kinds) == 1, kinds
    assert svc.drain(timeout=10)
    svc.close()
    svc.close()                           # idempotent
    assert not svc.worker.is_alive() and not svc.is_open()
    assert svc.stats()["kernel_libraries_after_warmup"] == {"builds": 0, "loads": 0}


def test_close_without_drain_fails_leftovers(index, rng):
    svc = KNNService(index, k=5, device="cpu", start=False, max_batch_rows=32,
                     max_wait_ms=1000.0)
    f = svc.submit(_blocks(rng, (2,))[0])
    svc.close(drain=False)
    with pytest.raises(CommTimeoutError):
        f.result(timeout=0)


# ---------------------------------------------------------------------- #
# the query-vector cache
# ---------------------------------------------------------------------- #
def test_submit_keys_equals_submit(index, rng):
    clock = FakeClock()
    svc = KNNService(index, k=5, device="cpu", start=False, clock=clock, max_batch_rows=32,
                     query_cache_size=64)
    vecs = _blocks(rng, (10,))[0]
    svc.cache_put(np.arange(100, 110), vecs)
    by_key = svc.submit_keys([103, 107])
    by_vec = svc.submit(vecs[[3, 7]])
    clock.advance(0.5)
    assert svc.worker.run_once()
    for a, b in zip(by_key.result(timeout=0), by_vec.result(timeout=0)):
        assert torch.equal(a, b)
    with pytest.raises(LogicError, match="999"):
        svc.submit_keys([103, 999])
    with pytest.raises(LogicError):
        svc.cache_put([-1], vecs[:1])
    svc.close()


@pytest.mark.parametrize("n_vecs,assoc", [(64, 8), (12, 4), (8, 32)])
def test_vec_cache_matches_jax(rng, n_vecs, assoc):
    ours, theirs = VecCache(4, n_vecs, assoc, device="cpu"), JaxVecCache(4, n_vecs, assoc)
    s, js = ours.init(), theirs.init()
    for step in range(6):
        keys = rng.integers(0, 40, size=7).astype(np.int32)
        vecs = rng.standard_normal((7, 4)).astype(np.float32)
        s = ours.store_vecs(s, torch.from_numpy(keys), torch.from_numpy(vecs))
        js = theirs.store_vecs(js, jnp.asarray(keys), jnp.asarray(vecs))
        look = rng.integers(0, 40, size=9).astype(np.int32)
        v, f, s = ours.get_vecs(s, torch.from_numpy(look))
        jv, jf, js = theirs.get_vecs(js, jnp.asarray(look))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(s.keys.numpy(), np.asarray(js.keys))
        np.testing.assert_array_equal(s.time.numpy(), np.asarray(js.time))


# ---------------------------------------------------------------------- #
# knobs
# ---------------------------------------------------------------------- #
def test_knob_defaults_equal_the_jax_defaults():
    names = [n for n in jax_config.describe() if n.startswith("serve_")
             and n not in ("serve_hedge_ms", "serve_hedge_factor", "serve_hedge_min_ms")
             and not n.startswith("serve_ann_")] + ["flight_events"]
    for name in names:
        assert config.knob_default(name) == jax_config.knob_default(name), name


def test_knobs_feed_the_defaults(index):
    with config.override(serve_bucket_rungs="4,16", serve_max_wait_ms="7",
                         serve_queue_cap="5", serve_breaker_threshold="0",
                         serve_breaker_window_failures="0",
                         serve_tenant_weights="gold:3,bronze:1"):
        svc = KNNService(index, k=5, device="cpu", start=False, max_batch_rows=32)
    assert svc.policy.rungs == (4, 16, 32)
    assert svc.batcher.max_wait_s == pytest.approx(0.007)
    assert svc.batcher.queue_cap == 5 and svc.breaker is None
    assert svc.tenant_weights == {"gold": 3.0, "bronze": 1.0}
    svc.close()
    svc = KNNService(index, k=5, device="cpu", start=False)
    assert svc.policy.rungs[0] == 8 and svc.breaker is not None
    svc.close()


def test_knob_env_and_parse_errors(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_SERVE_QUEUE_CAP", "77")
    assert config.get_int("serve_queue_cap") == 77
    config.configure(serve_queue_cap="9")
    try:
        assert config.get_int("serve_queue_cap") == 9
    finally:
        config.configure(serve_queue_cap=None)
    assert config.get_int("serve_queue_cap") == 77
    monkeypatch.setenv("RAFT_TPU_SERVE_QUEUE_CAP", "lots")
    with pytest.raises(LogicError, match="RAFT_TPU_SERVE_QUEUE_CAP"):
        config.get_int("serve_queue_cap")
    with config.override(serve_queue_cap=None):
        assert config.get("serve_queue_cap") == "lots"
    with pytest.raises(ValueError):
        config.get("no_such_knob")
    assert os.environ["RAFT_TPU_SERVE_QUEUE_CAP"] == "lots"
