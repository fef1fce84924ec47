"""The communicator's failure contract in the port (raft_tpu_torch.comms),
on a mesh of 8 CPU rank slots: retry and backoff, the watchdog and its
commit handshake, the abort latch, malformed calls, a lost rank through
the fault seam and its liveness probe, and ``faults.inject``.  The same
cases as the JAX package's ``tests/test_comms_resilience.py``; where the
JAX fault vocabulary decides (which calls a fault matches), both
packages' faults are asked the same question."""

import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu.comms import Op as JOp
from raft_tpu.comms import faults as jfaults
from raft_tpu_torch.comms import HostComms, Mesh, Op, RetryPolicy, Status, faults, selftest
from raft_tpu_torch.comms.faults import InjectedError
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.error import (CommAbortedError, CommError, CommTimeoutError,
                                       LogicError)
from raft_tpu_torch.core.handle import Handle

SIZE = 8
CPU = torch.device("cpu")


def _comms(**kw):
    return HostComms(Mesh([CPU] * SIZE, ("ranks",)), **kw)


def fast_policy(**kw):
    """A policy whose backoff is recorded, not slept."""
    slept = []
    kw.setdefault("max_retries", 3)
    kw.setdefault("base_delay", 0.01)
    return RetryPolicy(sleep=slept.append, **kw), slept


def _ones():
    return torch.ones((SIZE, 1))


def test_transient_allreduce_retries_then_succeeds():
    policy, slept = fast_policy()
    comms = _comms(retry_policy=policy)
    with faults.inject(comms, faults.FailNth(1, verb="allreduce")) as log:
        out = comms.allreduce(_ones())
    assert (out == SIZE).all()
    assert [v for v, _ in log.calls] == ["allreduce", "allreduce"]
    assert log.injected[0].verb == "allreduce" and slept == [0.01]
    assert not comms.aborted


def test_watchdog_timeout_retried_then_succeeds():
    policy, _ = fast_policy(max_retries=1, timeout=0.1)
    comms = _comms(retry_policy=policy)
    before = tracing.get_counter("comms.timeout")
    x = torch.zeros((SIZE, 1))
    x[0, 0] = 5.0
    with faults.inject(comms, faults.Delay(1.0, verb="bcast", times=1)) as log:
        out = comms.bcast(x)
    assert (out == 5.0).all()
    assert [v for v, _ in log.calls] == ["bcast", "bcast"]
    assert tracing.get_counter("comms.timeout") == before + 1


def test_abandoned_delayed_attempt_never_dispatches_late():
    """A delay outliving the watchdog must not run its verb after waking:
    the abandoned runner bails at the fault seam."""
    comms = _comms(retry_policy=RetryPolicy(max_retries=1, base_delay=0.0, timeout=0.1))
    executed = []
    real = comms._execute

    def counting(key, fn, *args, **kwargs):
        executed.append(key[0])
        return real(key, fn, *args, **kwargs)

    comms._execute = counting
    gate = threading.Event()
    with faults.inject(comms, faults.Delay(0.0, verb="allreduce", times=1,
                                           sleep=lambda s: gate.wait(5))):
        out = comms.allreduce(_ones())
        assert (out == SIZE).all()
        assert executed == ["allreduce"]              # only the retry
        gate.set()                                    # wake the abandoned attempt
        time.sleep(0.2)
        assert executed == ["allreduce"]              # it bailed


def test_random_faults_recovered_by_retry():
    policy, _ = fast_policy(max_retries=8, base_delay=0.0)
    comms = _comms(retry_policy=policy)
    x = torch.arange(SIZE, dtype=torch.float32)[:, None]
    want = comms.allreduce(x)
    with faults.inject(comms, faults.RandomFail(0.25, seed=1234)):
        for _ in range(10):
            assert torch.equal(comms.allreduce(x), want)
    assert not comms.aborted


def test_random_fail_pattern_matches_jax():
    def pattern(mod, seed):
        f = mod.RandomFail(0.5, seed=seed)
        out = []
        for i in range(32):
            try:
                f.apply(None, "allreduce", ("allreduce",), i + 1)
                out.append(False)
            except Exception:
                out.append(True)
        return out

    assert pattern(faults, 7) == pattern(jfaults, 7)
    assert pattern(faults, 7) != pattern(faults, 8)


@pytest.mark.parametrize("key,rank", [(("bcast", 3), 3), (("bcast", 0), 3),
                                      (("p2p", ((0, 1), (2, 3))), 2), (("p2p", ((0, 1),)), 2),
                                      (("allreduce", "op0"), 0)])
def test_delay_rank_scoping_matches_jax(key, rank):
    if key[1] == "op0":
        port_key, jax_key = ("allreduce", Op.SUM), ("allreduce", JOp.SUM)
    else:
        port_key = jax_key = key
    assert (faults.Delay(0.0, rank=rank).matches(key[0], port_key)
            == jfaults.Delay(0.0, rank=rank).matches(key[0], jax_key))


def test_abort_latches_and_all_verbs_fail_fast():
    comms = _comms()
    x = _ones()
    with faults.inject(comms, faults.Abort(verb="allreduce")) as log:
        with pytest.raises(CommAbortedError):
            comms.allreduce(x)
    assert comms.aborted
    n_calls = len(log.calls)
    for verb in (lambda: comms.allreduce(x), lambda: comms.bcast(x),
                 lambda: comms.allgather(x), lambda: comms.barrier(),
                 lambda: comms.isend(x[0], rank=0, dest=1),
                 lambda: comms.irecv(rank=1, source=0), lambda: comms.waitall(),
                 lambda: comms.comm_split([0] * SIZE)):
        with pytest.raises(CommAbortedError):
            verb()
    assert len(log.calls) == n_calls
    assert comms.sync_stream() == Status.ABORT


def test_abort_latch_survives_retry_policy():
    policy, slept = fast_policy(max_retries=5)
    comms = _comms(retry_policy=policy)
    with faults.inject(comms, faults.Abort(verb="allreduce")) as log:
        with pytest.raises(CommAbortedError):
            comms.allreduce(_ones())
    assert len(log.calls) == 1 and slept == []


def test_exhausted_timeouts_surface_as_comm_timeout_error():
    policy, _ = fast_policy(max_retries=1, timeout=0.05)
    comms = _comms(retry_policy=policy)
    gate = threading.Event()
    try:
        with faults.inject(comms, faults.Delay(0.0, verb="allreduce",
                                               sleep=lambda s: gate.wait(5))):
            with pytest.raises(CommTimeoutError):
                comms.allreduce(_ones())
    finally:
        gate.set()
    assert comms.aborted


def test_exhausted_retries_latch_abort():
    policy, slept = fast_policy(max_retries=2)
    comms = _comms(retry_policy=policy)
    with faults.inject(comms, faults.FailNth(1, verb="allreduce", persistent=True)) as log:
        with pytest.raises(CommError) as ei:
            comms.allreduce(_ones())
    assert "after 3 attempts" in str(ei.value)
    assert len(log.calls) == 3 and len(slept) == 2 and comms.aborted
    with pytest.raises(CommAbortedError):
        comms.bcast(_ones())


def test_malformed_call_neither_retried_nor_poisoning():
    policy, slept = fast_policy(max_retries=4)
    comms = _comms(retry_policy=policy)
    with pytest.raises(LogicError, match="permutation"):
        comms.device_sendrecv(_ones(), [(0, 1), (1, 1)])
    with pytest.raises(LogicError, match="rank-major"):
        comms.allreduce(torch.ones((SIZE - 1, 1)))
    assert slept == [] and not comms.aborted
    assert (comms.allreduce(_ones()) == SIZE).all()


def test_handle_surfaces_aborted_comms():
    handle = Handle(device="cpu")
    comms = _comms()
    handle.set_comms(comms)
    assert handle.get_comms() is comms
    comms.abort()
    with pytest.raises(CommAbortedError):
        handle.get_comms()


def test_failed_waitall_consumes_requests():
    comms = _comms()
    comms.isend(torch.ones((1,)), rank=0, dest=1, tag=99)
    with pytest.raises(LogicError):
        comms.waitall()
    assert comms._requests == []
    comms.isend(torch.full((1,), 3.0), rank=0, dest=1, tag=5)
    r = comms.irecv(rank=1, source=0, tag=5)
    comms.waitall()
    assert float(r.result[0]) == 3.0


def test_fault_injection_reaches_the_p2p_route():
    """With an injector on the seam, the device route takes the ppermute
    route, so a p2p fault is seen."""
    comms = _comms()
    comms.isend(torch.ones(2), rank=0, dest=1)
    r = comms.irecv(rank=1, source=0)
    with faults.inject(comms, faults.FailNth(1, verb="p2p")) as log:
        with pytest.raises(CommError):
            comms.waitall()
    assert [v for v, _ in log.calls] == ["p2p"] and r.result is None
    assert comms.aborted


# --------------------------------------------------------------------- #
# a lost rank: Abort(rank=) and the per-rank liveness probe
# --------------------------------------------------------------------- #
def test_abort_rank_matches_the_verbs_that_rank_takes_part_in():
    f = faults.Abort(rank=3)
    assert f.matches("allreduce", ("allreduce", Op.SUM))     # a collective: every rank
    assert f.matches("bcast", ("bcast", 0))
    assert f.matches("probe", ("probe", 3)) and not f.matches("probe", ("probe", 2))
    assert f.matches("p2p", ("p2p", ((2, 3),))) and not f.matches("p2p", ("p2p", ((0, 1),)))
    assert faults.Abort().matches("probe", ("probe", 2))     # unscoped: every call


def test_lost_rank_aborts_and_only_its_probe_fails():
    comms = _comms()
    assert all(comms.probe_rank(r) for r in range(SIZE))
    with faults.inject(comms, faults.Abort(rank=5)):
        with pytest.raises(CommAbortedError, match="rank=5"):
            comms.allreduce(_ones())
        assert comms.aborted
        assert [comms.probe_rank(r) for r in range(SIZE)] == [r != 5 for r in range(SIZE)]
        assert not any(selftest.run_all(comms).values())
    # the probe bypasses the latch: after the injector, every rank answers
    assert all(comms.probe_rank(r) for r in range(SIZE))


def test_inject_restores_the_seam_even_on_error():
    comms = _comms()
    with pytest.raises(RuntimeError):
        with faults.inject(comms, faults.FailNth(1)):
            assert comms._execute_is_patched()
            raise RuntimeError("boom")
    assert not comms._execute_is_patched()
    assert (comms.allreduce(_ones()) == SIZE).all()


def test_injected_error_is_a_comm_error():
    assert issubclass(InjectedError, CommError)
    comms = _comms()
    with faults.inject(comms, faults.FailNth(2, verb="allgather")) as log:
        comms.allgather(_ones())
        with pytest.raises(CommError):
            comms.allgather(_ones())
    assert [i.call for i in log.injected] == [2]


def test_get_type_unsupported_dtype_is_logic_error():
    from raft_tpu_torch.comms import get_type

    with pytest.raises(LogicError, match="no communicator wire type"):
        get_type(np.complex64)
    with pytest.raises(LogicError, match="no communicator wire type"):
        get_type(torch.bool)
