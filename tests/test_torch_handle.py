"""Port parity of the resource handle (raft_tpu_torch.core.handle) and the
numeric sanitizer hooks (raft_tpu_torch.core.debug) against the JAX
package's, on the CPU.

The handle's CUDA streams cannot run here: the ordering that
``takes_handle`` sets up between the caller's stream and the handle's is
driven with stand-in streams and events, as ``test_torch_serve.py`` drives
the serving worker's.
"""

import contextlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_tpu.core.handle import Handle as JaxHandle
from raft_tpu_torch import LogicError, RaftError
from raft_tpu_torch.core import debug, handle as handle_mod
from raft_tpu_torch.core.error import CommAbortedError
from raft_tpu_torch.core.handle import Handle, Stream, stream_syncer, takes_handle
from raft_tpu_torch.core.metrics import default_registry
from raft_tpu_torch.linalg import compute_smallest_eigenvectors, gemm, range_init, row_norm


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RaftError, match="CUDA"):
        Handle()
    with pytest.raises(RaftError, match="CUDA"):
        gemm(np.eye(2, dtype=np.float32), np.eye(2, dtype=np.float32))


@pytest.mark.parametrize("n_streams", [0, 1, 3])
def test_stream_pool_like_jax(n_streams):
    ours, theirs = Handle("cpu", n_streams=n_streams), JaxHandle(n_streams=n_streams)
    assert ours.get_stream_pool_size() == theirs.get_stream_pool_size() == n_streams
    assert ours.is_stream_pool_initialized() == theirs.is_stream_pool_initialized()
    for idx in range(5):
        if n_streams:
            assert (ours.get_stream_from_stream_pool(idx).name
                    == theirs.get_stream_from_stream_pool(idx).name)
        assert ours.get_next_usable_stream(idx).name == theirs.get_next_usable_stream(idx).name
    if not n_streams:
        for h in (ours, theirs):
            with pytest.raises(Exception, match="stream_pool was not initialized"):
                h.get_stream_from_stream_pool(0)
    assert ours.get_stream().name == "main" and ours.get_stream().stream is None
    ours.get_stream().record(torch.zeros(2))
    ours.sync_stream()
    ours.sync_stream_pool()
    ours.wait_stream_pool_on_stream()


def test_comms_injection_like_jax():
    for h, aborted_error in ((Handle("cpu"), CommAbortedError), (JaxHandle(), Exception)):
        assert not h.comms_initialized()
        with pytest.raises(Exception, match="Communicator was not initialized"):
            h.get_comms()
        comms = type("C", (), {"aborted": False})()
        h.set_comms(comms)
        assert h.comms_initialized() and h.get_comms() is comms
        comms.aborted = True
        with pytest.raises(aborted_error, match="aborted"):
            h.get_comms()
        h.set_subcomm("rows", comms)
        assert h.get_subcomm("rows") is comms
        with pytest.raises(Exception, match="cols was not found"):
            h.get_subcomm("cols")


def test_device_properties():
    h = Handle("cpu")
    assert h.get_device() == torch.device("cpu")
    assert h.get_device_properties()["platform"] == "cpu"


def test_stream_syncer_syncs_main_and_pool():
    h = Handle("cpu", n_streams=2)
    synced = []
    for s in [h.get_stream()] + [h.get_stream_from_stream_pool(i) for i in range(2)]:
        s.sync = lambda s=s: synced.append(s.name)
    with stream_syncer(h) as got:
        assert got is h
    assert synced == ["main", "pool0", "pool1"]


def test_takes_handle_moves_inputs_and_traces():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    h = Handle("cpu")
    timer = "raft_tpu_linalg_row_norm_seconds"
    fam = default_registry().get(timer)
    before = fam.labels().count if fam is not None else 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = row_norm(a, handle=h)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    torch.testing.assert_close(got, torch.from_numpy((a * a).sum(1)), rtol=0, atol=0)
    assert "linalg.row_norm" in {e.key for e in prof.key_averages()}
    assert default_registry().get(timer).labels().count == before + 1
    assert torch.equal(row_norm(a, device="cpu"), got)
    # a primitive that makes tensors from no array is given the device
    assert range_init(2, 6, handle=h).tolist() == [2, 3, 4, 5]
    with pytest.raises(LogicError, match="differs from the handle"):
        row_norm(a, handle=h, device="meta")
    assert "handle" in row_norm.__doc__


class _FakeStream:
    def __init__(self, name):
        self.name, self.waited = name, []

    def wait_stream(self, other):
        self.waited.append(other)

    def synchronize(self):
        pass


class _FakeEvent:
    def __init__(self):
        self.recorded_on, self.synced = None, 0

    def record(self, stream):
        self.recorded_on = stream

    def synchronize(self):
        self.synced += 1


def test_handle_stream_orders_after_and_before_the_caller(monkeypatch):
    # the handle's stream waits for the caller's before the call; the call
    # runs on the handle's; the caller's waits for the handle's after it,
    # and an event marks the handle's work
    caller, main = _FakeStream("caller"), _FakeStream("main")
    log = {"entered": [], "events": []}

    @contextlib.contextmanager
    def enter(stream):
        log["entered"].append(stream)
        yield

    def event():
        log["events"].append(_FakeEvent())
        return log["events"][-1]

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: caller)
    monkeypatch.setattr(torch.cuda, "stream", enter)
    monkeypatch.setattr(torch.cuda, "Event", event)
    h = Handle("cpu")
    h.get_stream().stream = main
    out = gemm(np.eye(3, dtype=np.float32), np.ones((3, 2), np.float32), handle=h)
    assert main.waited == [caller] and caller.waited == [main]
    assert log["entered"] == [main]
    (ev,) = log["events"]
    assert ev.recorded_on is main and ev.synced == 0
    assert torch.equal(out, torch.ones(3, 2))
    # sync waits for the recorded work once; nothing recorded, no wait
    h.sync_stream()
    h.sync_stream()
    assert ev.synced == 1


def test_stream_sync_failure_is_a_raft_error():
    s = Stream("main", torch.device("cpu"))

    class Broken:
        def synchronize(self):
            raise RuntimeError("device-side assert")

    s._event = Broken()
    with pytest.raises(RaftError, match="stream 'main' sync failed"):
        s.sync()
    s.sync()                      # reported once, then dropped


def test_decorated_signature_keeps_its_name():
    @takes_handle
    def thing(x):
        """Doc."""
        return x + 1

    assert thing.__name__ == "thing" and thing.__doc__.startswith("Doc.")
    assert thing(np.zeros(2, np.float32), device="cpu").tolist() == [1.0, 1.0]


# ---------------------------------------------------------------------- #
# debug checks
# ---------------------------------------------------------------------- #
@pytest.fixture
def debug_on():
    debug.enable_debug_checks(True)
    yield
    debug.enable_debug_checks(False)


def test_check_finite_is_off_by_default():
    assert not debug.debug_checks_enabled()
    x = torch.tensor([1.0, float("nan")])
    assert debug.check_finite(x, "x") is x


def test_check_finite_raises_when_on(debug_on):
    assert debug.debug_checks_enabled()
    ok = torch.ones(3)
    assert debug.check_finite(ok, "ok") is ok
    for bad in (float("nan"), float("inf"), -float("inf")):
        with pytest.raises(debug.NumericError, match="'x' contains non-finite"):
            debug.check_finite(torch.tensor([1.0, bad]), "x")
    assert issubclass(debug.NumericError, RaftError)


def test_lanczos_catches_seeded_nan(debug_on):
    a = np.eye(40, dtype=np.float32) * np.arange(1, 41, dtype=np.float32)
    a[3, 5] = a[5, 3] = np.nan
    with pytest.raises(debug.NumericError, match="lanczos"):
        compute_smallest_eigenvectors(a, 40, 2, maxiter=80, device="cpu")


def test_env_turns_the_checks_on():
    code = ("from raft_tpu_torch.core import debug; "
            "assert debug.debug_checks_enabled(); print('on')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"RAFT_TPU_DEBUG": "1", "PATH": "/usr/bin:/bin"},
                         cwd=str(handle_mod.__file__).rsplit("/raft_tpu_torch/", 1)[0])
    assert out.returncode == 0 and "on" in out.stdout, out.stderr
