"""The phase counters of the fused tile kernel, on the CPU: the reduction of
raw counter buffers to ``kernel_phases()``'s table, the collector over CPU
tensors (nothing counted, answers unchanged), the timed build's library
name, the buffer layout against ``ops/csrc/knn_tile.cuh``, the launch
seam's choice of the timed entry (a fake launcher on a fake card), and
the program's trace ranges under ``core.tracing``'s switch.  The timed
instances themselves run only on a card
(``portbench/tests/test_portbench_phases_card.py``)."""

import contextlib
import ctypes
import hashlib
import re
import types

import numpy as np
import pytest
import torch

from raft_tpu_torch.core import inventory, tracing
from raft_tpu_torch.core.error import RaftError
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops.ivf_tile import fused_ivf_scan
from raft_tpu_torch.ops.knn_tile import fused_knn_tile, twophase_tiles
from raft_tpu_torch.ops.nn_tile import fused_nn_tile
from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat_build, ivf_flat_search

K1_64_4 = 64 | 4 << 8 | 0 << 16
K3_16_4 = 16 | 4 << 8 | 2 << 16


def _row(instance, blocks, mma, select, producer):
    """A counter buffer: each role's (total, phase...) in tracing.PHASES order."""
    row = [blocks, *mma, *select, *producer, instance]
    assert len(row) == tracing.PHASE_WORDS
    return row


def _rows():
    return [
        _row(K1_64_4, 157, (1000, 100, 200, 0, 50, 30), (4000, 2000, 500, 700, 100),
             (250, 200)),
        _row(K1_64_4, 157, (1200, 150, 250, 0, 50, 30), (4200, 2100, 520, 680, 120),
             (260, 210)),
        _row(K3_16_4 | 1 << 24, 132, (900, 300, 100, 200, 10, 40), (3000, 1000, 300, 900, 400),
             (200, 150)),
        [0] * tracing.PHASE_WORDS,       # a launch that never ran names no instance
    ]


def test_reduction_sums_launches_by_instance():
    table = tracing.reduce_phases(_rows(), [0.0625, 0.0635, 0.02, 0.0])
    assert set(table) == {"knn_tile_kernel<64, 4, 0, false>", "knn_tile_kernel<16, 4, 2, true>"}
    k1 = table["knn_tile_kernel<64, 4, 0, false>"]
    assert (k1["kernel"], k1["calls"], k1["blocks"]) == ("K1", 2, 314)
    assert k1["seconds"] == pytest.approx(0.126)
    assert k1["cycles"]["mma"] == {"total": 2200, "wait_load": 250, "wait_tensor": 450,
                                   "fill": 0, "wait_select": 100, "epilogue": 60,
                                   "issue": 1340}
    assert k1["cycles"]["producer"] == {"total": 510, "wait_slot": 410, "issue": 100}
    assert k1["shares"]["mma"]["wait_load"] == pytest.approx(100.0 * 250 / 2200)
    assert k1["shares"]["select"]["wait_tile"] == pytest.approx(100.0 * 4100 / 8200)
    k3 = table["knn_tile_kernel<16, 4, 2, true>"]
    assert (k3["kernel"], k3["calls"], k3["blocks"]) == ("K3", 1, 132)
    assert k3["shares"]["mma"]["fill"] == pytest.approx(100.0 * 200 / 900)


@pytest.mark.parametrize("role,phases", tracing.PHASES, ids=[r for r, _ in tracing.PHASES])
def test_issue_is_each_roles_remainder(role, phases):
    for e in tracing.reduce_phases(_rows(), [0.0] * 4).values():
        c = e["cycles"][role]
        assert c["issue"] == c["total"] - sum(c[p] for p in phases) >= 0
        assert set(e["shares"][role]) == set(phases) | {"issue"}
        assert sum(e["shares"][role].values()) == pytest.approx(100.0)
        assert all(0.0 <= v <= 100.0 for v in e["shares"][role].values())


def test_a_role_that_never_ran_reads_zero_shares():
    row = _row(K1_64_4, 1, (10, 2, 2, 0, 2, 2), (0, 0, 0, 0, 0), (0, 0))
    e = tracing.reduce_phases([row], [0.001])["knn_tile_kernel<64, 4, 0, false>"]
    assert set(e["shares"]["select"].values()) == {0.0}


def test_instance_names_match_the_traces():
    assert tracing.instance_name(K1_64_4) == "knn_tile_kernel<64, 4, 0, false>"
    assert tracing.instance_name(32 | 1 << 8 | 3 << 16 | 1 << 24) == \
        "knn_tile_kernel<32, 1, 3, true>"


def test_layout_matches_the_kernel_header():
    src = (_build.CSRC / "knn_tile.cuh").read_text()
    words = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (kPh\w+) = (\d+);", src)}
    assert words["kPhBlocks"] == 0 and words["kPhWords"] == tracing.PHASE_WORDS
    assert words["kPhInstance"] == tracing.PHASE_WORDS - 1
    bases = [words["kPhMma"], words["kPhSelect"], words["kPhProducer"]]
    enums = [re.search(r"enum %s \{([^}]*)\}" % name, src).group(1)
             for name in ("MmaPhase", "SelectPhase", "ProducerPhase")]
    w = 1
    for (role, phases), base, enum in zip(tracing.PHASES, bases, enums):
        assert base == w, role
        names = [e.strip() for e in enum.split(",")][:-1]      # the last counts them
        assert [re.sub(r"(?<!^)([A-Z])", r"_\1", n[1:]).lower() for n in names] == list(phases)
        w += 1 + len(phases)


def _knn_case(seed=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((300, 24)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((17, 24)).astype(np.float32))
    return x, q


@pytest.mark.parametrize("kernel", ["K1", "K6", "K4", "K3"])
def test_collector_on_cpu_counts_nothing_and_changes_nothing(kernel):
    x, q = _knn_case()
    calls = {
        "K1": lambda: fused_knn_tile(x, q, 5),
        "K6": lambda: twophase_tiles(x, q, 128),
        "K4": lambda: fused_nn_tile(q, x),
        "K3": lambda: fused_ivf_scan(q, x.view(10, 30, 24), (x * x).sum(1).view(10, 30),
                                     torch.arange(300, dtype=torch.int32).view(10, 30),
                                     torch.tensor([[0, 3, 7]] * 17, dtype=torch.int32), 5),
    }
    want = calls[kernel]()
    with tracing.kernel_phases() as table:
        assert tracing.phase_launch(torch.device("cpu")) is None
        got = calls[kernel]()
    assert table == {}
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_collector_is_per_thread_and_nests():
    assert getattr(tracing._phase_state, "launches", None) is None
    with tracing.kernel_phases():
        outer = tracing._phase_state.launches
        with tracing.kernel_phases():
            assert tracing._phase_state.launches is not outer
        assert tracing._phase_state.launches is outer
    assert tracing._phase_state.launches is None


def test_collector_synchronises_once_and_reduces(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(dev))

    class _Event:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, end):
            return end.ms - self.ms

    with tracing.kernel_phases() as table:
        for row, ms in zip(_rows()[:3], (62.5, 63.5, 20.0)):
            rec = types.SimpleNamespace(counts=torch.tensor(row, dtype=torch.int64),
                                        start=_Event(0.0), end=_Event(ms))
            tracing._phase_state.launches.append(rec)
        assert table == {}
    assert synced == [torch.device("cpu")]
    assert table == tracing.reduce_phases(_rows()[:3], [0.0625, 0.0635, 0.02])


def test_collector_fills_nothing_when_its_block_raises():
    with pytest.raises(ValueError):
        with tracing.kernel_phases() as table:
            raise ValueError("boom")
    assert table == {} and tracing._phase_state.launches is None


def _parent_library_path(name):
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for src in [_build.CSRC / f"{name}.cu"] + sorted(_build.CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _build.BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@pytest.mark.parametrize("name", ["knn_tile", "ivf_tile", "nn_tile", "knn_twophase"])
def test_timed_build_names_a_library_of_its_own(name):
    default = _build.library_path(name)
    assert default == _build.library_path(name, phases=False) == _parent_library_path(name)
    timed = _build.library_path(name, phases=True)
    assert timed != default and timed.parent == default.parent
    assert timed.name.startswith(name + "-phases-")
    assert _build.PHASE_DEFINE in _build._flags(name, True)
    assert _build.PHASE_DEFINE not in _build._flags(name, False)


def test_only_the_tile_kernel_has_a_timed_build():
    with pytest.raises(Exception, match="no phase-timed build"):
        _build.library_path("select_tile", phases=True)


def test_timed_entry_takes_the_buffer_last(monkeypatch):
    class _Lib:
        def __init__(self):
            self.knn_tile_launch = types.SimpleNamespace()

    libs = {}
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "load", lambda name, phases=False: libs.setdefault(phases, _Lib()))
    plain = _build.entry("knn_tile", "knn_tile_launch", [ctypes.c_int], ctypes.c_int)
    timed = _build.entry("knn_tile", "knn_tile_launch", [ctypes.c_int], ctypes.c_int, True)
    assert plain is not timed
    assert plain.argtypes == [ctypes.c_int]
    assert timed.argtypes == [ctypes.c_int, ctypes.c_void_p]


class _HostLaunch(tracing.PhaseLaunch):
    """A timed launch's record without a card: a host counter buffer and
    events that record nothing."""

    def __init__(self, device):
        self.counts = torch.zeros(tracing.PHASE_WORDS, dtype=torch.int64)
        self.start = self.end = types.SimpleNamespace(record=lambda: None,
                                                      elapsed_time=lambda end: 0.0)


@pytest.mark.parametrize("name", _build.KERNELS)
def test_the_launch_seam_times_only_the_tile_kernels(name, monkeypatch):
    # each kernel's launcher faked; the seam binds it, appends the stream,
    # takes the timed entry inside kernel_phases() only for PHASE_KERNELS,
    # counts each launch in the inventory, and raises on an error code
    calls, code = [], [0]

    class _Launcher:
        def __init__(self, phases):
            self.phases = phases

        def __call__(self, *args):
            calls.append((self.phases, args))
            return code[0]

    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "load", lambda n, phases=False: types.SimpleNamespace(
        **{n + "_launch": _Launcher(phases)}))
    monkeypatch.setattr(tracing, "PhaseLaunch", _HostLaunch)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(inventory, "_entries", {})
    card, buf = torch.device("cuda", 0), torch.zeros(3)

    def launch():
        _build.launch(name, card, (buf, 5, 2.5), "the_wrapper", (5, "highest"),
                      lambda: (10.0, 20.0, (12.0, 0.0, 0.0)))

    launch()
    with tracing.kernel_phases() as table:
        launch()
        assert len(tracing._phase_state.launches) == (name in _build.PHASE_KERNELS)
    assert table == {}
    timed = name in _build.PHASE_KERNELS
    assert [phases for phases, _ in calls] == [False, timed]
    assert calls[0][1] == (buf.data_ptr(), 5, 2.5, 7)
    assert calls[1][1][:4] == calls[0][1] and len(calls[1][1]) == 4 + timed
    fn = _build._entries[(name, name + "_launch", False)]
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    entry = inventory.snapshot()[name][repr((5, "highest"))]
    assert (entry["launches"], entry["flops"], entry["argument_bytes"]) == (2, 10.0, 12.0)
    code[0] = 700
    with pytest.raises(RaftError, match="the_wrapper: CUDA error 700 at launch"):
        launch()
    assert inventory.snapshot()[name][repr((5, "highest"))]["launches"] == 2


# ---------------------------------------------------------------------- #
# the program's trace ranges go through core.tracing
# ---------------------------------------------------------------------- #
RANGES = ["kmeans.init_plus_plus", "kmeans.lloyd", "ivf_flat_build.subsample",
          "ivf_flat_build.assign_all_rows", "ivf_flat_build.host_packing",
          "ivf_flat_build.gather_slots", "ivf_flat_search.probe", "fused_ivf_scan.work_list",
          "fused_ivf_scan.kernel", "fused_ivf_scan.merge"]


def _traced_names(enabled):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((400, 16)).astype(np.float32)
    q = rng.standard_normal((9, 16)).astype(np.float32)
    was = tracing.is_enabled()
    tracing.set_enabled(enabled)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            index = ivf_flat_build(x, IVFFlatParams(nlist=6, nprobe=3), train_rows=200,
                                   device="cpu")
            ivf_flat_search(index, q, 4, 3, scan_impl="kernel", device="cpu")
    finally:
        tracing.set_enabled(was)
    return {e.name for e in prof.events()}


@pytest.fixture(scope="module")
def traced():
    return {True: _traced_names(True), False: _traced_names(False)}


@pytest.mark.parametrize("name", RANGES)
def test_ranges_follow_the_tracing_switch(traced, name):
    assert name in traced[True]
    assert name not in traced[False]
