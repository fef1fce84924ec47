"""The trace reduction on synthetic Chrome traces."""

import re

import pytest

from portbench import trace as T


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    # window 0-1000 us; kernels 100-300 and 250-400 (overlap) and 700-800;
    # the first launched inside a work_list range
    return T.Trace([
        _ev("user_annotation", T.WINDOW, 0, 1000),
        _ev("user_annotation", "fused_ivf_scan.work_list", 50, 60),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 200, 5, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 600, 5, corr=3),
        _ev("cpu_op", "aten::sort", 450, 200),
        _ev("kernel", "void a<1>(int)", 100, 200, tid=7, corr=1),
        _ev("kernel", "void b(float*)", 250, 150, tid=7, corr=2),
        _ev("gpu_memset", "Memset (Device)", 700, 100, tid=7, corr=3),
        _ev("kernel", "void c()", 1100, 50, tid=7, corr=4),   # after the window
    ])


def test_idle_share_is_the_union_of_device_intervals():
    t = _trace()
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(400e-6)
    assert t.idle_pct() == pytest.approx(60.0)


def test_device_time_under_a_range():
    t = _trace()
    under = t.under_range("fused_ivf_scan.work_list", t.kernels(cats=T.DEVICE_CATS))
    assert [k[0] for k in under] == ["void a<1>(int)"]


def test_breakdown():
    t = _trace()
    ops = dict(t.top_device_ops())
    assert ops == pytest.approx({"void a<1>": 200e-6, "void b": 150e-6,
                                 "Memset": 100e-6})
    gaps = dict(t.idle_gaps())
    # gaps 0-100 (the work_list range covers 50), 400-700 (aten::sort
    # covers 550) and 800-1000 (nothing covers 900)
    assert gaps == pytest.approx({"host: aten::sort": 300e-6, "host: no traced op": 200e-6,
                                  "host: fused_ivf_scan.work_list": 100e-6})


def test_no_device_work_reads_nothing():
    t = T.Trace([_ev("user_annotation", T.WINDOW, 0, 1000)])
    assert t.idle_pct() is None


@pytest.mark.parametrize("name,mode", [
    ("void raft_tpu_torch::knn_tile_kernel<128, 4, 0, false>(CUtensorMap, float const*)", 0),
    ("void raft_tpu_torch::(anonymous namespace)::knn_tile_kernel<16, 4, 2, false>(int)", 2),
    ("_ZN14raft_tpu_torch15knn_tile_kernelILi128ELi4ELi0ELb0EEEv14CUtensorMap", 0),
])
def test_tile_kernel_modes(name, mode):
    assert re.search(T.tile_kernel(mode), name)
    assert not re.search(T.tile_kernel(3 - mode if mode else 2), name)


def test_select_kernels():
    assert re.search(T.SELECT_KERNEL, "void raft_tpu_torch::select_rows(float const*, int)")
    assert not re.search(T.SELECT_KERNEL, "void at::native::sbtopk::gatherTopK<float>()")


def _reader_ctx(events, launches=None, pool_rows=(100, 100), calls=(3, 2)):
    import types

    import torch
    from portbench import harness
    spec = harness.cell_spec("sift1m_bruteforce.batch10k")
    pool = [torch.zeros(m, spec["config"]["dim"]) for m in pool_rows]
    return types.SimpleNamespace(trace=T.Trace(events), launches=launches or {},
                                 work={"pool": pool, "calls": list(calls)},
                                 config=spec["config"], traffic=spec["traffic"], k=100)


K1 = "void raft_tpu_torch::knn_tile_kernel<64, 4, 0, false>(CUtensorMap, int)"


def test_k1_roofline_counts_the_calls_not_the_launches():
    from portbench import harness
    from portbench.frozen import cost, peaks
    read = harness._reader("k1_roofline")
    # five calls split into ten launches of 50 us each
    events = [_ev("user_annotation", T.WINDOW, 0, 10000)]
    events += [_ev("kernel", K1, 100 + 600 * j, 50, tid=7, corr=j) for j in range(10)]
    got = read(_reader_ctx(events))
    ops, nbytes = cost.knn_cost(100, 1_000_000, 128, 100)
    least = 5 * max(ops * 3 / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    assert got["bound"] == "operations"
    assert got["value"] == pytest.approx(100.0 * least / 500e-6)


def test_readers_read_nothing_where_their_kernel_did_not_run():
    from portbench import harness
    ctx = _reader_ctx([_ev("user_annotation", T.WINDOW, 0, 1000),
                       _ev("kernel", "void other()", 10, 5, tid=7, corr=1)])
    for name in ("k1_roofline", "k2_roofline", "k3_roofline"):
        assert harness._reader(name)(ctx) is None


def test_k2_roofline_fails_where_k2_ran_uncounted():
    from portbench import harness
    ctx = _reader_ctx([_ev("user_annotation", T.WINDOW, 0, 1000),
                       _ev("kernel", "void raft_tpu_torch::select_rows(float const*)", 10, 5,
                           tid=7, corr=1)])
    with pytest.raises(RuntimeError, match="no select_tile launch"):
        harness._reader("k2_roofline")(ctx)
    ctx.launches = {"select_tile": {"(10, 1000, 10)": 1}}
    assert harness._reader("k2_roofline")(ctx)["bound"] == "bytes"
