"""Port parity of the native host runtime binding (raft_tpu_torch.core.native)
against the JAX package's (raft_tpu.core.native) on the same inputs, and of
the IVF list packing's native route against its numpy route.

Both bindings build the same ``cpp/src/host_runtime.cpp``: the JAX one into
``cpp/build/``, the port's into ``build/raft_tpu_torch_host/``.  Results are
integer tables and float64 copies of the inputs, so they are held exactly.
"""

import shutil
import subprocess

import numpy as np
import pytest

from raft_tpu.core import native as jnative
from raft_tpu.spatial import ann as jann
from raft_tpu_torch import RaftError
from raft_tpu_torch.core import native
from raft_tpu_torch.spatial import ann as pann


@pytest.fixture(scope="module", autouse=True)
def require_native():
    assert native.native_available(), "the port's host runtime failed to build or load"
    assert jnative.native_available(), "the JAX package's host runtime failed to build or load"


def _tree(m, seed):
    rng = np.random.default_rng(seed)
    src = np.arange(1, m)
    dst = np.asarray([rng.integers(0, i) for i in range(1, m)])
    return src, dst, rng.random(m - 1)


def test_version_and_arena():
    assert native.native_version() == jnative.native_version()
    assert native.native_version().startswith("raft_tpu_host")
    total, in_use = native.arena_stats()
    assert 0 <= in_use <= total


def test_built_outside_the_jax_build_directory():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "raft_tpu_torch_host")
    assert "cpp" not in path.parts and path.exists()


@pytest.mark.parametrize("m,seed", [(2, 0), (40, 1), (257, 2)])
def test_build_dendrogram_matches_jax(m, seed):
    src, dst, w = _tree(m, seed)
    got, ref = native.build_dendrogram(src, dst, w, m), jnative.build_dendrogram(src, dst, w, m)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    # an input the library refuses raises: no second route takes it
    with pytest.raises(RaftError, match="m >= 2"):
        native.build_dendrogram(src, dst, w, 1)
    bad = dst.copy()
    bad[0] = m                    # a leaf off [0, m)
    with pytest.raises(RaftError, match="rt_build_dendrogram"):
        native.build_dendrogram(src, bad, w, m)


@pytest.mark.parametrize("n_clusters", [1, 2, 3, 7, 30])
def test_extract_clusters_matches_jax(n_clusters):
    m = 30
    children, _, _ = native.build_dendrogram(*_tree(m, 3), m)
    np.testing.assert_array_equal(native.extract_clusters(children, n_clusters, m),
                                  jnative.extract_clusters(children, n_clusters, m))
    with pytest.raises(RaftError, match="rt_extract_clusters"):
        native.extract_clusters(children, m + 1, m)


@pytest.mark.parametrize("m,nlist,seed", [(100, 7, 2), (1000, 16, 3), (5, 9, 4), (0, 3, 5)])
def test_build_lists_matches_jax(m, nlist, seed):
    labels = np.random.default_rng(seed).integers(0, nlist, m)
    got, ref = native.build_lists(labels, nlist), jnative.build_lists(labels, nlist)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1]
    with pytest.raises(RaftError, match="rt_build_lists"):
        native.build_lists(np.array([0, nlist]), nlist)
    # and _pack_lists does not quietly take the numpy route for it
    with pytest.raises(RaftError, match="rt_build_lists"):
        pann._pack_lists(np.array([0, nlist]), nlist)


@pytest.mark.parametrize("L,gmax,seed", [(5, 40, 6), (9, 3, 7)])
def test_pack_groups_matches_jax(L, gmax, seed):
    rng = np.random.default_rng(seed)
    owner, dist = rng.integers(0, L, 120), rng.random(120)
    got, ref = native.pack_groups(owner, dist, L, gmax), jnative.pack_groups(owner, dist, L, gmax)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    with pytest.raises(RaftError, match="rt_pack_groups"):
        native.pack_groups(np.array([L]), np.array([0.5]), L, gmax)


@pytest.mark.parametrize("m,nlist,seed", [(2400, 24, 0), (50, 8, 1), (333, 1, 2)])
def test_pack_lists_native_equals_numpy_route(m, nlist, seed):
    # skewed lists (a hot list and empty ones), as k-means leaves them
    rng = np.random.default_rng(seed)
    labels = np.minimum(rng.geometric(0.2, m) - 1, nlist - 1).astype(np.int64)
    table, max_len = pann._pack_lists(labels, nlist)
    ref_table, ref_len = pann._pack_lists_numpy(labels, nlist)
    np.testing.assert_array_equal(table, ref_table)
    assert max_len == ref_len
    jtable, jlen = jann._pack_lists(labels, nlist)
    np.testing.assert_array_equal(table, jtable)
    # and the slots cut from it
    for a, b in zip(pann._build_slots(labels, nlist), jann._build_slots(labels, nlist)):
        np.testing.assert_array_equal(a, b)


def test_no_compiler_takes_the_numpy_route(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert not native.native_available()
    assert native.build_lists(np.array([0, 1]), 2) is None
    assert native.arena_stats() == (0, 0)
    labels = np.array([1, 0, 1, 1])
    np.testing.assert_array_equal(pann._pack_lists(labels, 2)[0],
                                  pann._pack_lists_numpy(labels, 2)[0])


def test_failing_compiler_raises(monkeypatch, tmp_path):
    # g++ is there but the build fails: the binding raises, it does not
    # fall back, and leaves no partial file
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: "/bin/false")
    with pytest.raises(RaftError, match="g\\+\\+ failed"):
        native.native_available()
    assert not list(tmp_path.iterdir())


def test_concurrent_builds_rename_into_place(monkeypatch, tmp_path):
    # two processes building at once each compile to a file of their own
    # and rename it into place: the library's name never holds a partial file
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    seen = []
    real_run = subprocess.run

    def spy(cmd, **kw):
        seen.append(cmd[cmd.index("-o") + 1])
        return real_run(cmd, **kw)

    monkeypatch.setattr(subprocess, "run", spy)
    out = native._build(shutil.which("g++"))
    assert out == native.library_path() and out.exists()
    assert seen and seen[0].endswith(".tmp") and seen[0] != str(out)
