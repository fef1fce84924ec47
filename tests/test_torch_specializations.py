"""Port parity of ``raft_tpu_torch/core/specializations.py`` against
``raft_tpu/core/specializations.py``: the persistent cache is the kernel
build directory, and a warmup on the CPU runs the specializations
(nothing to build or load there) with the answers of the direct calls."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import specializations as jspec
from raft_tpu.distance import DistanceType as JD
from raft_tpu.distance import pairwise_distance as jpairwise
from raft_tpu_torch.core import specializations as spec
from raft_tpu_torch.distance import DistanceType, pairwise_distance
from raft_tpu_torch.ops import _build
from raft_tpu_torch.spatial.fused_l2_knn import fused_l2_knn

pytestmark = pytest.mark.tuning

CPU = "cpu"


@pytest.fixture
def build_dir(monkeypatch):
    # every test leaves the build directory as it found it
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    return _build.BUILD_DIR


def test_public_names_cover_the_jax_module():
    names = {"enable_persistent_cache", "aot_compile", "default_specializations", "warmup"}
    assert names <= set(spec.__all__)
    assert names <= {n for n in dir(jspec) if not n.startswith("_")}


def test_specialization_names_match_jax():
    assert set(spec.default_specializations(CPU)) == {
        "pairwise_l2sqrt_1k_64", "pairwise_l2_8k_128", "pairwise_cosine_8k_128",
        "pairwise_l1_1k_64", "fused_l2_knn_100"}
    # the JAX registry builds jax.jit programs: compare names, not programs
    import raft_tpu.core.specializations as j

    src = open(j.__file__).read()
    for name in spec.default_specializations(CPU):
        assert '"%s"' % name in src, name


def test_enable_persistent_cache_points_the_build_dir(tmp_path, build_dir):
    target = tmp_path / "cache"
    assert spec.enable_persistent_cache(str(target)) == str(target)
    assert _build.BUILD_DIR == target and target.is_dir()
    assert _build.library_path("knn_tile").parent == target
    assert spec.enable_persistent_cache() == str(build_dir)
    assert _build.BUILD_DIR == build_dir


def test_warmup_on_the_cpu_equals_the_direct_calls(tmp_path, build_dir):
    names = ["pairwise_l2sqrt_1k_64", "pairwise_l1_1k_64", "fused_l2_knn_100"]
    report = {}
    before = _build.stats()
    out = spec.warmup(names, cache_dir=str(tmp_path / "c"), device=CPU, report=report)
    assert set(out) == set(names) and _build.BUILD_DIR == tmp_path / "c"
    assert report["build_s"] == {} and report["load_s"] == {}        # nothing built on the CPU
    assert report["builds"] == report["loads"] == 0 and _build.stats() == before
    assert set(report["run_s"]) == set(names)
    registry = spec.default_specializations(CPU)
    for name in names:
        fn, examples = registry[name]
        args = spec._materialize(examples, torch.device(CPU))
        got = out[name].example_out
        want = fn(*args)
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                assert torch.equal(g, w), name
        else:
            assert torch.equal(got, want), name
        # the returned callable is the function
        again = out[name](*args)
        assert torch.equal(again[0] if isinstance(again, tuple) else again,
                           want[0] if isinstance(want, tuple) else want)


def test_pairwise_specialization_matches_jax():
    fn, examples = spec.default_specializations(CPU)["pairwise_l1_1k_64"]
    x, y = spec._materialize(examples, torch.device(CPU))
    got = spec.aot_compile(fn, x, y, device=CPU)
    want = jpairwise(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), JD.L1)
    np.testing.assert_allclose(got.example_out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    assert torch.equal(got(x, y), pairwise_distance(x, y, DistanceType.L1, device=CPU))


def test_aot_compile_takes_tensors_and_examples():
    x = torch.rand(40, 8)
    f = spec.aot_compile(lambda a, b: fused_l2_knn(a, b, 3, device=CPU), x,
                         spec.Example((5, 8)), device=CPU)
    assert f.example_out[0].shape == (5, 3) and f.seconds >= 0.0
    q = torch.rand(2, 8)
    assert torch.equal(f(x, q)[1], fused_l2_knn(x, q, 3, device=CPU)[1])


def test_warmup_asks_for_cuda_by_default(build_dir, monkeypatch):
    from raft_tpu_torch.core.error import RaftError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RaftError, match="CUDA"):
        spec.warmup(["pairwise_l1_1k_64"])
