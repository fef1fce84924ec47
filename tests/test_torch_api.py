"""Port parity of the public surface: every module of ``raft_tpu_torch``
that has a counterpart in ``raft_tpu`` offers the reference module's
public names, bar a named list (the comms, session, sharded-search and
replica modules of queue 1 item 6 among them); and the names this check found missing
(``distance``, ``get_workspace_size``, ``align_to``, ``align_down``,
``is_pow2``, ``log2``) agree with the JAX functions.

A module's public names are its ``__all__``, or, where the reference has
none, the functions and classes it defines.  The exceptions have no
counterpart on the card (JAX-compiler and TPU plumbing) or wait for a
later item of ``ROADMAP.md``'s queue 1."""

import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import utils as jutils
from raft_tpu.distance import pairwise as jpairwise
from raft_tpu.distance.distance_type import DistanceType as JD
from raft_tpu_torch import core as pcore
from raft_tpu_torch.distance import DistanceType, distance, get_workspace_size, pairwise_distance
from raft_tpu_torch.core import utils as putils

ROOT = Path(__file__).resolve().parent.parent

# no counterpart: JAX-compiler hooks, TPU tile plumbing, XLA twins of the
# Pallas kernels (ROADMAP.md, "No counterpart")
NO_COUNTERPART = {
    "profiled_jit", "compile_cache_stats", "reset_compile_cache_stats", "last_jit_fn",
    "debug_nans", "checkify_checks", "lazy_build_so", "is_tpu_backend", "as_pytree_fn",
    "set_default_precision", "gather_via_sortscan",
    # ops/*: the XLA twins, and the Pallas tiling of ops/knn_tile.py (the
    # port's tile geometry lives in the CUDA sources)
    "fused_ivf_scan_xla", "fused_knn_xla", "fused_knn_xla_oracle", "pad_with_norms",
    "resolve_blocks", "tile_geometry", "tile_local_topk", "topk_update",
    # comms/host_comms.py: the shard_map shim the JAX verbs compile through
    # (the port's verbs are eager torch ops over per-rank tensors)
    "shard_map",
    # core/inventory.py: the compile seam (the port's inventory is fed at the
    # kernel wrappers' launch seam, note_launch)
    "note_compiled",
}
# owed by queue 1: none since item 7b ported the tuning table
# (core/tuning.py, core/specializations.py and config's table half are
# checked by test_port_covers_the_reference_names like every other module)
OWED = set()


def _pairs():
    """(reference module, port module) for every reference file with a
    counterpart file in the port."""
    out = []
    for path in sorted((ROOT / "raft_tpu").rglob("*.py")):
        rel = path.relative_to(ROOT / "raft_tpu")
        if not (ROOT / "raft_tpu_torch" / rel).exists():
            continue
        parts = rel.with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(("raft_tpu",) + parts))
    return out


def _public(mod, defined_only):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    if defined_only:
        return {n for n, o in vars(mod).items() if not n.startswith("_")
                and callable(o) and getattr(o, "__module__", None) == mod.__name__}
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("ref_name", _pairs())
def test_port_covers_the_reference_names(ref_name):
    ref = importlib.import_module(ref_name)
    port = importlib.import_module("raft_tpu_torch" + ref_name[len("raft_tpu"):])
    missing = _public(ref, defined_only=True) - _public(port, defined_only=False)
    assert not missing - NO_COUNTERPART - OWED, sorted(missing - NO_COUNTERPART - OWED)


def test_the_exception_lists_name_reference_names():
    """Every excepted name exists in the reference (a stale entry would
    hide nothing and mislead the reader)."""
    seen = set()
    for ref_name in _pairs():
        ref = importlib.import_module(ref_name)
        seen |= _public(ref, defined_only=True)
    for name in ("profiler", "native", "debug", "utils"):
        seen |= set(vars(importlib.import_module("raft_tpu.core." + name)))
    assert (NO_COUNTERPART | OWED) <= seen, sorted((NO_COUNTERPART | OWED) - seen)


# --------------------------------------------------------------------- #
# the repaired names against the JAX functions
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("v,a", [(0, 4), (1, 4), (7, 4), (8, 4), (9, 8), (129, 128), (5, 1)])
def test_align_matches_jax(v, a):
    assert putils.align_to(v, a) == jutils.align_to(v, a) == pcore.align_to(v, a)
    assert putils.align_down(v, a) == jutils.align_down(v, a) == pcore.align_down(v, a)


@pytest.mark.parametrize("v", [1, 2, 3, 4, 6, 8, 1023, 1024, 2**31, 2**31 + 1])
def test_pow2_helpers_match_jax(v):
    assert pcore.is_pow2(v) == jutils.is_pow2(v)
    assert pcore.log2(v) == jutils.log2(v)


def test_pow2_edge_cases():
    assert not pcore.is_pow2(0) and not pcore.is_pow2(-4)
    from raft_tpu_torch.core.error import LogicError

    with pytest.raises(LogicError, match="positive"):
        pcore.log2(0)


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                                    DistanceType.CosineExpanded, DistanceType.InnerProduct,
                                    DistanceType.L1, DistanceType.Linf])
def test_distance_matches_jax(metric):
    rng = np.random.default_rng(int(metric))
    x = rng.random((9, 5), dtype=np.float32)
    y = rng.random((7, 5), dtype=np.float32)
    got = distance(x, y, metric, device="cpu")
    want = jpairwise.distance(jnp.asarray(x), jnp.asarray(y), JD(int(metric)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, pairwise_distance(x, y, metric, device="cpu"))


@pytest.mark.parametrize("metric", list(DistanceType))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_get_workspace_size_matches_jax(metric, dtype):
    x, y = np.zeros((11, 3), dtype), np.zeros((4, 3), dtype)
    want = jpairwise.get_workspace_size(x, y, JD(int(metric)))
    assert get_workspace_size(x, y, metric) == want
    assert get_workspace_size(torch.from_numpy(x), torch.from_numpy(y), metric) == want
