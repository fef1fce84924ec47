"""Port parity of the tuning half: the candidate registry
(``raft_tpu_torch/core/tuning.py``) and the tuning-table rung of
``raft_tpu_torch/config.py``, against ``raft_tpu/core/tuning.py`` and
``tests/test_tuning.py``'s contract; ``select_impl`` through every
consumer against the JAX results; ``tools/torch_autotune.py`` and
``tools/torch_loadgen.py`` at tiny sizes on the CPU.

The port's candidates carry the port's names (``kernel``/``sort``/
``scan``) under the JAX knob names; the JAX names are refused.  The
resolution ladder is tested on ``spmv_impl`` where three values are
needed (the port's ``select_impl`` has two and an unset default)."""

import importlib
import importlib.util
import json
import os
import threading
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_knn_close
from raft_tpu.comms.host_comms import default_mesh as jdefault_mesh
from raft_tpu.core import tuning as jtuning
from raft_tpu.core.error import LogicError as JLogicError
from raft_tpu.mr import TilePool as JaxTilePool
from raft_tpu.spatial import ann as jann
from raft_tpu.spatial import ooc as jooc
from raft_tpu.spatial.mnmg_knn import mnmg_ivf_flat_search as jmnmg_ivf
from raft_tpu.spatial.mnmg_knn import shard_ivf_flat_index as jshard_ivf
from raft_tpu.spatial.select_k import select_k as jselect_k
from raft_tpu_torch import ANNService, config, ivf_flat_search
from raft_tpu_torch.comms import Mesh
from raft_tpu_torch.convert import ivf_flat_index_from_reference, ooc_ivf_flat_from_reference
from raft_tpu_torch.core import metrics, tuning
from raft_tpu_torch.core.error import LogicError, RaftError
from raft_tpu_torch.mr import TilePool
from raft_tpu_torch.spatial.mnmg_knn import mnmg_ivf_flat_search, shard_ivf_flat_index
from raft_tpu_torch.spatial.ooc import ooc_ivf_flat_search

pytestmark = pytest.mark.tuning

# the modules (the package re-exports functions of the same names)
psk = importlib.import_module("raft_tpu_torch.spatial.select_k")
pfk = importlib.import_module("raft_tpu_torch.spatial.fused_l2_knn")

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
K, DIM = 10, 16
RTOL, ATOL = 1e-5, 1e-4

# knobs of the JAX registry with no counterpart in the port, and why
# (raft_tpu_torch/core/tuning.py module doc)
NO_COUNTERPART = {
    "tile_merge": "selection networks of the TPU's 128-lane vector unit",
    "knn_tile_merge": "selection networks of the TPU's 128-lane vector unit",
    "knn_block_q": "K1's query tile is compiled in (knn_tile.cuh block_q(d))",
    "nn_block_n": "K4's index tile is compiled in (knn_tile.cuh kBN)",
    "pq_adc": "the one-hot ADC was removed from the port: the gather is its one ADC",
    "merge_select_impl": "K6's merge is pinned to the exact select (ops/knn_tile.py)",
}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.setattr(config, "_values", {})
    monkeypatch.setattr(config, "_table", None)
    monkeypatch.setattr(config, "_table_env_checked", True)
    monkeypatch.setattr(config, "_table_warned", set())
    for env, _, _ in config._KNOBS.values():
        monkeypatch.delenv(env, raising=False)
    monkeypatch.delenv(config.TUNING_TABLE_ENV, raising=False)
    yield
    config.clear_tuning_table()


SPMV_DIMS = {"rows": 4096, "nnz": 32768}
SPMV_CLS = tuning.shape_class(SPMV_DIMS)
SELECT_DIMS = {"n": 4096, "k": 16}
SELECT_CLS = tuning.shape_class(SELECT_DIMS)


def make_table(entries=None, fp=None):
    return {
        "version": 1,
        "fingerprint": fp or tuning.backend_fingerprint(),
        "entries": entries if entries is not None else [
            {"op": "csr_spmv", "knob": "spmv_impl", "shape_class": SPMV_CLS,
             "dtype": "float32", "winner": "sortscan", "margin": 2.0},
            {"op": "csr_spmv", "knob": "spmv_impl", "shape_class": "*", "dtype": "*",
             "winner": "cumsum"},
            {"op": "select_k", "knob": "select_impl", "shape_class": SELECT_CLS,
             "dtype": "float32", "winner": "sort"},
        ],
    }


def resolve_spmv(**kw):
    kw.setdefault("dtype", torch.float32)
    return tuning.resolve("spmv_impl", site="csr_spmv", **SPMV_DIMS, **kw)


def lookups(outcome, knob):
    fam = metrics.default_registry().get("raft_tpu_tuning_table_lookups_total")
    if fam is None:
        return 0.0
    return sum(s.value for labels, s in fam.series()
               if labels == {"outcome": outcome, "knob": knob})


def _load_tool(name):
    spec = importlib.util.spec_from_file_location("_" + name, ROOT / "tools" / (name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------- #
# parity with the JAX registry
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dims", [
    {}, {"n": 0}, {"n": 1}, {"n": 3, "k": 1}, {"n": 100000, "k": 100},
    {"n": 131072, "k": 128}, {"n": 8192, "k": 100}, {"n": 1000000, "k": 100, "d": 128},
    {"rows": 200000, "nnz": 2000000}, {"devices": 8, "n": 16384, "k": 100},
    {"n": 2097152, "k": 100, "d": 128, "x": None}, {"n": 5, "k": 6, "d": 7}])
def test_shape_class_matches_jax(dims):
    assert tuning.shape_class(dims) == jtuning.shape_class(dims)


@pytest.mark.parametrize("n", [2 ** i + j for i in range(1, 21, 3) for j in (-1, 0, 1)])
def test_shape_class_grid_matches_jax(n):
    for k in (1, 7, 10, 100, 129):
        assert tuning.shape_class({"n": n, "k": k}) == jtuning.shape_class({"n": n, "k": k})


def test_knob_set_is_jax_less_the_named_knobs():
    port = {s.knob for s in tuning.specs()}
    jax_knobs = {s.knob for s in jtuning.specs()}
    assert port == jax_knobs - set(NO_COUNTERPART)
    assert set(NO_COUNTERPART) <= jax_knobs
    for knob in port:
        ps, js = tuning.spec(knob), jtuning.spec(knob)
        assert (ps.op, ps.config_knob, ps.dims) == (js.op, js.config_knob, js.dims) or \
            knob == "knn_block_n", knob


def test_knob_spec_fields_and_names_match_jax():
    assert tuning.KnobSpec.__slots__ == jtuning.KnobSpec.__slots__
    assert set(tuning.__all__) == set(jtuning.__all__)


def test_shared_message_shape_matches_jax():
    with pytest.raises(LogicError) as ei:
        tuning.check("spmv_impl", "cusparse", site="SparseMatrix")
    with pytest.raises(JLogicError) as ej:
        jtuning.check("spmv_impl", "cusparse", site="SparseMatrix")
    assert str(ei.value).splitlines()[0] == str(ej.value).splitlines()[0]
    for frag in ("SparseMatrix", "spmv_impl", "cusparse", "segment", "cumsum", "sortscan",
                 "unknown impl"):
        assert frag in str(ei.value)


@pytest.mark.parametrize("knob,value", [
    ("select_impl", v) for v in ("topk", "approx", "chunked", "pallas")] + [
    ("fused_knn_impl", v) for v in ("xla", "pallas", "xla_fused")] + [
    ("ivf_scan_impl", v) for v in ("xla", "pallas", "pallas_bf16")] + [
    ("fused_nn_impl", "xla"), ("fused_nn_impl", "pallas")])
def test_jax_names_are_refused_not_mapped(knob, value):
    assert value in jtuning.candidates(knob)
    with pytest.raises(LogicError) as ei:
        tuning.check(knob, value, site="site", explicit=True)
    msg = str(ei.value).splitlines()[0]
    assert msg.startswith("site: %s=%r is illegal for this cell (legal: %s)"
                          % (knob, value, ", ".join(tuning.candidates(knob))))
    assert "not ported" in msg


def test_approx95_is_a_port_candidate_never_swept():
    # the JAX name is the port's own now: settable, legal on float keys,
    # refused on integer ones and by the sweep
    assert "approx95" in jtuning.candidates("select_impl")
    assert "approx95" in tuning.candidates("select_impl")
    assert tuning.check("select_impl", "approx95", explicit=True, k=100,
                        dtype=torch.float32) == "approx95"
    with pytest.raises(LogicError, match="float keys"):
        tuning.check("select_impl", "approx95", explicit=True, dtype=torch.int32)
    sweep = dict(tuning.legal_candidates("select_impl", purpose="sweep", device="cuda", k=10))
    assert "approximate" in sweep["approx95"]
    assert dict(tuning.legal_candidates("select_impl", device="cuda", k=10))["approx95"] is None


def test_arg_only_rule_matches_jax(monkeypatch):
    # the port registers no argument-only candidate (the JAX one, the
    # knn_tile_merge "skip" probe, has no counterpart): the rule is held on
    # a spec registered for the test
    monkeypatch.setitem(tuning._SPECS, "probe_knob",
                        tuning.KnobSpec("probe_op", "probe_knob", ("a", "b"), arg_only=("skip",)))
    assert tuning.check("probe_knob", "skip", explicit=True) == "skip"
    with pytest.raises(LogicError) as ei:
        tuning.check("probe_knob", "skip", site="fused_knn_tile")
    with pytest.raises(JLogicError) as ej:
        jtuning.check("knn_tile_merge", "skip", site="fused_knn_tile")
    assert str(ei.value).split(" — ")[1].splitlines()[0] == \
        str(ej.value).split(" — ")[1].splitlines()[0]


def test_no_sweep_rules():
    got = dict(tuning.legal_candidates("spmv_impl", purpose="sweep"))
    want = dict(jtuning.legal_candidates("spmv_impl", purpose="sweep"))
    assert got == want and got["cumsum"] is not None
    ivf = dict(tuning.legal_candidates("ivf_scan_impl", purpose="sweep", device="cuda",
                                       k=10, metric="l2"))
    assert ivf["kernel"] is None and ivf["scan"] is None and "bfloat16" in ivf["kernel_bf16"]
    assert tuning.check("ivf_scan_impl", "kernel_bf16", k=10) == "kernel_bf16"   # settable


def test_kernels_are_not_swept_off_the_card():
    for knob in ("select_impl", "fused_knn_impl", "ivf_scan_impl", "fused_nn_impl"):
        legal = dict(tuning.legal_candidates(knob, purpose="sweep", device="cpu", k=10))
        assert "test vehicle" in legal["kernel"], knob
        assert dict(tuning.legal_candidates(knob, device="cpu", k=10))["kernel"] is None


@pytest.mark.parametrize("knob,ctx,frag", [
    ("select_impl", {"k": 129}, "caps k at 128"),
    ("select_impl", {"k": 10, "dtype": torch.int32}, "stable sort"),
    ("fused_knn_impl", {"k": 129}, "caps k at 128"),
    ("fused_knn_impl", {"k": 10, "precision": "high"}, "precision"),
    ("ivf_scan_impl", {"k": 10, "metric": "ip"}, "L2 family"),
    ("fused_nn_impl", {"masked": True}, "plain float32"),
])
def test_kernel_legality(knob, ctx, frag):
    with pytest.raises(LogicError, match=frag):
        tuning.check(knob, "kernel", explicit=True, **ctx)


@pytest.mark.parametrize("knob", ["fused_knn_impl", "fused_nn_impl"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_kernel_takes_default_precision_and_narrow_inputs(knob, dtype):
    # K1 and K4 have a bfloat16 instance for precision="default", and take
    # float16 and bfloat16 inputs through a float32 copy
    for prec in ("highest", "default"):
        assert tuning.check(knob, "kernel", explicit=True, k=10, precision=prec, dtype=dtype,
                            device="cuda") == "kernel"
    with pytest.raises(LogicError):
        tuning.check(knob, "kernel", explicit=True, k=10, dtype=torch.float64)


def test_every_choices_knob_is_registered():
    for knob, (_, _, choices) in config._KNOBS.items():
        if choices is not None:
            assert tuning.candidates(knob) == choices, knob


def test_block_n_ladder_and_group_size():
    assert tuning.candidates("knn_block_n") == jtuning.candidates("knn_block_n")
    assert tuning.check("knn_block_n", "2048", d=128, k=100, device="cpu") == "2048"
    with pytest.raises(LogicError, match="knn_block_n"):
        tuning.check("knn_block_n", "768", explicit=True)
    with pytest.raises(LogicError, match="mnmg_group_size"):
        tuning.check("mnmg_group_size", 3, site="mnmg", explicit=True, axis_size=8)
    assert tuning.check("mnmg_group_size", 4, site="mnmg", explicit=True, axis_size=8) == 4


def test_fingerprint_off_the_card():
    fp = tuning.backend_fingerprint()
    assert fp == {"platform": "cpu", "device_kind": "cpu", "device_count": 1}
    h100 = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1}
    assert tuning.fingerprint_slug(h100) == jtuning.fingerprint_slug(h100) == \
        "gpu_nvidia-h100-80gb-hbm3_d1"


# --------------------------------------------------------------------- #
# the resolution ladder (tests/test_tuning.py:68-181, the port's values)
# --------------------------------------------------------------------- #
class TestResolutionLadder:
    def test_table_answers_when_unset(self):
        assert resolve_spmv() == "segment"                 # no table: default
        config.install_tuning_table(make_table())
        assert resolve_spmv() == "sortscan"                # the exact class
        assert tuning.resolve("spmv_impl", rows=7, nnz=9,
                              dtype=torch.float32) == "cumsum"   # the "*" rollup

    def test_env_beats_table(self, monkeypatch):
        config.install_tuning_table(make_table())
        monkeypatch.setenv("RAFT_TPU_SPMV_IMPL", "cumsum")
        assert resolve_spmv() == "cumsum"
        assert config.tuned("spmv_impl")[1] == "env"

    def test_configure_beats_table_and_reverts_to_it(self):
        config.install_tuning_table(make_table())
        config.configure(spmv_impl="segment")
        assert resolve_spmv() == "segment"
        config.configure(spmv_impl=None)
        assert resolve_spmv() == "sortscan"                # the table, not the default

    def test_override_beats_env_and_table(self, monkeypatch):
        config.install_tuning_table(make_table())
        monkeypatch.setenv("RAFT_TPU_SPMV_IMPL", "cumsum")
        with config.override(spmv_impl="segment"):
            assert resolve_spmv() == "segment"
        assert resolve_spmv() == "cumsum"

    def test_override_none_reverts_to_table_not_default(self):
        config.install_tuning_table(make_table())
        with config.override(spmv_impl="cumsum"):
            assert resolve_spmv() == "cumsum"
            with config.override(spmv_impl=None):
                assert resolve_spmv() == "sortscan"
            assert resolve_spmv() == "cumsum"
        assert resolve_spmv() == "sortscan"

    def test_suspend_tuning(self):
        config.install_tuning_table(make_table())
        with config.suspend_tuning():
            assert resolve_spmv() == "segment"
        assert resolve_spmv() == "sortscan"

    def test_suspend_is_thread_local(self):
        config.install_tuning_table(make_table())
        seen = []
        with config.suspend_tuning():
            t = threading.Thread(target=lambda: seen.append(resolve_spmv()))
            t.start()
            t.join()
            assert resolve_spmv() == "segment"
        assert seen == ["sortscan"]

    def test_unset_select_impl_resolves_to_the_dispatch(self):
        assert tuning.resolve("select_impl", n=4096, k=16, dtype=torch.float32) is None
        config.install_tuning_table(make_table())
        assert tuning.resolve("select_impl", n=4096, k=16, dtype=torch.float32) == "sort"

    def test_illegal_table_winner_falls_back_and_is_counted(self):
        config.install_tuning_table(make_table(entries=[
            {"op": "select_k", "knob": "select_impl", "shape_class": "*", "dtype": "*",
             "winner": "kernel"}]))
        before = lookups("discarded", "select_impl"), lookups("hit", "select_impl")
        # K2 caps k at 128: the table's winner is illegal at k=500
        assert tuning.resolve("select_impl", site="select_k", n=100000, k=500,
                              dtype=torch.float32) is None
        assert lookups("discarded", "select_impl") == before[0] + 1
        assert lookups("hit", "select_impl") == before[1] + 1
        assert tuning.resolve("select_impl", n=100000, k=50, dtype=torch.float32) == "kernel"

    def test_miss_is_counted(self):
        config.install_tuning_table(make_table(entries=[]))
        before = lookups("miss", "spmv_impl")
        assert resolve_spmv() == "segment"
        assert lookups("miss", "spmv_impl") == before + 1

    def test_serve_worker_thread_does_not_see_a_callers_override(self):
        seen = []
        with config.override(spmv_impl="cumsum"):
            t = threading.Thread(target=lambda: seen.append(resolve_spmv()))
            t.start()
            t.join()
        assert seen == ["segment"]


def test_select_k_dispatches_the_table_winner(monkeypatch):
    calls = []
    real = psk.select_tile
    monkeypatch.setattr(psk, "select_tile", lambda *a, **k: calls.append(1) or real(*a, **k))
    keys = np.random.default_rng(0).random((4, SELECT_DIMS["n"])).astype(np.float32)
    untuned = psk.select_k(keys, SELECT_DIMS["k"], device=CPU)
    assert calls                                         # K2's route (its plain version)
    calls.clear()
    config.install_tuning_table(make_table())
    tuned = psk.select_k(keys, SELECT_DIMS["k"], device=CPU)
    assert not calls                                     # the table's stable sort
    assert torch.equal(tuned[0], untuned[0]) and torch.equal(tuned[1], untuned[1])


def test_fused_l2_knn_dispatches_the_table_winner(monkeypatch):
    calls = []
    real = pfk.fused_knn_tile
    monkeypatch.setattr(pfk, "fused_knn_tile", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(1)
    x, q = rng.random((300, 8), np.float32), rng.random((5, 8), np.float32)
    untuned = pfk.fused_l2_knn(x, q, 4, device=CPU)
    assert not calls                                     # the scan on the CPU
    config.install_tuning_table(make_table(entries=[
        {"op": "fused_l2_knn", "knob": "fused_knn_impl", "shape_class": "*", "dtype": "*",
         "winner": "kernel"}]))
    tuned = pfk.fused_l2_knn(x, q, 4, device=CPU)
    assert calls
    assert_knn_close(untuned[0].numpy(), untuned[1].numpy(), tuned[0].numpy(),
                     tuned[1].numpy(), RTOL, 1e-5)


# --------------------------------------------------------------------- #
# the table's lifecycle
# --------------------------------------------------------------------- #
class TestTableLifecycle:
    def test_stale_fingerprint_ignored_with_one_warning(self, tmp_path):
        fp = dict(tuning.backend_fingerprint(), platform="gpu")
        path = tmp_path / "stale.json"
        path.write_text(json.dumps(make_table(fp=fp)))
        with pytest.warns(UserWarning, match="stale fingerprint"):
            assert config.load_tuning_table(str(path)) is False
        assert resolve_spmv() == "segment"
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert config.load_tuning_table(str(path)) is False

    def test_corrupt_tables_fail_loudly(self, tmp_path):
        bad = tmp_path / "bad.json"
        bad.write_text("{not json")
        with pytest.raises(LogicError, match="corrupt"):
            config.load_tuning_table(str(bad))
        wrong = tmp_path / "wrong.json"
        wrong.write_text(json.dumps({"version": 999, "fingerprint": {}, "entries": []}))
        with pytest.raises(LogicError, match="version"):
            config.load_tuning_table(str(wrong))
        missing = tmp_path / "missing.json"
        missing.write_text(json.dumps({"version": 1, "fingerprint": tuning.backend_fingerprint(),
                                       "entries": [{"op": "x"}]}))
        with pytest.raises(LogicError, match="entry 0"):
            config.load_tuning_table(str(missing))
        with pytest.raises(LogicError, match="fingerprint"):
            config.install_tuning_table({"version": 1, "fingerprint": {"platform": "cpu"},
                                         "entries": []})
        with pytest.raises(LogicError, match="unreadable"):
            config.load_tuning_table(str(tmp_path / "nope.json"))

    def test_env_path(self, tmp_path, monkeypatch):
        path = tmp_path / "t.json"
        path.write_text(json.dumps(make_table()))
        monkeypatch.setenv(config.TUNING_TABLE_ENV, str(path))
        monkeypatch.setattr(config, "_table_env_checked", False)
        assert resolve_spmv() == "sortscan"
        info = config.tuning_table_info()
        assert info["cells"] == 3 and info["knobs"] == {"spmv_impl": 2, "select_impl": 1}
        assert info["source"] == str(path)

    def test_env_auto_discovers_by_fingerprint(self, tmp_path, monkeypatch):
        other = dict(tuning.backend_fingerprint(), device_kind="another card")
        (tmp_path / "a_other.json").write_text(json.dumps(make_table(fp=other)))
        (tmp_path / "b_this.json").write_text(json.dumps(make_table()))
        monkeypatch.setattr(config, "_tables_dir", lambda: str(tmp_path))
        assert config.discover_tuning_table() == str(tmp_path / "b_this.json")
        monkeypatch.setenv(config.TUNING_TABLE_ENV, "auto")
        monkeypatch.setattr(config, "_table_env_checked", False)
        assert resolve_spmv() == "sortscan"

    @pytest.mark.parametrize("value", ["0", ""])
    def test_env_off(self, tmp_path, monkeypatch, value):
        monkeypatch.setenv(config.TUNING_TABLE_ENV, value)
        monkeypatch.setattr(config, "_table_env_checked", False)
        assert resolve_spmv() == "segment" and config.tuning_table_info() is None

    def test_roundtrip_through_a_file(self, tmp_path):
        path = tmp_path / "t.json"
        path.write_text(json.dumps(make_table()))
        assert config.load_tuning_table(str(path)) is True
        assert resolve_spmv() == "sortscan"
        config.clear_tuning_table()
        assert resolve_spmv() == "segment"

    def test_checked_in_h100_table_is_valid(self):
        """The table ``tools/torch_autotune.py`` wrote on the H100: it
        indexes, it is the card's (its fingerprint does not match the CPU,
        so it installs nothing here), and every swept entry carries its
        cell, timings, margin, parity outcome, card and power limit."""
        d = ROOT / "raft_tpu_torch" / "tuning"
        tables = sorted(d.glob("gpu_*.json"))
        assert tables, "no checked-in card table"
        for path in tables:
            doc = json.loads(path.read_text())
            t = config._index_table(doc, path.name)
            assert t["index"] and doc["fingerprint"]["platform"] == "gpu"
            assert path.stem == tuning.fingerprint_slug(doc["fingerprint"])
            swept = [e for e in doc["entries"] if e["shape_class"] != "*"]
            assert swept
            for e in swept:
                for key in ("cell", "timings_s", "margin", "parity", "card", "power_limit",
                            "winner", "default", "post_warmup_compiles"):
                    assert key in e, (path.name, e["cell"], key)
                assert e["winner"] in e["timings_s"], e["cell"]
                assert e["winner"] in tuning.candidates(e["knob"]), e["cell"]
                assert not e["parity"][e["winner"]].startswith("FAILED"), e["cell"]
                assert not any(e["post_warmup_compiles"].values()), e["cell"]
            with pytest.warns(UserWarning, match="stale fingerprint"):
                assert config.load_tuning_table(str(path)) is False


# --------------------------------------------------------------------- #
# describe() with the table rung
# --------------------------------------------------------------------- #
def test_describe_layers(monkeypatch):
    config.install_tuning_table(make_table(entries=make_table()["entries"] + [
        {"op": "fused_knn_twophase", "knob": "knn_block_n", "shape_class": "*", "dtype": "*",
         "winner": "2048"}]))
    monkeypatch.setenv("RAFT_TPU_FUSED_KNN_IMPL", "scan")
    config.configure(ivf_scan_impl="scan")
    with config.override(mnmg_merge="ring"):
        d = config.describe(layers=True)
        assert d["mnmg_merge"] == {"value": "ring", "layer": "override"}
        assert d["ivf_scan_impl"] == {"value": "scan", "layer": "configure"}
        assert d["fused_knn_impl"] == {"value": "scan", "layer": "env"}
        assert d["spmv_impl"] == {"value": "per-shape", "layer": "table"}
        assert d["knn_block_n"] == {"value": "2048", "layer": "table"}
        assert d["select_impl"] == {"value": "sort", "layer": "table"}
        assert "pq_adc" not in d and "merge_select_impl" not in d
    assert config.describe()["knn_block_n"] == "2048"
    with config.suspend_tuning():
        assert config.describe()["knn_block_n"] == "1024"
    with config.override(knn_block_n=None):
        assert config.describe(layers=True)["knn_block_n"]["layer"] == "table"


def test_configure_refuses_values_outside_the_choices():
    with pytest.raises(ValueError, match="select_impl"):
        config.configure(select_impl="approx")
    with pytest.raises(ValueError, match="knn_block_n"):
        with config.override(knn_block_n="768"):
            pass


# --------------------------------------------------------------------- #
# select_impl through the consumers, against the JAX results
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ivf_data():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((1500, DIM)).astype(np.float32)
    Q = rng.standard_normal((12, DIM)).astype(np.float32)
    jindex = jann.ivf_flat_build(jnp.asarray(X), jann.IVFFlatParams(nlist=24, nprobe=6))
    return X, Q, jindex, ivf_flat_index_from_reference(jindex, device=CPU)


def _both_routes(fn):
    """The answers of both select routes, bitwise equal to each other."""
    a, b = fn("kernel"), fn("sort")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    return a


def test_select_k_routes_match_jax():
    keys = np.random.default_rng(4).random((9, 700)).astype(np.float32)
    keys[:, 5] = keys[:, 6]                              # a tie: the smaller column wins
    for select_min in (True, False):
        got = _both_routes(lambda impl: psk.select_k(keys, 20, select_min=select_min,
                                                     impl=impl, device=CPU))
        want = jselect_k(jnp.asarray(keys), 20, select_min=select_min)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_ivf_flat_search_routes_match_jax(ivf_data):
    _, Q, jindex, pindex = ivf_data
    want = jann.ivf_flat_search(jindex, jnp.asarray(Q), K, nprobe=6, scan_impl="xla")
    for scan in ("kernel", "scan"):
        got = _both_routes(lambda impl: ivf_flat_search(pindex, Q, K, 6, scan_impl=scan,
                                                        select_impl=impl, device=CPU))
        assert_knn_close(np.asarray(want[0]), np.asarray(want[1]), got[0].numpy(),
                         got[1].numpy(), RTOL, ATOL)


def test_mnmg_ivf_routes_match_jax(ivf_data):
    _, Q, jindex, pindex = ivf_data
    sharded = shard_ivf_flat_index(pindex, Mesh([CPU] * 8, ("ranks",)), "ranks")
    want = jmnmg_ivf(jshard_ivf(jindex, jdefault_mesh(), "ranks"), jnp.asarray(Q), K, nprobe=6)
    got = _both_routes(lambda impl: mnmg_ivf_flat_search(sharded, Q, K, nprobe=6,
                                                         select_impl=impl))
    assert_knn_close(np.asarray(want[0]), np.asarray(want[1]), got[0].numpy(), got[1].numpy(),
                     RTOL, ATOL)


def test_ooc_routes_match_jax(ivf_data):
    _, Q, jindex, _ = ivf_data
    jo = jooc.ivf_flat_to_ooc(jindex)
    po = ooc_ivf_flat_from_reference(jo, device=CPU)

    def pool(name):
        return TilePool(4, 10 * 4 * (po.slot_bytes() + 4), name=name, device=CPU)

    want = jooc.ooc_ivf_flat_search(jo, jnp.asarray(Q), K, nprobe=6,
                                    pool=JaxTilePool(4, 10 * 4 * (jo.slot_bytes() + 4),
                                                     name="tuning-jax"))
    got = _both_routes(lambda impl: ooc_ivf_flat_search(po, Q, K, nprobe=6,
                                                        pool=pool("tuning-" + impl),
                                                        select_impl=impl, device=CPU))
    assert_knn_close(np.asarray(want[0]), np.asarray(want[1]), got[0].numpy(), got[1].numpy(),
                     RTOL, ATOL)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _serve(pindex, blocks, **kw):
    clock = _Clock()
    svc = ANNService(pindex, K, start=False, clock=clock, device=CPU, max_batch_rows=32,
                     bucket_rungs=(8, 32), max_wait_ms=10.0, nprobe=6, nprobe_ladder=(6,),
                     **kw)
    try:
        futs = [svc.submit(b) for b in blocks]
        clock.t += 0.5
        assert svc.worker.run_once()
        return [f.result(timeout=0) for f in futs]
    finally:
        svc.close(drain=False)


def test_ann_service_select_impl_routes_serve_alike(ivf_data):
    _, Q, jindex, pindex = ivf_data
    blocks = [Q[:5], Q[5:12]]
    kernel = _serve(pindex, blocks, select_impl="kernel")
    sort = _serve(pindex, blocks, select_impl="sort")
    want = jann.ivf_flat_search(jindex, jnp.asarray(Q), K, nprobe=6, scan_impl="xla")
    for a, b, rows in zip(kernel, sort, (slice(0, 5), slice(5, 12))):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert_knn_close(np.asarray(want[0])[rows], np.asarray(want[1])[rows], a[0].numpy(),
                         a[1].numpy(), RTOL, ATOL)


@pytest.mark.parametrize("bad,frag", [("chunked", "not ported"), ("bogus", "unknown impl")])
def test_ann_service_refuses_select_impl_at_construction(ivf_data, bad, frag):
    with pytest.raises(LogicError, match="ANNService: select_impl=%r is illegal for this cell "
                                         r"\(legal: kernel, sort, approx95\) — .*%s"
                                         % (bad, frag)):
        ANNService(ivf_data[3], K, start=False, device=CPU, select_impl=bad)


def test_ann_service_refuses_kernel_past_k2s_k():
    X = np.random.default_rng(5).standard_normal((600, 8)).astype(np.float32)
    pindex = ivf_flat_index_from_reference(
        jann.ivf_flat_build(jnp.asarray(X), jann.IVFFlatParams(nlist=4, nprobe=4)), device=CPU)
    with pytest.raises(LogicError, match="caps k at 128"):
        ANNService(pindex, 200, start=False, device=CPU, select_impl="kernel")


# --------------------------------------------------------------------- #
# the tools
# --------------------------------------------------------------------- #
def test_autotune_smoke_on_the_cpu_writes_a_valid_table(tmp_path, capsys):
    at = _load_tool("torch_autotune")
    out = tmp_path / "t.json"
    assert at.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    t = config._index_table(doc, str(out))
    assert t["index"] and doc["fingerprint"] == tuning.backend_fingerprint()
    exact = [e for e in doc["entries"] if e["shape_class"] != "*"]
    assert {e["knob"] for e in exact} == {s.knob for s in tuning.specs() if s.candidates}
    for e in exact:
        assert e["winner"] in e["timings_s"] and e["card"] == "cpu"
        assert all(n == 0 for n in e["post_warmup_compiles"].values()), e
        assert not any(p.startswith("FAILED") for p in e["parity"].values()), e
        assert e["margin"] >= 1.0 or e["reverted_from"] is not None, e
    # a "*" rollup only where every swept cell of the knob has its winner
    for e in doc["entries"]:
        if e["shape_class"] == "*":
            swept = {x["winner"] for x in exact if x["knob"] == e["knob"]}
            assert swept == {e["winner"]}, e
    assert config.load_tuning_table(str(out)) is True
    res = at.tuned_vs_default(doc, iters=1, device=CPU, log=lambda *a: None)
    assert res["cells"] and res["post_warmup_compiles"] == 0


def test_autotune_dry_run_and_parity_refusal(capsys):
    at = _load_tool("torch_autotune")
    assert at.main(["--dry-run", "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "select_k/select_impl" in out and "SWEEP" in out and "test vehicle" in out
    # a candidate whose answer differs from the default's is recorded and
    # never timed or persisted
    cell = at.Cell(lambda cand: (lambda: (torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int32)))
                   if cand == "segment" else
                   (lambda: (torch.ones(2, 3), torch.zeros(2, 3, dtype=torch.int32))),
                   {"rows": 4, "nnz": 8})
    rule, why = at.parity("spmv_impl", cell, cell.make("sortscan")(), cell.make("segment")())
    assert rule == "exact" and why


def test_autotune_asks_for_the_card(tmp_path, monkeypatch, capsys):
    # with no --device the tool measures the card: where CUDA is absent it
    # says so and writes nothing, rather than sweeping the CPU
    at = _load_tool("torch_autotune")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "t.json"
    assert at.main(["--smoke", "--out", str(out)]) == 2
    assert at.main(["--dry-run", "--smoke"]) == 2
    assert "--device cpu" in capsys.readouterr().err and not out.exists()
    with pytest.raises(RaftError, match="CUDA"):
        at.run_sweep(smoke=True, log=lambda *a: None)
    with pytest.raises(RaftError, match="CUDA"):
        at.tuned_vs_default({"entries": []}, log=lambda *a: None)


@pytest.mark.parametrize("winners,rollup", [(("sortscan", "sortscan"), "sortscan"),
                                            (("sortscan", "segment"), None)])
def test_autotune_rolls_up_only_winners_that_agree(monkeypatch, winners, rollup):
    at = _load_tool("torch_autotune")
    cells = [("csr_spmv", "spmv_impl", "a", {"rows": 1024, "nnz": 8192}, {}),
             ("csr_spmv", "spmv_impl", "b", {"rows": 65536, "nnz": 524288}, {})]
    monkeypatch.setattr(at, "catalog", lambda smoke: cells)
    won = dict(zip(("a", "b"), winners))

    def fake_cell(op, knob, name, dims, extra, **kw):
        return {"op": op, "knob": knob, "cell": name, "shape_class": tuning.shape_class(dims),
                "dtype": "float32", "dims": dims, "winner": won[name], "default": "segment",
                "margin": 1.5, "vs_default": 1.5, "timings_s": {}, "parity": {},
                "post_warmup_compiles": {}}
    monkeypatch.setattr(at, "sweep_cell", fake_cell)
    doc = at.run_sweep(device=CPU, log=lambda *a: None)
    star = [e for e in doc["entries"] if e["shape_class"] == "*"]
    if rollup is None:
        assert star == []
    else:
        assert [e["winner"] for e in star] == [rollup] and star[0]["rollup_of"] == ["a", "b"]


def test_jax_pq_adc_env_does_not_reach_the_port(monkeypatch):
    # the JAX package reads RAFT_TPU_PQ_ADC; the port has one ADC and no
    # such knob, so the JAX-only value changes nothing here
    from raft_tpu_torch.spatial.ann import IVFPQParams, ivf_pq_build, ivf_pq_search

    rng = np.random.default_rng(7)
    X = torch.from_numpy(rng.standard_normal((512, 8)).astype(np.float32))
    Q = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    index = ivf_pq_build(X, IVFPQParams(nlist=4, nprobe=4, M=2, n_bits=4), device=CPU)
    ref = ivf_pq_search(index, Q, 5, device=CPU)
    monkeypatch.setenv("RAFT_TPU_PQ_ADC", "onehot")
    got = ivf_pq_search(index, Q, 5, device=CPU)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert "pq_adc" not in config.describe()


def test_loadgen_closed_loop_tiny(capsys):
    lg = _load_tool("torch_loadgen")
    assert lg.main(["--service", "ann", "--device", "cpu", "--index-rows", "600", "--dim", "8",
                    "--k", "5", "--duration", "1.0", "--concurrency", "2", "--select-impl",
                    "sort", "--untuned", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    for key in ("qps", "query_qps", "p50_ms", "p95_ms", "p99_ms", "requests_ok", "errors",
                "recall_at_k", "post_warmup_compiles", "warmup_s", "buckets"):
        assert key in report, key
    assert report["requests_ok"] > 0 and report["errors"] == 0
    assert report["post_warmup_compiles"] == 0 and report["device"] == "cpu"
    assert report["select_impl"] == "sort" and report["tuning_table"] is None
    assert 0.0 < report["recall_at_k"] <= 1.0


def test_tools_follow_the_style_lint():
    spec = importlib.util.spec_from_file_location("_sc", ROOT / "ci" / "style_check.py")
    sc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sc)
    for name in ("torch_autotune.py", "torch_loadgen.py"):
        assert sc.check_file(os.path.join(str(ROOT), "tools", name)) == [], name
