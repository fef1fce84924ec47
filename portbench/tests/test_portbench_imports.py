"""No run loads JAX or the JAX package, and no run reports without a card
or without the program."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT


def test_top_level_names_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "raft_tpu",
             "raft_tpu.ops.knn_tile", "raft_tpu_torch", "raft_tpu_torch.ops", "jaxtyping",
             "raft_tpu_extra"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "raft_tpu",
        "raft_tpu.ops.knn_tile"]


def test_a_run_loads_no_jax():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from portbench import harness\nfrom portbench.tests import tiny\n"
            "for cell in ('sift1m_ivfflat.batch10k', 'sift1m_bruteforce.batch10k'):\n"
            "    harness.run_cell(tiny.spec(cell), 5, 0.3, True, 'cpu')\n"
            "print(json.dumps(harness.forbidden_modules(sys.modules)))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "sift1m_bruteforce.batch10k", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
