"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
under ``build/raft_tpu_torch_kernels/`` at the root of the checkout, and
loaded with :mod:`ctypes`.  A hash of the sources (the ``.cu`` and every
``.cuh`` it may include) and of the flags is part of the file name, so a
stale library is never loaded.  The build happens at first use; nothing
is compiled when a module is imported.  :func:`build` compiles several
sources at once, one ``nvcc`` process each, all started together.

Each compile runs with ``-Xptxas -v``; what the compiler printed (each
kernel's registers, spills and shared memory) is kept beside the
library, and :func:`ptxas_log` returns it.

Every C entry point takes its pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()``; :func:`check` raises on
a code other than 0.

The first :func:`load` of a library is serialised by a lock, so a
serving worker thread and a caller that reach it together build and load
it once.  :func:`stats` counts the libraries compiled and loaded in this
process; a serving process checks that the count stays still after
warmup.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

from raft_tpu_torch.core.error import RaftError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raft_tpu_torch_kernels"
KERNELS = ("knn_tile", "select_tile", "pairwise_tile", "nn_tile", "ivf_tile",
           "knn_twophase")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_stats = {"builds": 0, "loads": 0}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RaftError("nvcc not found: the CUDA kernels cannot be built",
                    collect_stack=False)


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, in parallel.

    Returns the seconds each compile took (0 for one already built).
    Raises :class:`RaftError` with the compiler's output if any fails;
    every ``nvcc`` started is waited for either way.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                seconds[name] = 0.0
                continue
            tmp = out.with_suffix(".%d.tmp" % os.getpid())
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT),
                           tmp, out, time.perf_counter())
    finally:
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            log = proc.communicate()[0].decode(errors="replace")
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append("%s:\n%s" % (name, log))
                tmp.unlink(missing_ok=True)
            else:
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)
                _stats["builds"] += 1
    if failed:
        raise RaftError("nvcc failed for " + "\n".join(failed),
                        collect_stack=False)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
                _stats["loads"] += 1
    return lib


def ptxas_log(name: str) -> str:
    """What the compiler printed when it built ``csrc/<name>.cu`` (built
    first if needed): ``ptxas info`` lines with each kernel's registers,
    spill stores and loads, and shared memory, and any warnings."""
    build([name])
    return library_path(name).with_suffix(".log").read_text()


def stats() -> Dict[str, int]:
    """``{"builds": n, "loads": n}``: libraries compiled and loaded by
    this process so far."""
    with _load_lock:
        return dict(_stats)


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RaftError("%s: CUDA error %d at launch" % (what, code),
                        collect_stack=False)
