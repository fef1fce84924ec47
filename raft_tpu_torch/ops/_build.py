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

``phases=True`` (the functions below take it) names the phase-timed
build of a tile kernel's source (:data:`PHASE_KERNELS`): the same
sources compiled with ``-DRAFT_TPU_KERNEL_PHASES`` into a library of its
own (``<name>-phases-<hash>.so``), whose entry points take the counter
buffer as their last argument (``csrc/knn_tile.cuh``,
:func:`raft_tpu_torch.core.tracing.kernel_phases`).  It is built at its
first use, like any other.

Every C entry point takes its pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()``; :func:`check` raises on
a code other than 0.  :func:`entry` binds an entry point once per
process (argument and result types set under the lock) and hands the
same function back after.

:func:`launch` is the one seam between the kernel wrappers of
:mod:`raft_tpu_torch.ops` and their launchers (``<name>_launch``): it
binds the launcher, takes the phase-timed build where
:func:`raft_tpu_torch.core.tracing.kernel_phases` asks for it, launches
on the device's current stream, raises on an error code, and counts the
launch in the cost inventory (:mod:`raft_tpu_torch.core.inventory`),
which is the port's one count of kernel launches.

The first :func:`load` of a library is serialised by a lock, so a
serving worker thread and a caller that reach it together build and load
it once.  :func:`stats` counts the libraries compiled and loaded in this
process; a serving process checks that the count stays still after
warmup.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

from raft_tpu_torch.core import inventory, tracing
from raft_tpu_torch.core.error import RaftError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raft_tpu_torch_kernels"
KERNELS = ("knn_tile", "select_tile", "pairwise_tile", "nn_tile", "ivf_tile",
           "knn_twophase", "pq_scan", "pq_scan_wide")
# -split-compile=0 optimises a file's functions on all the host's
# threads: K5 instantiates its unrolled tile 32 times (8 metrics, two
# staging paths, with and without the epilog), and its build is the
# longest of the six
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
              "-split-compile=0")

# the sources that hold the fused tile kernel, and the define of its
# phase-timed build
PHASE_KERNELS = ("knn_tile", "ivf_tile", "nn_tile", "knn_twophase")
PHASE_DEFINE = "-DRAFT_TPU_KERNEL_PHASES"

_loaded: Dict[tuple, ctypes.CDLL] = {}
_entries: Dict[tuple, object] = {}
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


def _flags(name: str, phases: bool) -> tuple:
    if not phases:
        return NVCC_FLAGS
    if name not in PHASE_KERNELS:
        raise RaftError("%s has no phase-timed build (only %s)" % (name, ", ".join(PHASE_KERNELS)),
                        collect_stack=False)
    return NVCC_FLAGS + (PHASE_DEFINE,)


def library_path(name: str, phases: bool = False) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (its
    phase-timed build with ``phases``)."""
    h = hashlib.sha256(" ".join(_flags(name, phases)).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}{'-phases' if phases else ''}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS, phases: bool = False) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, in parallel
    (their phase-timed builds with ``phases``).

    Returns the seconds each compile took (0 for one already built).
    Raises :class:`RaftError` with the compiler's output if any fails;
    every ``nvcc`` started is waited for either way.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    try:
        for name in names:
            out = library_path(name, phases)
            if out.exists():
                seconds[name] = 0.0
                continue
            tmp = out.with_suffix(".%d.tmp" % os.getpid())
            cmd = [_nvcc(), *_flags(name, phases), "-o", str(tmp), str(CSRC / f"{name}.cu")]
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


def load(name: str, phases: bool = False) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (its phase-timed build
    with ``phases``), built first if needed."""
    lib = _loaded.get((name, phases))
    if lib is None:
        with _load_lock:
            lib = _loaded.get((name, phases))
            if lib is None:
                build([name], phases)
                lib = ctypes.CDLL(str(library_path(name, phases)))
                _loaded[(name, phases)] = lib
                _stats["loads"] += 1
    return lib


def entry(name: str, symbol: str, argtypes: Iterable, restype, phases: bool = False):
    """The C function ``symbol`` of ``csrc/<name>.cu`` with its argument
    and result types set, bound once per process (the library is built
    and loaded first if needed).  With ``phases``, the function of the
    phase-timed build, which takes one more pointer, the counter buffer,
    after ``argtypes``."""
    key = (name, symbol, phases)
    fn = _entries.get(key)
    if fn is None:
        lib = load(name, phases)
        with _load_lock:
            fn = _entries.get(key)
            if fn is None:
                fn = getattr(lib, symbol)
                fn.argtypes = list(argtypes) + ([ctypes.c_void_p] if phases else [])
                fn.restype = restype
                _entries[key] = fn
    return fn


def ptxas_log(name: str, phases: bool = False) -> str:
    """What the compiler printed when it built ``csrc/<name>.cu`` (its
    phase-timed build with ``phases``; built first if needed): ``ptxas
    info`` lines with each kernel's registers, spill stores and loads,
    and shared memory, and any warnings."""
    build([name], phases)
    return library_path(name, phases).with_suffix(".log").read_text()


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


def launch(name: str, device: torch.device, args: Sequence, what: str, key,
           costs: Callable, kernel: Optional[str] = None) -> None:
    """Launch the kernel of ``csrc/<name>.cu`` (its entry point
    ``<kernel>_launch``, ``kernel`` being ``name`` unless the library
    holds more than one) on ``device``'s current stream.

    ``args`` are the entry point's arguments before the stream: a tensor
    passes its device pointer (``c_void_p``), a float a ``c_float``, an
    int a ``c_int``.  While :func:`raft_tpu_torch.core.tracing.kernel_phases`
    is open on this thread, a kernel of :data:`PHASE_KERNELS` takes its
    phase-timed build, the counter buffer after the stream.  A code other
    than 0 raises, naming ``what``; a launch that returns 0 is counted in
    the cost inventory as ``kernel`` at shape ``key``, ``costs()`` giving
    its ``(flops, bytes, footprint_bytes)`` at a new key
    (:func:`raft_tpu_torch.core.inventory.count_launch`)."""
    kernel = kernel or name
    timed = tracing.phase_launch(device) if name in PHASE_KERNELS else None
    # lazy: :func:`entry` reads the types only where it binds the entry point
    argtypes = itertools.chain((ctypes.c_void_p if isinstance(a, torch.Tensor) else
                                ctypes.c_float if isinstance(a, float) else ctypes.c_int
                                for a in args), [ctypes.c_void_p])
    fn = entry(name, kernel + "_launch", argtypes, ctypes.c_int, timed is not None)
    values = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        values.append(torch.cuda.current_stream().cuda_stream)
        code = fn(*values) if timed is None else timed.run(fn, *values)
    check(code, what)
    inventory.count_launch(kernel, key, costs)
