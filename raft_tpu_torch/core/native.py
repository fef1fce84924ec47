"""ctypes binding of the native host runtime, ``cpp/src/host_runtime.cpp``.

Port of ``raft_tpu/core/native.py``.  The C++ side exports a plain C ABI
(inverted-list packing, ball-cover group packing, the union-find
dendrogram and its flat cut, and an aligned host arena) and uses no
device, so the port builds the same source unchanged.  It compiles it
with ``g++ -O3 -std=c++17 -shared -fPIC`` at first use into
``build/raft_tpu_torch_host/`` at the root of the checkout (never into
``cpp/build/``, which is the JAX package's).  A hash of the source, the
headers of ``cpp/include/raft_tpu`` and the flags is part of the file
name, so a stale library is never loaded, and the compile writes a file
of its own and renames it into place, so that two processes starting
together never load a half-written library.

The wrappers return None where the native layer is not there, and only
then: the callers then take their numpy route.  That happens only on a
machine without ``g++``: where ``g++`` exists and the build or the load
fails, :func:`native_available` raises with the compiler's output
instead of falling back, and a call the library refuses (a label or an
edge off its range, an impossible cut) raises :class:`RaftError`.  So
where ``g++`` exists every input takes the one native route.
:func:`native_available` says which route runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from raft_tpu_torch.core.error import RaftError

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "cpp" / "src" / "host_runtime.cpp"
INCLUDE = _ROOT / "cpp" / "include"
BUILD_DIR = _ROOT / "build" / "raft_tpu_torch_host"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in [SRC] + sorted((INCLUDE / "raft_tpu").glob("*.hpp")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libraft_tpu_host-{h.hexdigest()[:16]}.so"


def _build(compiler: str) -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".%d.tmp" % os.getpid())
    cmd = [compiler, *FLAGS, "-I", str(INCLUDE), str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RaftError("g++ failed to build %s:\n%s" % (SRC, proc.stderr),
                        collect_stack=False)
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    lib.rt_version.restype = ctypes.c_char_p
    lib.rt_version.argtypes = []
    lib.rt_arena_total.restype = ctypes.c_size_t
    lib.rt_arena_total.argtypes = []
    lib.rt_arena_in_use.restype = ctypes.c_size_t
    lib.rt_arena_in_use.argtypes = []
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.rt_build_dendrogram.restype = ctypes.c_int
    lib.rt_build_dendrogram.argtypes = [i64p, i64p, f64p, ctypes.c_int64, i64p, f64p, i64p]
    lib.rt_extract_clusters.restype = ctypes.c_int
    lib.rt_extract_clusters.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.rt_build_lists.restype = ctypes.c_int
    lib.rt_build_lists.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.rt_pack_groups.restype = ctypes.c_int
    lib.rt_pack_groups.argtypes = [i64p, f64p, ctypes.c_int64, ctypes.c_int64, i64p,
                                   ctypes.c_int64, f64p]


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None where there is no
    ``g++``.  A build or load that fails raises each time it is asked."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        compiler = shutil.which("g++")
        if compiler is None:
            _tried = True
            return None
        lib = ctypes.CDLL(str(_build(compiler)))
        _bind(lib)
        _lib = lib
        return lib


def _check(rc: int, call: str) -> None:
    if rc != 0:
        raise RaftError("%s refused its input (return code %d)" % (call, rc),
                        collect_stack=False)


def native_available() -> bool:
    """True when the native library is loaded (the route every wrapper
    takes); False only on a machine without ``g++``."""
    return _load() is not None


def native_version() -> Optional[str]:
    lib = _load()
    return lib.rt_version().decode() if lib else None


def arena_stats() -> Tuple[int, int]:
    """(total_bytes, in_use_bytes) of the native host arena; (0, 0)
    without the native layer."""
    lib = _load()
    if lib is None:
        return (0, 0)
    return int(lib.rt_arena_total()), int(lib.rt_arena_in_use())


def build_dendrogram(src, dst, weights, m: int
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Union-find dendrogram of m - 1 MST edges: (children (m - 1, 2),
    merge distances, merged sizes); None without the native layer.
    Raises for m < 2 or an edge off [0, m)."""
    lib = _load()
    if lib is None:
        return None
    if m < 2:
        raise RaftError("build_dendrogram: need m >= 2 (m=%d)" % m, collect_stack=False)
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    w = np.ascontiguousarray(weights, np.float64)
    children = np.empty(2 * (m - 1), np.int64)
    delta = np.empty(m - 1, np.float64)
    sizes = np.empty(m - 1, np.int64)
    _check(lib.rt_build_dendrogram(src, dst, w, m, children, delta, sizes),
           "rt_build_dendrogram")
    return children.reshape(m - 1, 2), delta, sizes


def extract_clusters(children, n_clusters: int, n_leaves: int) -> Optional[np.ndarray]:
    """Flat labels of a dendrogram cut into ``n_clusters``; None without
    the native layer.  Raises for an impossible cut."""
    lib = _load()
    if lib is None:
        return None
    ch = np.ascontiguousarray(np.asarray(children).reshape(-1), np.int64)
    labels = np.empty(n_leaves, np.int64)
    _check(lib.rt_extract_clusters(ch, n_clusters, n_leaves, labels), "rt_extract_clusters")
    return labels


def build_lists(labels, nlist: int) -> Optional[Tuple[np.ndarray, int]]:
    """(nlist, max_len) table of row ids per list, -1 padded, and
    max_len; None without the native layer.  Raises for a label off
    [0, nlist)."""
    lib = _load()
    if lib is None:
        return None
    lab = np.ascontiguousarray(labels, np.int64)
    m = len(lab)
    ml = ctypes.c_int64(0)
    _check(lib.rt_build_lists(lab, m, nlist, None, 0, ctypes.byref(ml)), "rt_build_lists")
    max_len = max(int(ml.value), 1)
    table = np.empty(nlist * max_len, np.int64)
    _check(lib.rt_build_lists(lab, m, nlist, table.ctypes.data_as(ctypes.c_void_p), max_len,
                              None), "rt_build_lists")
    return table.reshape(nlist, max_len), max_len


def pack_groups(owner, dist, L: int, gmax: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Ball-cover groups: (L, gmax) members of each landmark by
    descending owner distance, -1 padded, and each group's radius; None
    without the native layer.  Raises for an owner off [0, L)."""
    lib = _load()
    if lib is None:
        return None
    o = np.ascontiguousarray(owner, np.int64)
    d = np.ascontiguousarray(dist, np.float64)
    groups = np.empty(L * gmax, np.int64)
    radius = np.empty(L, np.float64)
    _check(lib.rt_pack_groups(o, d, len(o), L, groups, gmax, radius), "rt_pack_groups")
    return groups.reshape(L, gmax), radius
