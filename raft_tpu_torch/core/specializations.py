"""Prebuilt specializations: the kernel libraries as a persistent cache, and
a warmup that builds them before first use.

Port of ``raft_tpu/core/specializations.py`` (reference: cpp/src/
pre-instantiates the hot templates into ``libraft_distance.so`` and
``libraft_nn.so``, cpp/CMakeLists.txt:122-156, so that consumers skip
template compilation).  The JAX package's compiled executable is the
port's built and loaded kernel library (:mod:`raft_tpu_torch.ops._build`):

- the **persistent cache** is the build directory: each library is
  compiled once by ``nvcc`` into a file named by the hash of its sources
  and flags, and every later process on the machine loads it with no
  compile.  :func:`enable_persistent_cache` points ``_build.BUILD_DIR``
  at a directory (default: ``build/raft_tpu_torch_kernels/`` at the root
  of the checkout); a library already loaded in this process stays
  loaded, one loaded afterwards comes from there;
- **warmup** (:func:`warmup`) builds all six kernels at once (one
  ``nvcc`` each, :func:`raft_tpu_torch.ops._build.build`), loads them,
  and runs each specialization once on the card, so that the first
  request pays no build.  Nothing is compiled per shape, so
  :func:`aot_compile` runs the function once on its examples and hands
  it back.

On a CPU device nothing is built or loaded: every kernel wrapper takes
its plain version there, and a warmup only runs the specializations.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.ops import _build

__all__ = ["enable_persistent_cache", "aot_compile", "default_specializations", "warmup",
           "Example"]

_DEFAULT_CACHE = _build.BUILD_DIR


class Example(NamedTuple):
    """The shape and dtype of one argument of a specialization (the JAX
    ``ShapeDtypeStruct``): :func:`aot_compile` draws it, seeded, on the
    device."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """Build and load the kernel libraries under ``path`` (the default
    build directory when None); returns the directory.  Libraries loaded
    in this process before the call stay loaded."""
    target = Path(path) if path is not None else _DEFAULT_CACHE
    target.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = target
    return str(target)


def _materialize(examples, dev: torch.device, seed: int = 0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for a in examples:
        if isinstance(a, Example):
            a = torch.rand(a.shape, generator=gen, device=dev, dtype=torch.float32).to(a.dtype)
        out.append(a)
    return out


def aot_compile(fn: Callable, *examples, device="cuda") -> Callable:
    """Run ``fn`` once on ``examples`` (tensors, or :class:`Example`
    shapes drawn on ``device``) and return it: its kernels are then built
    and loaded.  The returned callable carries the warm call's output as
    ``example_out`` and its seconds as ``seconds``.  Static configuration
    (k, metric, ...) is closed over in ``fn``."""
    dev = resolve_device(device)
    args = _materialize(examples, dev)
    t0 = time.perf_counter()
    out = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0

    def compiled(*a):
        return fn(*a)

    compiled.example_out = out
    compiled.seconds = seconds
    return compiled


# --------------------------------------------------------------------- #
# the hot configurations (the role of cpp/src/*/specializations lists)
# --------------------------------------------------------------------- #
def default_specializations(device="cuda") -> Dict[str, Tuple[Any, Tuple]]:
    """Name -> (fn, examples) for the configurations worth prebuilding: the
    README pairwise example and the bench pairwise shape (K5 for L1, the
    IEEE float32 product for the expanded metrics) and the fused kNN at
    65,536 x 128 (K1), on ``device``."""
    from raft_tpu_torch.distance import DistanceType, pairwise_distance
    from raft_tpu_torch.spatial.fused_l2_knn import fused_l2_knn

    def pw(metric):
        return lambda x, y: pairwise_distance(x, y, metric, device=device)

    readme = (Example((1024, 64)), Example((1024, 64)))
    bench = (Example((8192, 128)), Example((8192, 128)))
    return {
        "pairwise_l2sqrt_1k_64": (pw(DistanceType.L2SqrtExpanded), readme),
        "pairwise_l2_8k_128": (pw(DistanceType.L2Expanded), bench),
        "pairwise_cosine_8k_128": (pw(DistanceType.CosineExpanded), bench),
        "pairwise_l1_1k_64": (pw(DistanceType.L1), readme),
        "fused_l2_knn_100": (lambda ix, q: fused_l2_knn(ix, q, 100, device=device),
                             (Example((65536, 128)), Example((1024, 128)))),
    }


def warmup(names: Optional[Sequence[str]] = None, cache_dir: Optional[str] = None,
           device="cuda", report: Optional[Dict] = None) -> Dict[str, Callable]:
    """Build every kernel, load it, and run the named specializations (all
    by default); returns name -> the :func:`aot_compile` callable.

    ``cache_dir`` as in :func:`enable_persistent_cache` (None keeps the
    current build directory).  ``report={}`` is filled with
    ``build_s`` (each kernel's ``nvcc`` seconds, 0 where the cache held
    it), ``load_s`` (each library's load seconds, 0 where this process
    had it loaded), ``run_s`` (each specialization's warm call) and
    ``builds``/``loads`` (the libraries this warmup compiled and
    loaded).  On a CPU device no kernel is built or loaded."""
    dev = resolve_device(device)
    if cache_dir is not None:
        enable_persistent_cache(cache_dir)
    rep = report if report is not None else {}
    before = _build.stats()
    rep["build_s"], rep["load_s"] = {}, {}
    if dev.type == "cuda":
        rep["build_s"] = _build.build(_build.KERNELS)
        for name in _build.KERNELS:
            t0 = time.perf_counter()
            _build.load(name)
            rep["load_s"][name] = time.perf_counter() - t0
    registry = default_specializations(dev)
    out, rep["run_s"] = {}, {}
    for name in (names or registry):
        fn, examples = registry[name]
        out[name] = aot_compile(fn, *examples, device=dev)
        rep["run_s"][name] = out[name].seconds
    after = _build.stats()
    rep["builds"] = after["builds"] - before["builds"]
    rep["loads"] = after["loads"] - before["loads"]
    return out
