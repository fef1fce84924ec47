"""Kernel cost inventory: per-(kernel, shape) operations, bytes, footprint
and launches.

Port of ``raft_tpu/core/inventory.py``.  The JAX inventory reads the
compiler's ``cost_analysis()`` and ``memory_analysis()`` at
``profiled_jit``'s compile seam; the port has no compiler seam, and its
counterpart is the kernel wrappers' launch seam.  Each wrapper in
:mod:`raft_tpu_torch.ops` (K1 and K6 ``knn_tile.py``, K2
``select_tile.py``, K3 ``ivf_tile.py``, K4 ``nn_tile.py``, K5
``pairwise_tile.py``) calls :func:`count_launch` at every launch on the
card: the first launch of a ``(kernel, shape-key)`` records its cost,
and later ones add to its ``launches``.  The operations and bytes are
the analytic counts of :mod:`raft_tpu_torch.ops.cost`, the same that
``chip_smoke.py``'s bounds divide by the card's peaks, so the inventory
and the kernel table cannot disagree.  The footprint is the arguments,
the outputs and the scratch: K2's scratch is its wide route's buffer
(``select_tile._scratch_bytes``), K1's and K6's a block's shared memory
(``knn_tile.smem_bytes``); the others take none.  ``code_bytes`` is 0:
a kernel's code lives in its library, not in a program.

A CPU tensor takes a kernel's plain version and records nothing.  After
``warmup()`` every shape a service launches is known, so the inventory
is the serving working set.

Metrics (labels ``fn`` = the kernel, ``entry`` = a short stable hash of
the shape key, the detail in :func:`snapshot`), as the JAX module names
them:

- ``raft_tpu_program_flops``      — the analytic operation count
- ``raft_tpu_program_bytes``      — the analytic bytes moved
- ``raft_tpu_program_hbm_bytes``  — argument + output + scratch bytes
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

from raft_tpu_torch.core import metrics as _metrics

__all__ = ["note_launch", "count_launch", "footprint", "snapshot", "summary", "reset",
           "entry_count"]

_lock = threading.Lock()
# kernel -> {key_repr: entry dict}
_entries: Dict[str, Dict[str, dict]] = {}


def _slug(key_repr: str) -> str:
    """Short stable id for one (kernel, shape) entry: the ``entry`` label."""
    return hashlib.sha1(key_repr.encode("utf-8")).hexdigest()[:10]


def note_launch(kernel: str, key, flops: float = 0.0, bytes: float = 0.0,
                footprint_bytes: Sequence[float] = (0.0, 0.0, 0.0)) -> dict:
    """Count one launch of ``kernel`` at shape ``key``.

    The first launch of a key records ``flops`` and ``bytes`` (the
    analytic counts) and ``footprint_bytes`` = (arguments, outputs,
    scratch) and publishes the gauges; later launches add one to the
    entry's ``launches`` and ignore the counts.  Returns a copy of the
    entry."""
    key_repr = repr(key)
    with _lock:
        keys = _entries.setdefault(kernel, {})
        entry = keys.get(key_repr)
        if entry is not None:
            entry["launches"] += 1
            return dict(entry)
        arg_b, out_b, tmp_b = (float(b) for b in footprint_bytes)
        entry = keys[key_repr] = {
            "entry": _slug(key_repr),
            "flops": float(flops),
            "bytes_accessed": float(bytes),
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": tmp_b,
            "code_bytes": 0.0,
            "hbm_bytes": arg_b + out_b + tmp_b,
            "launches": 1,
        }
        out = dict(entry)
    reg = _metrics.default_registry()
    for mname, val, help in (
            ("raft_tpu_program_flops", out["flops"],
             "analytic operation count per kernel shape"),
            ("raft_tpu_program_bytes", out["bytes_accessed"],
             "analytic bytes moved per kernel shape"),
            ("raft_tpu_program_hbm_bytes", out["hbm_bytes"],
             "argument+output+scratch footprint per kernel shape")):
        reg.gauge(mname, help=help, labels=("fn", "entry")).labels(
            fn=kernel, entry=out["entry"]).set(val)
    return out


def count_launch(kernel: str, key,
                 costs: Callable[[], Tuple[float, float, Sequence[float]]]) -> None:
    """The wrappers' seam: :func:`note_launch`, with ``costs()`` (returning
    ``(flops, bytes, footprint_bytes)``) evaluated only for a new key, so
    a count that reads the device runs once a shape."""
    with _lock:
        seen = repr(key) in _entries.get(kernel, {})
    if seen:
        note_launch(kernel, key)
    else:
        note_launch(kernel, key, *costs())


def snapshot() -> Dict[str, Dict[str, dict]]:
    """Plain-dict copy: ``{kernel: {key_repr: entry}}`` (every entry also
    carries its short ``entry`` slug, the metric-label join key)."""
    with _lock:
        return {fn: {k: dict(e) for k, e in keys.items()}
                for fn, keys in _entries.items()}


def entry_count() -> int:
    with _lock:
        return sum(len(keys) for keys in _entries.values())


def summary() -> dict:
    """Per-kernel rollup and the capacity line, as the JAX module's:
    shape counts, the largest single-shape cost, the summed footprint;
    each kernel also sums its ``launches``."""
    snap = snapshot()
    per_fn = {}
    total_hbm = 0.0
    total_programs = 0
    for fn, keys in sorted(snap.items()):
        flops = [e["flops"] for e in keys.values()]
        hbm = sum(e["hbm_bytes"] for e in keys.values())
        per_fn[fn] = {
            "programs": len(keys),
            "max_flops": max(flops) if flops else 0.0,
            "total_flops": sum(flops),
            "total_bytes_accessed": sum(e["bytes_accessed"] for e in keys.values()),
            "total_hbm_bytes": hbm,
            "launches": sum(e["launches"] for e in keys.values()),
        }
        total_hbm += hbm
        total_programs += len(keys)
    return {"programs": total_programs, "total_hbm_bytes": total_hbm, "per_fn": per_fn}


def reset() -> None:
    """Drop every entry (test isolation).  Published gauges stay in the
    registry until its own reset."""
    with _lock:
        _entries.clear()


def footprint(args: Sequence, outs: Sequence, scratch: Optional[float] = 0.0):
    """``(argument, output, scratch)`` bytes of a launch's tensors."""
    def nbytes(ts):
        return float(sum(t.numel() * t.element_size() for t in ts))

    return nbytes(args), nbytes(outs), float(scratch or 0.0)
