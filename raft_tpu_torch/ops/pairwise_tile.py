"""K5: generic unexpanded pairwise distance, ``csrc/pairwise_tile.cu``.

Port of ``raft_tpu/ops/pairwise_tile.py:pairwise_tile``.  The JAX kernel
takes a traced ``combine`` lambda, a reduce kind and an epilog; the CUDA
kernel cannot trace Python, so this one takes the metric's
:class:`DistanceType` id and the kernel picks combine, reduce (add or
max) and epilog from it (the table in the source).  The plain version
below takes the same id and computes the same function.

Integer inputs are cast to float32 here, as the JAX kernel casts them;
the output is float32.  Block sizes are constants of the kernel, chosen
for Hopper: 128 x 128 output tiles of 8 x 8 a thread, the depth 8 at a
time through double-buffered shared memory (the source's note).

``epilog=False`` is the accumulate-only mode: the raw reduce of the
combine, without the metric's epilog (the JAX kernel's ``epilog=None``).
The column-tiled sparse engine (:mod:`raft_tpu_torch.sparse.distance`)
adds (or maxes) those partials over column tiles and applies
:func:`apply_epilog` once.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.core import inventory
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.ops import _build, cost

D = DistanceType

# metrics the kernel implements (DistanceType ids, csrc/pairwise_tile.cu)
METRICS = (D.L1, D.L2Unexpanded, D.L2SqrtUnexpanded, D.Linf, D.Canberra,
           D.LpUnexpanded, D.JensenShannon, D.HammingUnexpanded)

# elements of the (rows, n, d) broadcast the plain version holds at once
_PLAIN_CHUNK = 1 << 24


def _combine(metric, xv, yv, p: float):
    if metric in (D.L1, D.Linf):
        return (xv - yv).abs()
    if metric in (D.L2Unexpanded, D.L2SqrtUnexpanded):
        t = xv - yv
        return t * t
    if metric == D.Canberra:
        s = xv.abs() + yv.abs()
        return torch.where(s == 0, torch.zeros_like(s),
                           (xv - yv).abs() / torch.where(s == 0, 1.0, s))
    if metric == D.LpUnexpanded:
        return (xv - yv).abs() ** p
    if metric == D.HammingUnexpanded:
        return (xv != yv).to(torch.float32)
    # JensenShannon: KL(x||m) + KL(y||m), m = (x + y) / 2, 0 log 0 = 0
    m = 0.5 * (xv + yv)
    logm = torch.log(torch.where(m > 0, m, 1.0))

    def term(v):
        return torch.where(v > 0, v * (torch.log(torch.where(v > 0, v, 1.0)) - logm),
                           torch.zeros_like(v))

    return term(xv) + term(yv)


def apply_epilog(metric: DistanceType, acc: torch.Tensor, p: float, d: int) -> torch.Tensor:
    """The metric's epilog of a raw reduce ``acc`` over depth ``d``: what
    the kernel applies at its store unless ``epilog=False``."""
    if metric == D.L2SqrtUnexpanded:
        return torch.sqrt(acc)
    if metric == D.LpUnexpanded:
        return acc ** (1.0 / p)
    if metric == D.HammingUnexpanded:
        return acc / d
    if metric == D.JensenShannon:
        return torch.sqrt(torch.clamp(0.5 * acc, min=0.0))
    return acc


def pairwise_tile_plain(x: torch.Tensor, y: torch.Tensor, metric: DistanceType,
                        p: float = 2.0, epilog: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function of the same
    metric id, as a broadcast over row chunks of ``x``; ``epilog=False``
    returns the raw reduce."""
    metric = DistanceType(metric)
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rows = max(1, _PLAIN_CHUNK // max(1, n * d))
    for i in range(0, m, rows):
        term = _combine(metric, x[i:i + rows, None, :], y[None, :, :], p)
        acc = term.amax(dim=2) if metric == D.Linf else term.sum(dim=2)
        out[i:i + rows] = apply_epilog(metric, acc, p, d) if epilog else acc
    return out


def pairwise_tile(x: torch.Tensor, y: torch.Tensor, metric: DistanceType,
                  p: float = 2.0, epilog: bool = True) -> torch.Tensor:
    """``out[i, j] = epilog(reduce_k combine(x[i, k], y[j, k]))`` for the
    unexpanded ``metric`` (one of :data:`METRICS`); ``p`` is the
    Minkowski exponent; ``epilog=False`` stores the raw reduce (the
    accumulate-only mode).  x (m, d) and y (n, d) of any real dtype;
    returns (m, n) float32.  A CUDA tensor launches the kernel; a CPU
    tensor takes :func:`pairwise_tile_plain`.
    """
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1],
            "pairwise_tile: (m, d) and (n, d) inputs required")
    expects(metric in METRICS, "pairwise_tile: metric %r has no kernel", metric)
    expects(x.device == y.device, "pairwise_tile: x and y on different devices")
    if x.device.type == "cpu":
        return pairwise_tile_plain(x, y, metric, p, epilog)
    fn = _entry()
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    expects(d > 0, "pairwise_tile: zero depth")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), y.data_ptr(), m, n, d, int(metric), float(p), int(epilog),
                  out.data_ptr(), stream)
    _build.check(code, "pairwise_tile")
    pairwise_tile.launches += 1
    inventory.count_launch("pairwise_tile", (m, n, d, int(metric), bool(epilog)), lambda: (
        *cost.pairwise_cost(m, n, d), inventory.footprint((x, y), (out,))))
    return out


pairwise_tile.launches = 0


def _entry():
    return _build.entry("pairwise_tile", "pairwise_tile_launch",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int)
