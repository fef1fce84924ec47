"""Pad-to-bucket shape policy for the serving layer.

Port of ``raft_tpu/serve/bucketing.py``.  A :class:`BucketPolicy` fixes
a small ladder of legal row counts ("rungs"); every coalesced batch is
padded up to the smallest rung that holds it.  In the JAX package that
bounds the executable cache at one compile per rung.  PyTorch compiles
nothing per shape, but the ladder still bounds the distinct shapes the
kernels and the caching allocator see, so :meth:`Service.warmup
<raft_tpu_torch.serve.service.Service.warmup>` can touch each of them
before traffic arrives, and padding waste stays bounded by the rung
spacing (pow2 rungs waste < 50% of rows in the worst case) and is
measured: the scheduler feeds ``raft_tpu_serve_{payload,padded}_rows_total``.

:func:`resolve_rungs` and :class:`BucketPolicy` are unchanged;
:func:`pad_rows`, :func:`coalesce` and :func:`split_rows` work on
tensors.  The zeros tail of :func:`pad_rows` is cached per (rows, dim,
dtype, device) here, in place of the JAX package's ``mr`` zeros cache.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Sequence, Tuple, Union

import torch

from raft_tpu_torch.core.error import expects

__all__ = ["BucketPolicy", "resolve_rungs", "pad_rows", "coalesce",
           "split_rows"]

# smallest pow2 rung generated by "pow2" — a floor below which a
# dedicated bucket is not worth it (the pad waste at 8 rows is noise)
MIN_POW2_RUNG = 8

# zeros tails by (shape, dtype, device); a ladder of rungs gives a
# bounded set of tail shapes per service
_ZEROS_CAP = 256
_zeros: Dict[Tuple, torch.Tensor] = {}
_zeros_lock = threading.Lock()


def resolve_rungs(spec: Union[str, Sequence[int], None],
                  max_rows: int) -> Tuple[int, ...]:
    """Resolve a rung spec into an ascending tuple ending at ``max_rows``.

    ``spec``:

    - ``None`` / ``"pow2"``: powers of two from :data:`MIN_POW2_RUNG`
      up to ``max_rows`` (``max_rows`` itself is always the top rung,
      pow2 or not);
    - a comma-separated string (the ``serve_bucket_rungs`` knob form)
      or a sequence of ints: explicit rungs, deduplicated and sorted;
      must be positive and must not exceed ``max_rows``.
    """
    expects(max_rows >= 1, "resolve_rungs: max_rows=%d", max_rows)
    if spec is None or spec == "pow2":
        rungs: List[int] = []
        r = MIN_POW2_RUNG
        while r < max_rows:
            rungs.append(r)
            r *= 2
        rungs.append(max_rows)
        return tuple(rungs)
    if isinstance(spec, str):
        try:
            parsed = [int(tok) for tok in spec.split(",") if tok.strip()]
        except ValueError:
            raise ValueError(
                "resolve_rungs: bucket rung spec %r is neither 'pow2' nor "
                "a comma-separated int list" % spec) from None
        spec = parsed
    rungs = sorted(set(int(r) for r in spec))
    expects(len(rungs) > 0, "resolve_rungs: empty rung list")
    expects(rungs[0] >= 1, "resolve_rungs: rung %d < 1", rungs[0])
    expects(rungs[-1] <= max_rows,
            "resolve_rungs: rung %d exceeds max_rows %d",
            rungs[-1], max_rows)
    if rungs[-1] < max_rows:
        rungs.append(max_rows)
    return tuple(rungs)


class BucketPolicy:
    """An ascending ladder of legal batch row counts."""

    def __init__(self, rungs: Sequence[int]):
        self.rungs: Tuple[int, ...] = tuple(int(r) for r in rungs)
        expects(len(self.rungs) > 0, "BucketPolicy: no rungs")
        expects(all(a < b for a, b in zip(self.rungs, self.rungs[1:])),
                "BucketPolicy: rungs must be strictly ascending, got %r",
                self.rungs)
        expects(self.rungs[0] >= 1, "BucketPolicy: rung %d < 1",
                self.rungs[0])

    @property
    def max_rows(self) -> int:
        return self.rungs[-1]

    def bucket_for(self, rows: int) -> int:
        """Smallest rung >= ``rows`` (the batch's padded row count)."""
        expects(rows >= 1, "bucket_for: rows=%d", rows)
        expects(rows <= self.max_rows,
                "bucket_for: rows=%d exceeds the top rung %d",
                rows, self.max_rows)
        return self.rungs[bisect.bisect_left(self.rungs, rows)]

    def padding_waste(self, rows: int) -> int:
        """Rows of padding a ``rows``-row batch pays."""
        return self.bucket_for(rows) - rows


def _zeros_cached(shape: Tuple[int, ...], dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    key = (shape, dtype, device)
    with _zeros_lock:
        z = _zeros.get(key)
        if z is None:
            if len(_zeros) >= _ZEROS_CAP:
                _zeros.clear()
            z = _zeros[key] = torch.zeros(shape, dtype=dtype, device=device)
    return z


def pad_rows(arr: torch.Tensor, target_rows: int) -> torch.Tensor:
    """Zero-pad ``arr`` along dim 0 up to ``target_rows``.

    Pad rows are zeros; consumers must be row-independent so the pad
    rows' (discarded) results cannot contaminate payload rows — true of
    every distance/kNN primitive the serving layer fronts.  The tail is
    a cached zeros block joined by concatenation, so the result is fresh
    storage whenever padding occurred; the cached block is never
    written.
    """
    rows = arr.shape[0]
    expects(rows <= target_rows,
            "pad_rows: %d rows exceed the target %d", rows, target_rows)
    if rows == target_rows:
        return arr
    tail = _zeros_cached((target_rows - rows,) + tuple(arr.shape[1:]),
                         arr.dtype, arr.device)
    if tail.is_cuda:
        # the cached block may come from another stream's pool: keep it
        # from being reused before this stream has read it
        tail.record_stream(torch.cuda.current_stream(tail.device))
    return torch.cat([arr, tail], dim=0)


def coalesce(arrays: Sequence[torch.Tensor]
             ) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """Concatenate per-request row blocks into one batch.

    Returns ``(batch, spans)`` where ``spans[i] = (start, stop)`` are
    the row range of request i — the inverse map :func:`split_rows`
    applies to the result tensors.
    """
    expects(len(arrays) > 0, "coalesce: no arrays")
    spans: List[Tuple[int, int]] = []
    at = 0
    for a in arrays:
        spans.append((at, at + a.shape[0]))
        at += a.shape[0]
    batch = arrays[0] if len(arrays) == 1 else torch.cat(list(arrays), dim=0)
    return batch, spans


def split_rows(arr: torch.Tensor,
               spans: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Slice a result tensor back into per-request row blocks."""
    return [arr[start:stop] for start, stop in spans]
