"""Plain PyTorch helpers of the references: exact float64 distances, the
float64 top-k, a single TF32 pass for the control, and the grading of a
kNN answer.

Nothing here imports the program.  The references take the benchmark's
own inputs (the float32 rows and queries it made from the seed) and read
the program's outputs only to judge them.

Every compared distance is a squared L2 distance in float64, taken in the
direct form ``sum((x - q) ** 2)`` of the float32 rows; the expanded form
only selects.  A distance's error is measured against the scale of the
float32 expanded form that the program computes, ``|q|^2 + |x|^2``.
"""

from __future__ import annotations

import contextlib

import torch

# bytes of one block of the (queries, rows) distance matrix
BLOCK_BYTES = 1 << 31


def rows_per_block(n: int, bytes_per: int = 8) -> int:
    return max(1, BLOCK_BYTES // (bytes_per * max(int(n), 1)))


class Rows:
    """The index rows in float64, with their squared norms."""

    def __init__(self, x: torch.Tensor):
        self.x = x.to(torch.float64)
        self.sq = (self.x * self.x).sum(dim=1)
        self.n = x.shape[0]

    def sq_dists(self, q64: torch.Tensor) -> torch.Tensor:
        """(m, n) squared distances, expanded form in float64."""
        return (q64 * q64).sum(dim=1)[:, None] + self.sq[None, :] - 2.0 * (q64 @ self.x.T)

    def direct(self, q64: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """(m, k) squared distances of each query to its listed rows (ids
        clamped into range), in the direct form."""
        m, k = ids.shape
        out = torch.empty((m, k), dtype=torch.float64, device=q64.device)
        step = max(1, (BLOCK_BYTES // 4) // (8 * max(k, 1) * self.x.shape[1]))
        for s in range(0, m, step):
            xi = self.x[ids[s:s + step].clamp(0, self.n - 1)]
            diff = xi - q64[s:s + step, None, :]
            out[s:s + step] = (diff * diff).sum(dim=-1)
        return out


def topk_rows(rows: Rows, q: torch.Tensor, k: int, masks=None):
    """The k nearest rows of each query by float64 distance: ``(ids (m, k)
    int64, found (m, k) bool)``; with ``masks(s, e) -> (e - s, n) bool``
    only the rows it marks are candidates, and ``found`` is False past
    the candidates a query has."""
    q64 = q.to(torch.float64)
    m = q.shape[0]
    ids = torch.empty((m, k), dtype=torch.int64, device=q.device)
    found = torch.empty((m, k), dtype=torch.bool, device=q.device)
    step = rows_per_block(rows.n)
    for s in range(0, m, step):
        e = min(m, s + step)
        dist = rows.sq_dists(q64[s:e])
        if masks is not None:
            dist.masked_fill_(~masks(s, e), float("inf"))
        d, i = torch.topk(dist, k, dim=1, largest=False, sorted=True)
        ids[s:e] = i
        found[s:e] = torch.isfinite(d)
        del dist
    return ids, found


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 stored mantissa bits), to the
    nearest, ties to even: what a single TF32 tensor-core pass reads."""
    u = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


@contextlib.contextmanager
def ieee_float32():
    """float32 products in IEEE float32 (no TF32) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def tf32_topk(x: torch.Tensor, q: torch.Tensor, k: int, masks=None):
    """The control: the k nearest rows by the expanded distance of one TF32
    pass (operands rounded to TF32, products summed in float32, norms of
    the unrounded float32 rows), as the program returns them: ``(sqrt
    distances (m, k) float32 ascending, ids (m, k) int32)``."""
    xr = round_tf32(x)
    xn = (x * x).sum(dim=1)
    m = q.shape[0]
    out_d = torch.empty((m, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=q.device)
    step = rows_per_block(x.shape[0], 4)
    with ieee_float32():
        for s in range(0, m, step):
            e = min(m, s + step)
            qb = q[s:e]
            dist = (qb * qb).sum(dim=1)[:, None] + xn[None, :] - 2.0 * (round_tf32(qb) @ xr.T)
            dist.clamp_(min=0.0)
            if masks is not None:
                dist.masked_fill_(~masks(s, e), float("inf"))
            d, i = torch.topk(dist, k, dim=1, largest=False, sorted=True)
            out_d[s:e] = torch.sqrt(d)
            out_i[s:e] = torch.where(torch.isfinite(d), i, -1).to(torch.int32)
            del dist
    return out_d, out_i


def grade(rows: Rows, q: torch.Tensor, port_d: torch.Tensor, port_i: torch.Tensor,
          ref_ids: torch.Tensor, ref_found: torch.Tensor, exclude_gap=None) -> dict:
    """The numbers of one kNN answer against the reference's.

    - ``dist_err``: the largest gap between a returned distance (squared)
      and the exact distance of the row it names, over ``|q|^2 + |x|^2``;
    - ``rank_gap``: the largest amount by which the j-th returned row lies
      farther than the reference's j-th, over ``|q|^2 + |x_ref|^2``
      (queries where ``exclude_gap`` is True are left out);
    - ``bad_ids``: ids out of range or repeated in a row where the
      reference has a row, and ids other than -1 where it has none.

    Also returns the direct distances of the returned rows (``port_sq``)
    and of the reference's (``ref_sq``) for the callers' own numbers.
    """
    q64 = q.to(torch.float64)
    ids = port_i.to(torch.int64)
    in_range = (ids >= 0) & (ids < rows.n)
    srt, _ = torch.sort(torch.where(in_range, ids, -1 - torch.arange(
        ids.shape[1], device=ids.device)[None, :]), dim=1)
    repeated = torch.zeros_like(in_range)
    repeated[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    ok = in_range & ~repeated
    bad = int(((ref_found & ~ok) | (~ref_found & (ids != -1))).sum())
    qsq = (q64 * q64).sum(dim=1)[:, None]
    port_sq = rows.direct(q64, ids)
    ref_sq = rows.direct(q64, ref_ids)
    got = port_d.to(torch.float64) ** 2
    err = (got - port_sq).abs() / (qsq + rows.sq[ids.clamp(0, rows.n - 1)])
    dist_err = float(err[ok].max()) if bool(ok.any()) else 0.0
    gap = (port_sq - ref_sq).clamp(min=0.0) / (qsq + rows.sq[ref_ids.clamp(0, rows.n - 1)])
    use = ok & ref_found
    if exclude_gap is not None:
        use &= ~exclude_gap[:, None]
    rank_gap = float(gap[use].max()) if bool(use.any()) else 0.0
    return {"dist_err": dist_err, "rank_gap": rank_gap, "bad_ids": bad,
            "port_sq": port_sq, "ref_sq": ref_sq, "ok": ok}


def merge_numbers(acc: dict, new: dict) -> dict:
    """Fold one answer's numbers into the run's: the worst of each
    distance number, the sum of each count."""
    for key, value in new.items():
        if key in ("dist_err", "rank_gap", "assign_gap"):
            acc[key] = max(acc.get(key, 0.0), value)
        else:
            acc[key] = acc.get(key, 0) + value
    return acc
