"""The plain reference of an IVF-Flat search.

The build is judged against a quantizer of the reference's own
(``quantizer.py``: float64 k-means++ and Lloyd's k-means, drawn from a
seed of the benchmark's), by numbers that do not need equal centroids:

- ``kmeans_excess``: the k-means objective of the program's centroids and
  lists (mean squared distance from each row to its list's centroid,
  float64) over the reference's own, less 1;
- ``lloyd_gain``: the share of that objective that one more Lloyd step
  (float64, over every row) takes off from the program's centroids: 0 at
  a fixed point, large where iterations were skipped or an update broke;
- ``store_bad``: index rows not stored exactly once, and stored vectors
  that differ from the row they name;
- ``assign_gap``: the largest amount by which a row's list centroid lies
  farther from it than its nearest centroid, over ``|x|^2 + |c|^2``
  (float64).

The search is judged step by step from the program's centroids and
lists, which the build numbers above have judged by themselves: a search
probes the ``nprobe`` nearest centroids of each query (float64) and takes
the k nearest rows of the probed lists.  Where the distances of the
``nprobe``-th and the next centroid lie within ``PROBE_TIE`` of the
scale, the query is ambiguous: either list may be probed, so its rank gap
is not taken, and its rows may come from either.  ``probe_miss`` counts
returned rows whose list was not probed.  ``recall`` is the share of the
exact k nearest rows (over every row) that an answer holds, ties taken as
sets: a returned row no farther than the exact k-th counts.

Controls: ``tf32`` answers (and assigns rows) by one TF32 pass;
``kmeans_early`` puts the reference's own build, stopped after
``EARLY_ITERS`` Lloyd steps, in the program's place and answers from it
in float64.
"""

from __future__ import annotations

import torch

from portbench.reference import quantizer
from portbench.reference.common import Rows, grade, rows_per_block, tf32_topk, topk_rows

PROBE_TIE = 1e-6
# Lloyd steps of the kmeans_early control
EARLY_ITERS = 1


class Reference:
    CONTROLS = ("tf32", "kmeans_early")

    def __init__(self, config: dict, x, index: dict, seed: int, control: str = None):
        self.x = x
        self.rows = Rows(x)
        self.nprobe = int(config["nprobe"])
        self.nlist = int(config["nlist"])
        self.kind = control
        iters, train = int(config["kmeans_iters"]), config.get("train_rows")
        own, own_lists = quantizer.build(self.rows, self.nlist, iters, seed, train)
        self.own_objective = quantizer.objective(self.rows, own, own_lists)
        del own, own_lists
        if control == "kmeans_early":
            cent, self.list_of_row = quantizer.build(self.rows, self.nlist, EARLY_ITERS, seed,
                                                     train)
            self.store_bad = 0
        else:
            cent = index["centroids"].to(torch.float64)
            self.store_bad, self.list_of_row = self._lists(index)
        self.cent, self.cent_sq = cent, (cent * cent).sum(dim=1)

    def _lists(self, index: dict):
        """``(store_bad, the list of each row)`` from the program's slots;
        a row in no list gets ``nlist`` (a column that is never probed)."""
        x = self.x
        sid = index["slot_ids"].to(torch.int64)
        valid = sid >= 0
        ids = sid[valid]
        lists = index["slot_centroid"].to(torch.int64)[:, None].expand_as(sid)[valid]
        inside = (ids >= 0) & (ids < self.rows.n)
        counts = torch.bincount(ids[inside], minlength=self.rows.n)
        stored = index["slot_vecs"].reshape(-1, x.shape[1])[valid.reshape(-1)]
        differ = (stored[inside] != x[ids[inside]]).any(dim=1)
        store_bad = int((~inside).sum()) + int((counts != 1).sum()) + int(differ.sum())
        list_of_row = torch.full((self.rows.n,), self.nlist, dtype=torch.int64,
                                 device=x.device)
        list_of_row[ids[inside]] = lists[inside]
        return store_bad, list_of_row

    def index_numbers(self) -> dict:
        """The build's numbers; under the ``tf32`` control, of its
        assignment (each row to its nearest centroid by one TF32 pass) in
        place of the program's lists."""
        own_lists = self.control_lists() if self.kind == "tf32" else self.list_of_row
        worst = 0.0
        step = rows_per_block(self.nlist)
        for s in range(0, self.rows.n, step):
            xb, own = self.rows.x[s:s + step], own_lists[s:s + step]
            xsq = self.rows.sq[s:s + step]
            dist = xsq[:, None] + self.cent_sq[None, :] - 2.0 * (xb @ self.cent.T)
            kept = own < self.nlist
            mine = dist.gather(1, own.clamp(max=self.nlist - 1)[:, None])[:, 0]
            scale = xsq + self.cent_sq[own.clamp(max=self.nlist - 1)]
            gap = (mine - dist.min(dim=1).values) / scale
            if bool(kept.any()):
                worst = max(worst, float(gap[kept].max()))
        judged = quantizer.objective(self.rows, self.cent, own_lists)
        step1 = quantizer.lloyd(self.rows.x, self.rows.sq, self.cent, 1)
        after = quantizer.objective(self.rows, step1,
                                    quantizer.nearest(self.rows.x, self.rows.sq, step1))
        return {"store_bad": self.store_bad, "assign_gap": worst,
                "kmeans_excess": judged / self.own_objective - 1.0,
                "lloyd_gain": 1.0 - after / judged}

    def control_lists(self):
        """Each row's nearest centroid by the expanded distance of one TF32
        pass (``common.tf32_topk`` with the centroids as the index)."""
        x32 = self.rows.x.to(torch.float32)
        out = torch.empty(self.rows.n, dtype=torch.int64, device=x32.device)
        step = rows_per_block(self.nlist, 4)
        cent32 = self.cent.to(torch.float32)
        for s in range(0, self.rows.n, step):
            out[s:s + step] = tf32_topk(cent32, x32[s:s + step], 1)[1][:, 0].to(torch.int64)
        return out

    def _probe(self, q):
        q64 = q.to(torch.float64)
        qsq = (q64 * q64).sum(dim=1)
        dist = qsq[:, None] + self.cent_sq[None, :] - 2.0 * (q64 @ self.cent.T)
        p = min(self.nprobe, self.nlist)
        top, order = torch.topk(dist, min(p + 1, self.nlist), dim=1, largest=False, sorted=True)
        pad = torch.zeros((q.shape[0], 1), dtype=torch.bool, device=q.device)
        probed = torch.zeros((q.shape[0], self.nlist), dtype=torch.bool, device=q.device)
        probed.scatter_(1, order[:, :p], True)
        edge = top[:, p - 1:p]
        band = dist <= edge + PROBE_TIE * (qsq[:, None] + self.cent_sq[None, :])
        ambiguous = band.sum(dim=1) > p
        return torch.cat([probed, pad], 1), torch.cat([band, pad], 1), ambiguous

    def expect(self, q, k: int) -> dict:
        probed, band, ambiguous = self._probe(q)
        lor = self.list_of_row
        ids, found = topk_rows(self.rows, q, k, lambda s, e: probed[s:e][:, lor])
        exact, _ = topk_rows(self.rows, q, k)
        exact_sq = self.rows.direct(q.to(torch.float64), exact)
        return {"ids": ids, "found": found, "band": band, "ambiguous": ambiguous,
                "probed": probed, "exact_kth": exact_sq.max(dim=1).values}

    def grade(self, q, port_d, port_i, exp: dict) -> dict:
        band, lor = exp["band"], self.list_of_row
        rowsel = torch.arange(q.shape[0], device=q.device)[:, None]
        g = grade(self.rows, q, port_d, port_i, exp["ids"], exp["found"],
                  exclude_gap=exp["ambiguous"])
        miss_allowed = band[rowsel, lor[port_i.to(torch.int64).clamp(0, self.rows.n - 1)]]
        inrange = (port_i >= 0) & (port_i < self.rows.n)
        hits = g["ok"] & (g["port_sq"] <= exp["exact_kth"][:, None])
        return {"dist_err": g["dist_err"], "rank_gap": g["rank_gap"], "bad_ids": g["bad_ids"],
                "probe_miss": int((inrange & ~miss_allowed).sum()),
                "ambiguous": int(exp["ambiguous"].sum()),
                "hits": int(hits.sum()), "graded": int(port_i.numel())}

    def control(self, q, k: int):
        probed, _, _ = self._probe(q)
        lor = self.list_of_row
        if self.kind == "kmeans_early":
            ids, found = topk_rows(self.rows, q, k, lambda s, e: probed[s:e][:, lor])
            dist = self.rows.direct(q.to(torch.float64), ids).sqrt().to(torch.float32)
            return (torch.where(found, dist, float("inf")),
                    torch.where(found, ids, -1).to(torch.int32))
        return tf32_topk(self.x, q, k, lambda s, e: probed[s:e][:, lor])
