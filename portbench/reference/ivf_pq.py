"""The plain reference of an IVF-PQ search with an exact re-rank.

The coarse quantizer and the lists are judged as ``ivf_flat.py`` judges
them (``kmeans_excess``, ``lloyd_gain``, ``assign_gap``; this class is
its subclass), and the stored vectors of the re-rank by ``store_bad``
(ids not stored exactly once, stored vectors that differ from their
rows).  The codebooks are judged like a quantizer of their own, on the
residuals of every row to its list's centroid in the program's lists
(float64), by numbers that do not need equal codebooks:

- ``pq_excess``: the summed objective of the program's codebooks and
  codes over every subspace (squared distance of each residual
  subvector to its codeword) over that of the reference's own float64
  codebooks (``quantizer.py``: k-means++ and ``pq_iters`` Lloyd steps a
  subspace, from a seed of the benchmark's), less 1;
- ``pq_lloyd_gain``: the share of that objective that one more Lloyd
  step from the program's codebooks takes off;
- ``code_gap``: the largest amount by which a row's codeword lies
  farther from its residual subvector than the nearest codeword, over
  ``|r|^2 + |c|^2`` of the subspace.

The search is judged step by step from the program's index, which the
numbers above have judged by themselves.  A row's ADC distance to a
query is the distance to its decoded vector, its list's centroid plus
its codewords (float64): the sum over subspaces of the table entries
the program reads.  A search probes the ``nprobe`` nearest centroids
(``PROBE_TIE`` ambiguity, as in ``ivf_flat.py``), takes the ``k *
refine_ratio`` nearest rows of the probed lists by ADC, and re-ranks
them to k by their exact distance.  Where the ADC distances of the
``k * refine_ratio``-th and the next candidate lie within ``CAND_TIE``
of ``|q|^2 + |x_dec|^2``, the query is ambiguous: either may be a
candidate, so its rank gap is not taken.  ``cand_miss`` counts returned
rows that are not among an unambiguous query's candidates.  ``hits``
and ``graded`` hold the recall against the exact k nearest rows over
every row (ties as sets); recall is not compared.

Controls: ``tf32`` re-ranks the reference's candidates by one TF32 pass
and judges the build with rows assigned to lists, and subvectors to
codewords, by one TF32 pass each (as ``ivf_flat.py``'s assigns rows);
``pq_early`` puts the reference's own codebooks, stopped after
``EARLY_ITERS`` Lloyd steps, and the nearest codes in the program's
place and answers from them in float64; ``no_refine`` returns the k
nearest by ADC with their ADC distances.
"""

from __future__ import annotations

import torch

from portbench.reference import ivf_flat, quantizer
from portbench.reference.common import Rows, grade, tf32_topk, topk_rows

CAND_TIE = 1e-6
# Lloyd steps of the pq_early control's codebooks
EARLY_ITERS = 1


class Reference(ivf_flat.Reference):
    CONTROLS = ("tf32", "pq_early", "no_refine")

    def __init__(self, config: dict, x, index: dict, seed: int, control: str = None):
        super().__init__(config, x, index, seed, control)
        self.ratio = int(config["refine_ratio"])
        books = index["codebooks"].to(torch.float64)
        n_sub, ksub, dsub = books.shape
        cent_of_row = self.cent[self.list_of_row.clamp(max=self.nlist - 1)]
        resid = self.rows.x - cent_of_row
        judged = own = after = 0.0
        worst = 0.0
        early = []
        for m in range(n_sub):
            r = Rows(resid[:, m * dsub:(m + 1) * dsub])
            gen = torch.Generator(device=r.x.device).manual_seed(int(seed) + 1 + m)
            start = quantizer.kmeans_pp(r.x, r.sq, ksub, gen)
            first = quantizer.lloyd(r.x, r.sq, start, EARLY_ITERS)
            mine = quantizer.lloyd(r.x, r.sq, first, int(config["pq_iters"]) - EARLY_ITERS)
            own += quantizer.objective(r, mine, quantizer.nearest(r.x, r.sq, mine))
            if control == "pq_early":
                book, codes = first, quantizer.nearest(r.x, r.sq, first)
                early.append((book, codes))
            elif control == "tf32":
                book, codes = books[m], _tf32_codes(r, books[m])
            else:
                book, codes = books[m], self.codes[:, m]
            judged += quantizer.objective(r, book, codes)
            step1 = quantizer.lloyd(r.x, r.sq, book, 1)
            after += quantizer.objective(r, step1, quantizer.nearest(r.x, r.sq, step1))
            worst = max(worst, _code_gap(r, book, codes))
        if early:
            books = torch.stack([b for b, _ in early])
            self.codes = torch.stack([c for _, c in early], dim=1)
        self.pq_numbers = {"pq_excess": judged / own - 1.0, "pq_lloyd_gain": 1.0 - after / judged,
                           "code_gap": worst}
        sub = torch.arange(n_sub, device=books.device)[None, :]
        decoded = books[sub, self.codes.clamp(max=ksub - 1)].reshape(resid.shape)
        del resid
        self.dec = Rows(cent_of_row + decoded)

    def _lists(self, index: dict):
        """``(store_bad, the list of each row)`` from the program's slots,
        as ``ivf_flat.py`` reads them, with the stored vectors of the
        re-rank checked against the rows; also sets each row's codes
        (``codes``, (n, M) int64, ``ksub`` where a row is in no list)."""
        x = self.x
        sid = index["slot_ids"].to(torch.int64)
        valid = sid >= 0
        ids = sid[valid]
        lists = index["slot_centroid"].to(torch.int64)[:, None].expand_as(sid)[valid]
        inside = (ids >= 0) & (ids < self.rows.n)
        counts = torch.bincount(ids[inside], minlength=self.rows.n)
        vec = index["vectors"]
        if vec is None or tuple(vec.shape) != tuple(x.shape):
            differ = self.rows.n
        else:
            differ = int((vec != x).any(dim=1).sum())
        store_bad = int((~inside).sum()) + int((counts != 1).sum()) + differ
        list_of_row = torch.full((self.rows.n,), self.nlist, dtype=torch.int64, device=x.device)
        list_of_row[ids[inside]] = lists[inside]
        n_sub, ksub = index["codebooks"].shape[:2]
        codes = index["slot_codes"].to(torch.int64).reshape(-1, n_sub)[valid.reshape(-1)]
        self.codes = torch.full((self.rows.n, n_sub), ksub, dtype=torch.int64, device=x.device)
        self.codes[ids[inside]] = codes[inside]
        return store_bad, list_of_row

    def index_numbers(self) -> dict:
        return dict(super().index_numbers(), **self.pq_numbers)

    def _candidates(self, q, kk: int, probed):
        """The ``kk`` nearest rows of the probed lists by ADC: ``(ids (m,
        kk), found (m, kk), ambiguous (m,))``."""
        lor = self.list_of_row
        ids, found = topk_rows(self.dec, q, kk + 1, lambda s, e: probed[s:e][:, lor])
        q64 = q.to(torch.float64)
        edge = self.dec.direct(q64, ids[:, kk - 1:kk + 1])
        scale = (q64 * q64).sum(dim=1) + self.dec.sq[ids[:, kk - 1]]
        ambiguous = found[:, kk] & (edge[:, 1] - edge[:, 0] <= CAND_TIE * scale)
        return ids[:, :kk], found[:, :kk], ambiguous

    def expect(self, q, k: int) -> dict:
        probed, band, ambiguous = self._probe(q)
        cand, cfound, cand_amb = self._candidates(q, k * self.ratio, probed)
        exact_d = self.rows.direct(q.to(torch.float64), cand).masked_fill_(~cfound, float("inf"))
        top, pos = torch.topk(exact_d, k, dim=1, largest=False, sorted=True)
        exact, _ = topk_rows(self.rows, q, k)
        exact_sq = self.rows.direct(q.to(torch.float64), exact)
        return {"ids": cand.gather(1, pos), "found": torch.isfinite(top), "band": band,
                "ambiguous": ambiguous, "cand": cand, "cand_found": cfound,
                "cand_ambiguous": cand_amb, "exact_kth": exact_sq.max(dim=1).values}

    def grade(self, q, port_d, port_i, exp: dict) -> dict:
        band, lor = exp["band"], self.list_of_row
        loose = exp["ambiguous"] | exp["cand_ambiguous"]
        g = grade(self.rows, q, port_d, port_i, exp["ids"], exp["found"], exclude_gap=loose)
        rowsel = torch.arange(q.shape[0], device=q.device)[:, None]
        pid = port_i.to(torch.int64)
        inrange = (pid >= 0) & (pid < self.rows.n)
        miss_allowed = band[rowsel, lor[pid.clamp(0, self.rows.n - 1)]]
        cand = torch.where(exp["cand_found"], exp["cand"], -1)
        among = (pid[:, :, None] == cand[:, None, :]).any(dim=2)
        hits = g["ok"] & (g["port_sq"] <= exp["exact_kth"][:, None])
        return {"dist_err": g["dist_err"], "rank_gap": g["rank_gap"], "bad_ids": g["bad_ids"],
                "probe_miss": int((inrange & ~miss_allowed).sum()),
                "cand_miss": int((inrange & ~among & ~loose[:, None]).sum()),
                "ambiguous": int(exp["ambiguous"].sum()),
                "cand_ambiguous": int(exp["cand_ambiguous"].sum()),
                "hits": int(hits.sum()), "graded": int(port_i.numel())}

    def control(self, q, k: int):
        probed, _, _ = self._probe(q)
        if self.kind == "no_refine":
            ids, found, _ = self._candidates(q, k, probed)
            dist = self.dec.direct(q.to(torch.float64), ids)
        else:
            exp = self.expect(q, k)
            if self.kind == "tf32":
                cand, cfound = exp["cand"], exp["cand_found"]

                def masks(s, e):
                    m = torch.zeros((e - s, self.rows.n), dtype=torch.bool, device=q.device)
                    rows = torch.arange(e - s, device=q.device)[:, None].expand(-1, cand.shape[1])
                    m[rows[cfound[s:e]], cand[s:e][cfound[s:e]]] = True
                    return m

                return tf32_topk(self.x, q, k, masks)
            ids, found = exp["ids"], exp["found"]
            dist = self.rows.direct(q.to(torch.float64), ids)
        dist = dist.sqrt().to(torch.float32)
        return (torch.where(found, dist, float("inf")),
                torch.where(found, ids, -1).to(torch.int32))


def _tf32_codes(r: Rows, book: torch.Tensor) -> torch.Tensor:
    """Each subvector's nearest codeword by one TF32 pass of the float32
    subvectors against the float32 codebook (``common.tf32_topk``)."""
    return tf32_topk(book.to(torch.float32), r.x.to(torch.float32), 1)[1][:, 0].to(torch.int64)


def _code_gap(r: Rows, book: torch.Tensor, codes: torch.Tensor) -> float:
    """The largest amount by which a row's codeword lies farther from its
    subvector than the nearest codeword, over ``|r|^2 + |c|^2``; rows
    whose code is out of range (in no list) are left out."""
    kept = codes < book.shape[0]
    mine = book[codes.clamp(max=book.shape[0] - 1)]
    diff = r.x - mine
    got = (diff * diff).sum(dim=1)
    best = r.x - book[quantizer.nearest(r.x, r.sq, book)]
    scale = (r.sq + (mine * mine).sum(dim=1)).clamp(min=torch.finfo(torch.float64).tiny)
    gap = (got - (best * best).sum(dim=1)) / scale
    return float(gap[kept].max()) if bool(kept.any()) else 0.0
