"""The plain reference of exact kNN: the k nearest index rows of each query
by float64 distance, over every row."""

from __future__ import annotations

from portbench.reference.common import Rows, grade, tf32_topk, topk_rows


class Reference:
    """``expect`` works out the answer of a block of queries, ``grade``
    judges the program's answer against it, ``control`` answers in the
    precision below the configuration's (one TF32 pass)."""

    CONTROLS = ("tf32",)

    def __init__(self, config: dict, x, index=None, seed: int = 0, control: str = None):
        self.x = x
        self.rows = Rows(x)

    def index_numbers(self) -> dict:
        return {}

    def expect(self, q, k: int) -> dict:
        ids, found = topk_rows(self.rows, q, k)
        return {"ids": ids, "found": found}

    def grade(self, q, port_d, port_i, exp: dict) -> dict:
        g = grade(self.rows, q, port_d, port_i, exp["ids"], exp["found"])
        return {key: g[key] for key in ("dist_err", "rank_gap", "bad_ids")}

    def control(self, q, k: int):
        return tf32_topk(self.x, q, k)
