"""The frozen operation and byte counts against hand counts."""

import pytest

from portbench.frozen import cost, peaks


def test_knn_cost_by_hand():
    # 3 queries x 5 rows x depth 4: 60 multiply-adds; reads (5 + 3) x 4
    # floats, writes 3 x 2 (distance, id) pairs
    assert cost.knn_cost(3, 5, 4, 2) == (120.0, 4 * 32 + 8 * 6)


def test_select_cost_by_hand():
    assert cost.select_cost(2, 7, 3) == (14.0, 4 * 14 + 8 * 6)


def test_ivf_scan_cost_by_hand():
    # 2 queries, depth 4, k 1: 10 rows scanned, 6 distinct rows of 4
    # floats, a norm and an id each, 3 scan entries
    ops, nbytes = cost.ivf_scan_cost(2, 4, 1, 3, 10, 6)
    assert ops == 2 * 4 * 10
    assert nbytes == 6 * (16 + 8) + 4 * 2 * 4 + 4 * 3 + 8 * 2


@pytest.mark.parametrize("ops,nbytes,bound", [(495e12, 1.0, "operations"),
                                              (1.0, 3.35e12, "bytes")])
def test_roofline_names_its_bound(ops, nbytes, bound):
    o, b = peaks.least_seconds(ops, nbytes, peaks.TF32_FLOPS)
    got = peaks.roofline(o, b, 2.0)
    assert got["bound"] == bound and got["value"] == pytest.approx(50.0)
    assert peaks.roofline(o, b, 0.0) is None
