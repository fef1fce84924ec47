"""The references against a naive NumPy top-k at tiny sizes, and the
grading's numbers on answers with known faults."""

import numpy as np
import pytest
import torch

from portbench.reference import common, ivf_flat, knn_exact, quantizer


def _data(seed=0, n=300, d=8, m=40):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, d, generator=g), torch.randn(m, d, generator=g)


def _naive(x, q, k, allowed=None):
    x64, q64 = x.double().numpy(), q.double().numpy()
    d = ((q64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
    if allowed is not None:
        d = np.where(allowed, d, np.inf)
    return np.sort(d, axis=1)[:, :k], np.argsort(d, axis=1, kind="stable")[:, :k]


def _answer(x, q, k, allowed=None):
    d, i = _naive(x, q, k, allowed)
    return torch.from_numpy(np.sqrt(d)).float(), torch.from_numpy(i).int()


def test_exact_topk_matches_naive():
    x, q = _data()
    ids, found = common.topk_rows(common.Rows(x), q, 10)
    d_ref, _ = _naive(x, q, 10)
    got = common.Rows(x).direct(q.double(), ids).numpy()
    assert found.all()
    assert np.allclose(got, d_ref, rtol=1e-12, atol=1e-12)


def test_sound_answer_grades_clean():
    x, q = _data()
    ref = knn_exact.Reference({}, x)
    exp = ref.expect(q, 10)
    g = ref.grade(q, *_answer(x, q, 10), exp)
    assert g["bad_ids"] == 0 and g["dist_err"] < 1e-6 and g["rank_gap"] < 1e-12


@pytest.mark.parametrize("fault", ["altered_id", "wrong_rows", "repeated", "out_of_range"])
def test_faults_are_seen(fault):
    x, q = _data()
    ref = knn_exact.Reference({}, x)
    exp = ref.expect(q, 10)
    d, i = _answer(x, q, 10)
    if fault == "altered_id":
        i[3, 0] = (i[3, 0] + 1) % x.shape[0]
        key, floor = "dist_err", 1e-3
    elif fault == "wrong_rows":
        d, i = d.roll(1, 0), i.roll(1, 0)
        key, floor = "rank_gap", 1e-3
    elif fault == "repeated":
        i[5, 1] = i[5, 0]
        key, floor = "bad_ids", 1
    else:
        i[0, 9] = x.shape[0]
        key, floor = "bad_ids", 1
    assert ref.grade(q, d, i, exp)[key] >= floor


def test_round_tf32():
    v = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12, 3.0e-3])
    r = common.round_tf32(v)
    assert r[0] == 1.0
    assert r[1] == 1.0                         # tie to even
    assert r[2] == 1.0 + 4 * 2 ** -11         # tie to even, up
    assert r[3] == -1.0
    assert (r.view(torch.int32) & 0x1FFF == 0).all()


def test_control_reads_worse_than_the_program():
    x, q = _data(n=2000, d=64, m=64)
    x, q = x + 4.0, q + 4.0                    # norms well above the distances
    ref = knn_exact.Reference({}, x)
    exp = ref.expect(q, 20)
    sound = ref.grade(q, *_answer(x, q, 20), exp)
    control = ref.grade(q, *ref.control(q, 20), exp)
    assert control["dist_err"] > 30 * max(sound["dist_err"], 1e-9)


IVF_CONF = {"nprobe": 2, "nlist": 6, "kmeans_iters": 25}


def _ivf_index(x, nlist=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    cent = x[torch.randperm(x.shape[0], generator=g)[:nlist]].clone()
    lists = torch.cdist(x.double(), cent.double()).argmin(1)
    cap = int(torch.bincount(lists, minlength=nlist).max())
    slot_ids = torch.full((nlist, cap), -1, dtype=torch.int32)
    slot_vecs = torch.zeros(nlist, cap, x.shape[1])
    for c in range(nlist):
        rows = torch.nonzero(lists == c)[:, 0]
        slot_ids[c, :len(rows)] = rows.int()
        slot_vecs[c, :len(rows)] = x[rows]
    return {"centroids": cent, "slot_ids": slot_ids, "slot_vecs": slot_vecs,
            "slot_centroid": torch.arange(nlist, dtype=torch.int32)}, lists


def test_ivf_reference_matches_naive_probe():
    x, q = _data(n=400)
    index, lists = _ivf_index(x)
    ref = ivf_flat.Reference(IVF_CONF, x, index, seed=3)
    nums = ref.index_numbers()
    assert nums["store_bad"] == 0 and nums["assign_gap"] == 0.0
    # centroids drawn from the rows are no fixed point of Lloyd's step
    assert nums["lloyd_gain"] > 1e-3 and nums["kmeans_excess"] > 1e-3
    exp = ref.expect(q, 10)
    cd = torch.cdist(q.double(), index["centroids"].double())
    probed = torch.topk(cd, 2, largest=False).indices
    allowed = (lists[None, :, None] == probed[:, None, :]).any(-1).numpy()
    g = ref.grade(q, *_answer(x, q, 10, allowed), exp)
    amb = exp["ambiguous"]
    assert g["bad_ids"] == 0 and g["probe_miss"] == 0 and g["dist_err"] < 1e-6
    assert g["rank_gap"] < 1e-12 and int(amb.sum()) == g["ambiguous"]
    # the exact answer over every row reads as recall 1 and misses probes
    g_all = ref.grade(q, *_answer(x, q, 10), exp)
    assert g_all["hits"] == g_all["graded"] and g_all["probe_miss"] > 0


def test_ivf_build_faults_are_seen():
    x, _ = _data(n=400)
    index, _ = _ivf_index(x)
    moved = dict(index, slot_ids=index["slot_ids"].clone())
    a, b = moved["slot_ids"][0, 0].item(), moved["slot_ids"][1, 0].item()
    moved["slot_ids"][0, 0], moved["slot_ids"][1, 0] = b, a    # rows in the wrong lists
    nums = ivf_flat.Reference(IVF_CONF, x, moved, seed=3).index_numbers()
    assert nums["assign_gap"] > 1e-3 and nums["store_bad"] > 0


def _naive_lloyd_step(x, cent):
    x, cent = x.numpy(), cent.numpy()
    lists = ((x[:, None, :] - cent[None, :, :]) ** 2).sum(-1).argmin(1)
    out = cent.copy()
    for c in range(cent.shape[0]):
        if (lists == c).any():
            out[c] = x[lists == c].mean(0)
    return out, lists


def test_quantizer_against_naive_lloyd():
    x, _ = _data(n=300, d=8)
    rows = common.Rows(x)
    cent = quantizer.kmeans_pp(rows.x, rows.sq, 5, torch.Generator().manual_seed(4))
    # k-means++ picks rows of the data, each once
    picked = (cent[:, None, :] == rows.x[None, :, :]).all(-1)
    assert (picked.sum(1) == 1).all() and picked.any(0).sum() == 5
    want, lists = _naive_lloyd_step(rows.x, cent)
    got = quantizer.lloyd(rows.x, rows.sq, cent, 1)
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert (quantizer.nearest(rows.x, rows.sq, cent).numpy() == lists).all()
    obj = ((rows.x.numpy() - cent.numpy()[lists]) ** 2).sum(1).mean()
    assert abs(quantizer.objective(rows, cent, torch.from_numpy(lists)) - obj) < 1e-9 * obj


def test_own_build_reads_as_a_fixed_point():
    """An index built from the reference's own quantizer, with its own
    seed, reads no excess and no gain; stopped after one step, it does."""
    g = torch.Generator().manual_seed(8)
    centres = torch.randn(6, 8, generator=g) * 4.0
    x = (centres[torch.arange(600) % 6] + torch.randn(600, 8, generator=g)).float()
    rows = common.Rows(x)
    nums = {}
    for iters in (25, 1):
        cent, lists = quantizer.build(rows, 6, iters, seed=5)
        cap = int(torch.bincount(lists, minlength=6).max())
        slot_ids = torch.full((6, cap), -1, dtype=torch.int32)
        slot_vecs = torch.zeros(6, cap, 8)
        for c in range(6):
            r = torch.nonzero(lists == c)[:, 0]
            slot_ids[c, :len(r)] = r.int()
            slot_vecs[c, :len(r)] = x[r]
        index = {"centroids": cent.float(), "slot_ids": slot_ids, "slot_vecs": slot_vecs,
                 "slot_centroid": torch.arange(6, dtype=torch.int32)}
        nums[iters] = ivf_flat.Reference(dict(IVF_CONF, nlist=6), x, index,
                                         seed=5).index_numbers()
    assert abs(nums[25]["kmeans_excess"]) < 1e-6 and nums[25]["lloyd_gain"] < 1e-6
    assert nums[1]["lloyd_gain"] > 1e-4 or nums[1]["kmeans_excess"] > 1e-4
