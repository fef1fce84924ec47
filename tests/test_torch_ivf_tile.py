"""Port parity of K3 against the JAX package's ``fused_ivf_scan_xla``
(the op-for-op oracle of the Pallas kernel), in float32 and bfloat16:
the plain version of the whole function (``fused_ivf_scan_plain``), and
the route the card runs, on the CPU (``fused_ivf_scan``: the inversion of
the scan lists into a work list, the plain per-item top-k in the
kernel's place, K2's plain merge), with one small case against the
Pallas ``fused_ivf_scan`` in interpret mode (the stores of
``tests/test_fused_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_knn_close
from raft_tpu.ops.ivf_tile import fused_ivf_scan as jax_fused_ivf_scan
from raft_tpu.ops.ivf_tile import fused_ivf_scan_xla
from raft_tpu_torch import LogicError
from raft_tpu_torch.ops import ivf_tile
from raft_tpu_torch.ops.ivf_tile import (fused_ivf_scan, fused_ivf_scan_plain, ivf_items_plain,
                                         scan_work_list)
from raft_tpu_torch.ops.select_tile import select_tile

# expanded-form float32 in another order: a few ulps of |q|^2 + |v|^2
RTOL, ATOL = 1e-5, 1e-4
# bf16 operands: the port and the JAX bf16 oracle round the same values and
# differ in the order of the float32 sums; against float32 the rounding
# itself shows (the tolerance of tests/test_fused_kernels.py)
BF16_ATOL, BF16_TRUTH_ATOL = 1e-3, 5e-2


def _rand(shape, seed):
    return np.random.RandomState(seed).random(shape).astype(np.float32)


def _slot_store(S, cap, d, seed, vacancy_rows=0):
    rng = np.random.RandomState(seed)
    sv = rng.random((S, cap, d)).astype(np.float32)
    sn = (sv * sv).sum(-1).astype(np.float32)
    si = np.arange(S * cap, dtype=np.int32).reshape(S, cap)
    if vacancy_rows:
        si[:, cap - vacancy_rows:] = -1
        sv[:, cap - vacancy_rows:] = 0.0
        sn[:, cap - vacancy_rows:] = 0.0
    return sv, sn, si


def _case(S, cap, d, nq, n_steps, seed, vacancy_rows):
    sv, sn, si = _slot_store(S, cap, d, seed, vacancy_rows)
    q = _rand((nq, d), seed + 1)
    rng = np.random.RandomState(seed + 2)
    slots = np.stack([rng.permutation(S)[:n_steps] for _ in range(nq)]).astype(np.int32)
    slots[0, 2:] = -1                    # a short scan list
    slots[1, :] = -1                     # a query with nothing to scan
    return q, sv, sn, si, slots


def _run(args, k, accum_bf16=False):
    jargs = [jnp.asarray(a) for a in args]
    ref = fused_ivf_scan_xla(*jargs, k, accum_bf16=accum_bf16)
    got = fused_ivf_scan_plain(*[torch.from_numpy(a) for a in args], k,
                               accum_bf16=accum_bf16)
    return ref, got


# (S, cap, d, k, nq, n_steps, vacancy_rows): the tier-1 store of
# test_fused_kernels, the store of its parity matrix, k = 1 and k at the
# cap of 128 (more than the candidates of the short lists)
CASES = [(6, 24, 10, 5, 7, 4, 3), (8, 40, 18, 13, 9, 5, 2), (5, 37, 16, 1, 6, 3, 0),
         (8, 40, 18, 128, 5, 5, 2)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "S%d-cap%d-d%d-k%d" % c[:4])
def test_plain_matches_jax_oracle(case):
    S, cap, d, k, nq, n_steps, vac = case
    args = _case(S, cap, d, nq, n_steps, 12, vac)
    (rd, ri), (gd, gi) = _run(args, k)
    assert_knn_close(rd, ri, gd.numpy(), gi.numpy(), RTOL, ATOL)
    assert (gi[1] == -1).all() and torch.isinf(gd[1]).all()


def test_bf16_matches_jax_bf16_oracle_and_float32_truth():
    args = _case(8, 40, 18, 9, 5, 23, 2)
    (rd, ri), (gd, gi) = _run(args, 13, accum_bf16=True)
    assert_knn_close(rd, ri, gd.numpy(), gi.numpy(), 0, BF16_ATOL)
    (fd, _), _ = _run(args, 13)
    fin = np.isfinite(np.asarray(fd))
    np.testing.assert_allclose(gd.numpy()[fin], np.asarray(fd)[fin], rtol=0,
                               atol=BF16_TRUTH_ATOL)


def test_plain_matches_interpreted_pallas_kernel():
    # the one interpret-mode run of the Pallas kernel
    args = _case(6, 24, 10, 7, 4, 12, 3)
    ref = jax_fused_ivf_scan(*[jnp.asarray(a) for a in args], 5, interpret=True)
    got = fused_ivf_scan(*[torch.from_numpy(a) for a in args], 5)
    assert_knn_close(*ref, got[0].numpy(), got[1].numpy(), RTOL, ATOL)


def test_ties_resolve_to_the_earlier_scan_position():
    # every slot holds the same rows: equal distances in each step
    sv, sn, si = _slot_store(1, 8, 4, 3)
    sv, sn = np.repeat(sv, 3, 0), np.repeat(sn, 3, 0)
    si = np.arange(24, dtype=np.int32).reshape(3, 8)
    q = _rand((2, 4), 4)
    slots = np.array([[2, 0, 1], [1, 2, 0]], np.int32)
    _, ids = fused_ivf_scan(*[torch.from_numpy(a) for a in (q, sv, sn, si, slots)], 6)
    # the two nearest rows, each three times, in scan-step order
    ids = ids.numpy().reshape(2, 2, 3)
    assert (ids // 8 == slots[:, None, :]).all()
    assert (ids % 8 == ids[:, :, :1] % 8).all()


def test_wrapper_limits():
    q, sv, sn, si, slots = (torch.from_numpy(a) for a in _case(6, 24, 10, 3, 2, 1, 0))
    with pytest.raises(LogicError, match="k <= 128"):
        fused_ivf_scan(q, sv, sn, si, slots, 129)
    with pytest.raises(LogicError, match="float32"):
        fused_ivf_scan(q.double(), sv.double(), sn, si, slots, 3)
    with pytest.raises(LogicError, match="int32"):
        fused_ivf_scan(q, sv, sn, si.long(), slots, 3)
    with pytest.raises(LogicError, match="empty scan list"):
        fused_ivf_scan(q, sv, sn, si, slots[:, :0], 3)


# the route of the card on the CPU: (name, S, cap, d, k, nq, n_steps,
# vacancy_rows, entries an item holds).  cap 37 and 70 are not multiples
# of the kernel's 64-row tile, d 13 and 18 not of its k8 step; "crowded"
# has every query probe slot 0 and more queries than three items hold.
ROUTE_CASES = [("k1", 5, 37, 16, 1, 6, 3, 0, 64), ("k128", 8, 40, 18, 128, 5, 5, 2, 64),
               ("small-items", 6, 24, 10, 5, 7, 4, 3, 2), ("d13", 7, 70, 13, 17, 9, 4, 5, 4),
               ("crowded", 4, 70, 12, 20, 150, 2, 3, 64)]


def _route_case(S, cap, d, nq, n_steps, vac, seed=31, crowded=False):
    q, sv, sn, si, slots = _case(S, cap, d, nq, n_steps, seed, vac)
    if crowded:                          # every query with a list probes slot 0
        slots[2:, 0] = 0
        slots[2:, 1] = 1 + np.arange(nq - 2) % (S - 1)
    return q, sv, sn, si, slots


def _route_at(args, k, n_q, accum_bf16=False):
    """The steps of ``fused_ivf_scan`` on a work list of items of at most
    ``n_q`` entries: the inversion, the plain per-item top-k, K2's merge."""
    q, sv, sn, si, slots = (torch.from_numpy(a) for a in args)
    (S, cap, d), (nq, n_steps) = sv.shape, slots.shape
    work = scan_work_list(slots, S, cap, n_q)
    part_d, part_i = ivf_items_plain(q, sv.reshape(S * cap, d), sn.reshape(-1), si.reshape(-1),
                                     work, cap, k, nq * n_steps, accum_bf16)
    out_d, pos = select_tile(part_d.view(nq, n_steps * k), k)
    return out_d, torch.gather(part_i.view(nq, n_steps * k), 1, pos.long())


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: c[0])
def test_route_matches_jax_oracle(case):
    name, S, cap, d, k, nq, n_steps, vac, n_q = case
    args = _route_case(S, cap, d, nq, n_steps, vac, crowded=name == "crowded")
    ref = fused_ivf_scan_xla(*[jnp.asarray(a) for a in args], k)
    got = fused_ivf_scan(*[torch.from_numpy(a) for a in args], k)
    for out in (got, _route_at(args, k, n_q)):
        assert_knn_close(*ref, out[0].numpy(), out[1].numpy(), RTOL, ATOL)
        # the query with nothing to scan, and pad steps past the short list
        assert (out[1][1] == -1).all() and torch.isinf(out[0][1]).all()


def test_route_bf16_matches_jax_bf16_oracle():
    args = _case(8, 40, 18, 9, 5, 23, 2)
    ref = fused_ivf_scan_xla(*[jnp.asarray(a) for a in args], 13, accum_bf16=True)
    got = fused_ivf_scan(*[torch.from_numpy(a) for a in args], 13, accum_bf16=True)
    for out in (got, _route_at(args, 13, 3, accum_bf16=True)):
        assert_knn_close(*ref, out[0].numpy(), out[1].numpy(), 0, BF16_ATOL)


def test_route_ties_across_steps_keep_the_earlier_step():
    # slots 1 and 3 hold the same rows (other ids): each query meets every
    # distance twice, once in each step.  The route keeps the earlier
    # step's copy first, then the smaller row, as the plain version does,
    # and agrees with the JAX oracle up to the order of tied pairs (whose
    # bitonic networks do not keep the step order on every tie); items of
    # two entries split the queries of a slot as well
    sv, sn, si = _slot_store(4, 30, 6, 5)
    sv[3], sn[3] = sv[1], sn[1]
    q = _rand((5, 6), 6)
    slots = np.array([[1, 3, 0], [3, 1, -1], [0, 3, 1], [1, 3, -1], [3, 2, 1]], np.int32)
    args = (q, sv, sn, si, slots)
    ref_d, ref_i = fused_ivf_scan_plain(*[torch.from_numpy(a) for a in args], 24)
    got_d, got_i = fused_ivf_scan(*[torch.from_numpy(a) for a in args], 24)
    for out_d, out_i in ((got_d, got_i), _route_at(args, 24, 2)):
        assert torch.equal(out_i, ref_i) and torch.equal(out_d, ref_d)
    assert_knn_close(*fused_ivf_scan_xla(*[jnp.asarray(a) for a in args], 24),
                     got_d.numpy(), got_i.numpy(), RTOL, ATOL)
    for row, order in enumerate(slots):
        first = [s for s in order if s in (1, 3)][0]
        ids, dist = got_i[row].numpy(), got_d[row].numpy()
        for a in range(len(ids) - 1):
            if ids[a] // 30 in (1, 3) and dist[a] == dist[a + 1]:
                assert ids[a + 1] % 30 == ids[a] % 30 and ids[a] // 30 == first
                break
        else:
            raise AssertionError("row %d: no tied pair" % row)


@pytest.mark.parametrize("n_q", [1, 3, 64])
def test_work_list_names_every_live_entry_once(n_q):
    rng = np.random.default_rng(n_q)
    S, cap, nq, n_steps = 9, 50, 40, 6
    slots = np.stack([rng.permutation(S)[:n_steps] for _ in range(nq)]).astype(np.int32)
    slots[rng.random(slots.shape) < 0.3] = -1
    slots[5] = -1
    slots = torch.from_numpy(slots)
    work = scan_work_list(slots, S, cap, n_q)
    n_items = int(work.n_items)
    assert 0 < n_items <= work.items.shape[0]
    seen = []
    for e0, count, row0, _ in work.items[:n_items].tolist():
        assert 1 <= count <= n_q and row0 % cap == 0
        rows = work.out_rows[e0:e0 + count].long()
        assert (torch.diff(rows) > 0).all()        # queries ascending within a slot
        q, j = rows // work.n_steps, rows % work.n_steps
        assert (slots[q, j] == row0 // cap).all()
        seen += rows.tolist()
    live = torch.nonzero(slots.reshape(-1) >= 0).flatten().tolist()
    assert sorted(seen) == live                     # each live entry in one item
    # the fewest items: ceil(entries / n_q) a slot
    per_slot = torch.bincount(slots[slots >= 0].long(), minlength=S)
    assert n_items == int(((per_slot + n_q - 1) // n_q).sum())


def test_items_plain_leaves_unnamed_rows_unfilled():
    q, sv, sn, si, slots = _case(6, 24, 10, 7, 4, 12, 3)
    S, cap, d = sv.shape
    t = [torch.from_numpy(a) for a in (q, sv.reshape(S * cap, d), sn.reshape(-1), si.reshape(-1))]
    work = scan_work_list(torch.from_numpy(slots), S, cap, 4)
    out_d, out_i = ivf_items_plain(*t, work, cap, 5, 7 * 4)
    named = torch.zeros(7 * 4, dtype=torch.bool)
    named[work.out_rows[:int((torch.from_numpy(slots) >= 0).sum())].long()] = True
    assert torch.isinf(out_d[~named]).all() and (out_i[~named] == -1).all()
    assert (out_i[named] >= 0).all()                # 21 live rows in each slot, k = 5


# (case of ROUTE_CASES, queries a chunk's budget holds; 0: less than one
# query's partial rows, so each chunk takes one query)
CHUNK_CASES = [("crowded", 7), ("crowded", 64), ("k128", 0), ("d13", 2)]


@pytest.mark.parametrize("budget_queries,chunk", [(0, 1), (1, 1), (15, 15), (16, 16), (65, 64),
                                                  (1000, 992)])
def test_chunks_hold_whole_items(budget_queries, chunk, monkeypatch):
    # a chunk of at least one item's queries is a multiple of the item
    # width, so that no slot's last item in a chunk runs part-empty
    n_steps, k = 40, 100
    monkeypatch.setattr(ivf_tile, "PARTIAL_BUDGET_BYTES", budget_queries * n_steps * k * 8 + 7)
    assert ivf_tile.queries_per_chunk(n_steps, k, 16) == chunk


@pytest.mark.parametrize("case", CHUNK_CASES, ids=lambda c: "%s-%d" % c)
def test_chunked_scan_equals_the_unchunked_scan(case, monkeypatch):
    # a budget of a few queries' partial rows cuts the queries into
    # several chunks: no chunk's (rows, k) partial buffers exceed the
    # budget, and the result is the one-chunk scan's.  Not bit for bit on
    # the CPU: the plain per-item products are one bmm an item, and the
    # CPU's bmm rounds a row by a few ulps otherwise at another batch
    # count (the card's kernel computes each entry alone; chip_smoke.py
    # holds its chunked scan bitwise to one chunk)
    name, per_chunk = case
    _, S, cap, d, k, nq, n_steps, vac, _ = next(c for c in ROUTE_CASES if c[0] == name)
    args = [torch.from_numpy(a) for a in _route_case(S, cap, d, nq, n_steps, vac,
                                                     crowded=name == "crowded")]
    whole = fused_ivf_scan(*args, k)
    budget = max(per_chunk * n_steps * k * 8 + 5, 8)
    monkeypatch.setattr(ivf_tile, "PARTIAL_BUDGET_BYTES", budget)
    buffer_rows = []
    items = ivf_tile.ivf_items

    def spy(*a):
        buffer_rows.append(a[7])        # n_out, the rows of the partial buffers
        return items(*a)

    monkeypatch.setattr(ivf_tile, "ivf_items", spy)
    got = fused_ivf_scan(*args, k)
    chunk = max(1, per_chunk)
    assert ivf_tile.queries_per_chunk(n_steps, k, 16) == chunk   # 16 entries an item on the CPU
    assert len(buffer_rows) == -(-nq // chunk) > 1
    assert all(r <= chunk * n_steps for r in buffer_rows)
    assert all(r * k * 8 <= budget for r in buffer_rows) or chunk == 1
    assert_knn_close(whole[0].numpy(), whole[1].numpy(), got[0].numpy(), got[1].numpy(),
                     RTOL, ATOL)
