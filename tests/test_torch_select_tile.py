"""K2 (``raft_tpu_torch.ops.select_tile``): its contract, its plain
version against the JAX ``select_tile`` (interpret mode), and a CPU
emulation of the kernel's routes.

The contract (module doc): the first k of a stable ascending sort in
which -0.0 equals +0.0 and NaN is above every key; a NaN is never
returned, the slots a row cannot fill with other keys are (+inf, w - 1).
The kernel holds a row of up to ``HELD_MAX`` keys in one block, and cuts
a held row of over 2048 keys down to the keys at or below a bound from a
sample of it.  A wider row goes through two passes: a filter over (row,
chunk) blocks (``wide_chunks`` a row, the mirror of
``csrc/select_tile.cu:select_tile_plan``) that keeps the keys at or
below a bound from a sample of the row, and a select from what was kept,
or from the whole row where the sample misled.  The emulation below
does the same with sorts and must equal the plain version bit for bit,
and keep few enough keys that no row falls back on the keys the paths
select from.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops.select_tile import select_tile as jax_select_tile
from raft_tpu_torch import knn_merge_parts
from raft_tpu_torch.ops.select_tile import (CHUNK_MIN, FILL_BLOCKS, HELD_MAX, order_keys,
                                            select_tile, select_tile_plain, wide_chunks)

N_SMS = 132          # an H100's SM count: the geometry the card takes


def _rule(keys, k):
    """The contract, one row at a time in Python: non-NaN keys sorted by
    (value, column), Python's float order taking -0.0 == +0.0."""
    m, w = keys.shape
    vals = np.full((m, k), np.inf, np.float32)
    ids = np.full((m, k), w - 1, np.int32)
    for r in range(m):
        items = sorted((float(v), c) for c, v in enumerate(keys[r]) if not math.isnan(v))
        for s, (_, c) in enumerate(items[:k]):
            vals[r, s], ids[r, s] = keys[r, c], c
    return vals, ids


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_same(got, want):
    """Values bit for bit (the sign of a zero included) and ids."""
    gv, gi = got
    wv, wi = (torch.as_tensor(x) for x in want)
    assert torch.equal(_bits(gv), _bits(wv)), (gv, wv)
    assert torch.equal(gi, wi.to(torch.int32)), (gi, wi)


def _contract_rows():
    w = 300
    rng = np.random.default_rng(0)
    keys = rng.standard_normal((6, w)).astype(np.float32)
    keys[0, 3:] = np.nan                     # 3 keys, then fillers
    keys[1, 17] = np.nan                     # one NaN among 299 keys
    keys[2, :] = np.nan                      # nothing but fillers
    keys[3, ::2] = np.inf                    # +inf keys keep their ids ...
    keys[3, 1::4] = np.nan                   # ... and come before the fillers
    keys[4, :] = np.where(rng.random(w) < 0.5, -0.0, 0.0)  # signed zeros tie
    keys[4, 7] = -1.0
    keys[5, 10:20] = -np.nan                 # a NaN with its sign bit set
    return keys


@pytest.mark.parametrize("k", [1, 5, 100, 128])
def test_plain_follows_the_contract(k):
    keys = _contract_rows()
    _assert_same(select_tile_plain(torch.from_numpy(keys), k), _rule(keys, k))


def test_nan_row_with_few_keys():
    # the case that told the two versions apart: 3 keys, the rest NaN, k 5
    keys = np.array([[np.nan, 2.0, np.nan, 0.5, 1.0, np.nan, np.nan]], np.float32)
    v, i = select_tile(torch.from_numpy(keys), 5)
    assert v.tolist() == [[0.5, 1.0, 2.0, np.inf, np.inf]]
    assert i.tolist() == [[3, 4, 1, 6, 6]]


def test_width_equal_to_k():
    keys = _contract_rows()[:, :128]
    _assert_same(select_tile_plain(torch.from_numpy(keys), 128), _rule(keys, 128))


def test_order_keys_order_floats():
    vals = np.array([-np.inf, -3.5, -1e-40, -0.0, 0.0, 1e-40, 2.0, np.inf], np.float32)
    img = order_keys(torch.from_numpy(vals))
    assert (img[1:] >= img[:-1]).all() and int(img[3]) == int(img[4])
    assert int(order_keys(torch.tensor([np.nan]))[0]) > int(img[-1])


# csrc/select_tile.cu: a held row's filter threshold, candidate room and
# sample stride; a wide row's sample (SAMPLE_RUNS runs of SAMPLE_RUN keys)
# and candidate room; the samples a bound's bucket is resolved to
HELD_FILTER_MIN, HELD_CAND_CAP, HELD_STRIDE = 2048, 1024, 8
SAMPLE_RUNS, SAMPLE_RUN, ROW_CAP, THIN = 32, 128, 4096, 4


def sample_columns(w):
    """The columns of a wide row's sample (``seg_start``): SAMPLE_RUNS runs
    of SAMPLE_RUN keys spread evenly from the first column to the last."""
    starts = torch.arange(SAMPLE_RUNS, dtype=torch.int64) * (w - SAMPLE_RUN) // (SAMPLE_RUNS - 1)
    return (starts[:, None] + torch.arange(SAMPLE_RUN)).reshape(-1)


def sample_share(k, n_sample, w):
    """kq: a quarter above the sample's share of k, plus 16."""
    return min(n_sample, (5 * k * n_sample + 4 * w - 1) // (4 * w) + 16)


def _sample_bound(img, cols, kq, w):
    """sample_bound on the composites (image << 32 | column) of a sample:
    the top of the bucket of its kq-th smallest, resolved digit by digit
    (the image's bytes, then the column's) until all of the bucket is
    needed or (past the first digit) at most THIN samples share it."""
    comp = sorted((int(i) << 32) | int(c) for i, c in zip(img.tolist(), cols.tolist()))
    pos_bytes = ((w - 1).bit_length() + 7) // 8
    shifts = [56, 48, 40, 32] + [8 * b for b in range(pos_bytes - 1, -1, -1)]
    kth, need, prev = comp[kq - 1], kq, 64
    for j, shift in enumerate(shifts):
        play = [x for x in comp if x >> prev == kth >> prev]    # in the bucket so far
        in_bucket = sum(1 for x in play if x >> shift == kth >> shift)
        need -= sum(1 for x in play if x >> shift < kth >> shift)
        if in_bucket == need or (j >= 1 and in_bucket <= THIN) or j == len(shifts) - 1:
            return (((kth >> shift) + 1) << shift) - 1
        prev = shift
    raise AssertionError("unreachable")


def _select_sorted(img, cols, k):
    """The columns of the k smallest (image, column) composites, sorted."""
    return torch.tensor([c for _, c in sorted(zip(img.tolist(), cols.tolist()))[:k]])


def _emulate(keys, k, n_sms=N_SMS):
    """The kernel's routes with sorts: per row, a bound from the sample,
    the keys at or below it, the k smallest of those (of the whole row
    where fewer than k or more than the room were kept).  Returns the
    result and the rows that fell back."""
    m, w = keys.shape
    img_all, cols = order_keys(keys), torch.arange(w)
    out_v, out_i, fell = [], [], []
    for r in range(m):
        img = img_all[r]
        if w > HELD_MAX:
            assert wide_chunks(m, w, n_sms) >= 1
            at, room = sample_columns(w), ROW_CAP
        elif w > HELD_FILTER_MIN:
            at, room = torch.arange(HELD_STRIDE - 1, w, HELD_STRIDE), HELD_CAND_CAP
        else:
            at = None
        if at is None:
            pick = _select_sorted(img, cols, k)
        else:
            bound = _sample_bound(img[at], at, sample_share(k, len(at), w), w)
            kept = torch.tensor([((int(i) << 32) | int(c)) <= bound
                                 for i, c in zip(img.tolist(), cols.tolist())])
            if k <= int(kept.sum()) <= room:
                pick = _select_sorted(img[kept], cols[kept], k)
            else:
                fell.append(r)
                pick = _select_sorted(img, cols, k)
        v = keys[r][pick]
        nan = torch.isnan(v)
        out_v.append(torch.where(nan, torch.full_like(v, float("inf")), v))
        out_i.append(torch.where(nan, torch.full_like(pick, w - 1), pick))
    return (torch.stack(out_v), torch.stack(out_i).to(torch.int32)), fell


def _path_keys(kind, m, w, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":                       # 4 distinct values: ties cross every chunk
        return rng.integers(0, 4, (m, w)).astype(np.float32)
    if kind in ("runs", "runs128"):          # sorted runs: K1's splits (100), K6's tiles (128)
        run = 128 if kind == "runs128" else 100
        keys = np.sort(rng.standard_normal((m, -(-w // run), run)), axis=2).reshape(m, -1)
        return keys[:, :w].astype(np.float32)
    keys = rng.standard_normal((m, w)).astype(np.float32)
    if kind == "nan":                        # NaN, +inf and signed zeros sprinkled
        keys[rng.random((m, w)) < 0.3] = np.nan
        keys[rng.random((m, w)) < 0.05] = np.inf
        keys[rng.random((m, w)) < 0.05] = -0.0
        keys[0, :] = np.nan
        keys[1, 5:] = np.nan
    return keys


@pytest.mark.parametrize("kind", ["ties", "runs", "runs128", "nan", "normal"])
@pytest.mark.parametrize("m,w,k", [(2, 13_200, 100), (2, 62_592, 128), (3, 5_000, 32),
                                   (2, 9_000, 1)], ids=lambda v: str(v))
def test_routes_equal_plain(kind, m, w, k):
    keys = torch.from_numpy(_path_keys(kind, m, w, seed=m + w + k))
    got, fell = _emulate(keys, k)
    _assert_same(got, select_tile_plain(keys, k))
    # the keys the paths select from never send a row the slow way (four
    # distinct values may: the bound's bucket holds a quarter of the row)
    if kind in ("runs", "runs128", "normal"):
        assert fell == [], fell


@pytest.mark.parametrize("m", [1, 8, 64, 130, 1024])
def test_wide_chunks_geometry(m):
    # a block of the wide filter streams a whole row where the rows fill
    # the card, and chunks of CHUNK_MIN keys or more where they are few
    for w in (100, 8_192, 8_193, 13_200, 62_592, 100_000, 3_000_000):
        chunks = wide_chunks(m, w, N_SMS)
        if w <= HELD_MAX:
            assert chunks == 0
            continue
        assert 1 <= chunks <= -(-w // CHUNK_MIN)
        assert m * chunks >= min(FILL_BLOCKS * N_SMS, m * -(-w // CHUNK_MIN))
        if m >= FILL_BLOCKS * N_SMS:
            assert chunks == 1


def test_sample_columns_spread():
    cols = sample_columns(100_000)
    assert len(cols) == 4096 and int(cols[0]) == 0 and int(cols[-1]) == 99_999
    assert bool((cols[1:] > cols[:-1]).all())


@pytest.mark.parametrize("m,w,k", [(5, 300, 37), (4, 129, 128), (3, 257, 1)],
                         ids=lambda v: str(v))
def test_plain_matches_jax_select_tile(m, w, k):
    # tie-heavy keys, no NaN: the same k smallest values; the JAX kernel
    # does not promise the smaller column among equal keys, so an id is
    # held to point at a key of its slot's value, and the ids of keys
    # below the k-th value to be the same set
    keys = _path_keys("ties", m, w, seed=k)
    keys[0, : w - k + 3] = np.inf            # +inf keys reach into the result
    ref_v, ref_i = (np.asarray(a) for a in
                    jax_select_tile(jnp.asarray(keys, jnp.float32), k, interpret=True))
    got_v, got_i = (a.numpy() for a in select_tile_plain(torch.from_numpy(keys), k))
    np.testing.assert_array_equal(got_v, ref_v)
    for r in range(m):
        assert len(np.unique(got_i[r])) == k
        np.testing.assert_array_equal(keys[r, got_i[r]], got_v[r])
        below = got_v[r] < got_v[r, -1]
        assert set(got_i[r][below]) == set(ref_i[r][below])


@pytest.mark.parametrize("form", ["list", "numpy", "tensor"])
def test_merge_parts_translations(form):
    # knn_merge_parts (K2 over the partitions' results) adds each
    # partition's offset to its ids, however the offsets come
    rng = np.random.default_rng(11)
    pd = torch.from_numpy(np.sort(rng.random((3, 5, 7), dtype=np.float32), axis=2))
    pi = torch.from_numpy(rng.integers(0, 100, (3, 5, 7)).astype(np.int32))
    offsets = [0, 1000, 5000]
    trans = {"list": offsets, "numpy": np.array(offsets),
             "tensor": torch.tensor(offsets, dtype=torch.int32)}[form]
    got_d, got_i = knn_merge_parts(pd, pi, 9, translations=trans, device="cpu")
    cand_d = pd.permute(1, 0, 2).reshape(5, 21)
    cand_i = (pi + torch.tensor(offsets, dtype=torch.int32)[:, None, None]).permute(1, 0, 2)
    want_d, pos = select_tile_plain(cand_d, 9)
    assert torch.equal(got_d, want_d)
    assert torch.equal(got_i, torch.gather(cand_i.reshape(5, 21), 1, pos.long()))
