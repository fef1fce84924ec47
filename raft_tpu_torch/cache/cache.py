"""LRU set-associative device cache for feature vectors.

Port of ``raft_tpu/cache/cache.py``.  Reference: cache/cache_util.cuh —
``get_vecs``/``get_cache_idx`` (:45), ``store_vecs`` (:86),
``rank_set_entries`` (:205), ``assign_cache_idx`` (:259) and the owning
``cache`` class (cache/cache.cuh).  The reference keeps an (n_vec ×
cache_size) column-major buffer, maps key → set = key % n_sets, and
evicts the least-recently-used way per set.

The cache is a small tuple of tensors (vectors, keys, timestamps, a
clock); lookup is a vectorised equality scan over the key table (sets ×
ways is small) and eviction an argsort of per-way timestamps.  State is
carried functionally, as in the JAX package: each operation returns the
new state and leaves its input untouched.  The JAX package's
``associative_scan`` of a maximum (the start of each set's group carried
forward) is ``torch.cummax`` here, and scatters that may hit one way
twice in a call resolve deterministically: a stamp takes the maximum, a
stored vector the last write.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from raft_tpu_torch.core.device import resolve_device

_INT32_MAX = torch.iinfo(torch.int32).max


class CacheState(NamedTuple):
    vectors: torch.Tensor   # (n_sets, associativity, n_dim)
    keys: torch.Tensor      # (n_sets, associativity) int32, -1 = empty
    time: torch.Tensor      # (n_sets, associativity) int32 LRU stamps
    clock: torch.Tensor     # () int32 global counter


def _scatter_max(table: torch.Tensor, sets: torch.Tensor, ways: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``table.at[sets, ways].max(values)`` on a copy."""
    flat = table.reshape(-1).clone()
    flat.scatter_reduce_(0, (sets * table.shape[1] + ways).long(),
                         values.to(table.dtype), reduce="amax")
    return flat.view_as(table)


def _last_writes(flat_idx: torch.Tensor, size: int) -> torch.Tensor:
    """Mask of the entries that are the last write to their index in
    [0, size)."""
    order = torch.arange(flat_idx.shape[0], device=flat_idx.device)
    last = torch.full((size,), -1, dtype=torch.int64, device=flat_idx.device)
    last.scatter_reduce_(0, flat_idx, order, reduce="amax")
    return last[flat_idx] == order


class VecCache:
    """Functional set-associative vector cache (reference cache.cuh:40).

    Parameters
    ----------
    n_dim: vector dimensionality.
    n_vecs: cache capacity in vectors (rounded down to a multiple of
        ``associativity``).
    associativity: ways per set (reference ``associativity`` = 32).
    dtype / device: of the stored vectors (``device`` defaults to
        ``"cuda"`` and raises when CUDA is missing; pass ``"cpu"`` for
        the host).
    """

    def __init__(self, n_dim: int, n_vecs: int, associativity: int = 32,
                 dtype=torch.float32, device="cuda"):
        self.n_dim = n_dim
        self.assoc = min(associativity, max(n_vecs, 1))
        self.n_sets = max(n_vecs // self.assoc, 1)
        self.dtype = dtype
        self.device = resolve_device(device)

    def init(self) -> CacheState:
        dev = self.device
        return CacheState(
            vectors=torch.zeros((self.n_sets, self.assoc, self.n_dim),
                                dtype=self.dtype, device=dev),
            keys=torch.full((self.n_sets, self.assoc), -1, dtype=torch.int32,
                            device=dev),
            time=torch.zeros((self.n_sets, self.assoc), dtype=torch.int32,
                             device=dev),
            clock=torch.zeros((), dtype=torch.int32, device=dev),
        )

    # ------------------------------------------------------------------ #
    def get_vecs(self, state: CacheState, keys: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, CacheState]:
        """Fetch vectors for ``keys`` (reference get_vecs, cache_util.cuh:45).

        Returns (vectors (m, n_dim), found (m,) bool, state with refreshed
        LRU stamps).  Missing keys return zero vectors.
        """
        keys = keys.to(device=self.device, dtype=torch.int32)
        sets = torch.remainder(keys, self.n_sets)
        hit = state.keys[sets] == keys[:, None]            # (m, assoc)
        way = hit.to(torch.int32).argmax(dim=1)
        found = hit.any(dim=1)
        vecs = state.vectors[sets, way]
        vecs = torch.where(found[:, None], vecs, torch.zeros_like(vecs))
        new_clock = state.clock + 1
        stamped = _scatter_max(state.time, sets, way,
                               torch.where(found, new_clock, 0))
        return vecs, found, state._replace(time=stamped, clock=new_clock)

    def store_vecs(self, state: CacheState, keys: torch.Tensor,
                   vecs: torch.Tensor) -> CacheState:
        """Insert vectors (reference assign_cache_idx + store_vecs,
        cache_util.cuh:259,86): keys mapping to the same set within one
        call take successive least-recently-used ways (the
        ``rank_set_entries`` ranking, :205); an existing key updates its
        own way.  Duplicate *keys* in one call: last write wins.
        """
        dev = self.device
        keys = keys.to(device=dev, dtype=torch.int32)
        m = keys.shape[0]
        sets = torch.remainder(keys, self.n_sets)
        hit = state.keys[sets] == keys[:, None]
        # rank of each *miss* key within its set group for this call (hit
        # keys use their own way and must not consume LRU slots)
        any_hit = hit.any(dim=1)
        order = torch.argsort(sets, stable=True)
        sorted_sets = sets[order]
        miss_sorted = (~any_hit[order]).to(torch.int32)
        first = torch.cat([torch.ones(min(m, 1), dtype=torch.bool, device=dev),
                           sorted_sets[1:] != sorted_sets[:-1]])
        incl = torch.cumsum(miss_sorted, dim=0, dtype=torch.int32)
        # exclusive miss-count at each group start, carried forward
        start = torch.where(first, incl - miss_sorted, torch.zeros_like(incl))
        base = torch.cummax(start, dim=0).values if m else start
        rank = torch.zeros(m, dtype=torch.int32, device=dev)
        rank[order] = incl - miss_sorted - base
        # ways of each set ordered least-recently-used first; ways hit
        # in this call sort last, and misses wrap only among the
        # remaining free ways, so a new key never evicts an entry this
        # call refreshed unless every way of the set was hit
        hit_way = hit.to(torch.int32).argmax(dim=1)
        time_adj = _scatter_max(state.time, sets, hit_way,
                                torch.where(any_hit, _INT32_MAX, -1))
        # hits per set in this call = number of *distinct ways* hit
        hit_mark = _scatter_max(
            torch.zeros((self.n_sets, self.assoc), dtype=torch.int32, device=dev),
            sets, hit_way, any_hit.to(torch.int32))
        hits_per_set = hit_mark.sum(dim=1)
        free_ways = torch.clamp(self.assoc - hits_per_set[sets], min=1)
        lru_order = torch.argsort(time_adj[sets], dim=1, stable=True)
        lru_way = torch.gather(lru_order, 1,
                               torch.remainder(rank, free_ways)[:, None].long())[:, 0]
        way = torch.where(any_hit, hit_way.long(), lru_way)
        new_clock = state.clock + 1
        flat = sets.long() * self.assoc + way
        keep = _last_writes(flat, self.n_sets * self.assoc)
        s, w = sets[keep].long(), way[keep]
        vectors = state.vectors.clone()
        vectors[s, w] = vecs.to(device=dev, dtype=self.dtype)[keep]
        new_keys = state.keys.clone()
        new_keys[s, w] = keys[keep]
        time = state.time.clone()
        time[s, w] = new_clock
        return CacheState(vectors=vectors, keys=new_keys, time=time,
                          clock=new_clock)
