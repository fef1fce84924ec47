"""Sparse formats, conversions, element ops, linear algebra, distances,
selection, the MST and single-linkage clustering.

Port of ``raft_tpu/sparse`` (the reference's ``raft::sparse``,
cpp/include/raft/sparse/): fixed-capacity COO and CSR containers
(:mod:`~raft_tpu_torch.sparse.formats`), their conversions, sorting,
deduplication and filtering, row norms, add, transpose, symmetrize, the
SpMV and SpMM, weakly connected components, ``fit_embedding``; pairwise
distances over CSR (:mod:`~raft_tpu_torch.sparse.distance`, K5 and
IEEE products), the sparse brute-force kNN and the kNN graph
(:mod:`~raft_tpu_torch.sparse.selection`, K2 and K1), Borůvka's MST
(:mod:`~raft_tpu_torch.sparse.mst`), the components fix-up
(:mod:`~raft_tpu_torch.sparse.linkage`) and ``single_linkage``
(:mod:`~raft_tpu_torch.sparse.hierarchy`).
"""

from raft_tpu_torch.sparse import convert, linalg, op, spectral
from raft_tpu_torch.sparse import distance, selection
from raft_tpu_torch.sparse import hierarchy, linkage, mst
from raft_tpu_torch.sparse.formats import COO, CSR

__all__ = ["COO", "CSR", "convert", "distance", "hierarchy", "linalg", "linkage", "mst", "op",
           "selection", "spectral"]
