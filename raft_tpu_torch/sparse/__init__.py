"""Sparse formats, conversions, element ops, linear algebra and the
spectral embedding.

Port of ``raft_tpu/sparse`` (the reference's ``raft::sparse``,
cpp/include/raft/sparse/): fixed-capacity COO and CSR containers
(:mod:`~raft_tpu_torch.sparse.formats`), their conversions, sorting,
deduplication and filtering, row norms, add, transpose, symmetrize, the
SpMV and SpMM, weakly connected components, and ``fit_embedding``.  The
single-linkage half of the JAX package (sparse distances, the kNN-graph
selection, MST, linkage and the dendrogram) is not ported yet.
"""

from raft_tpu_torch.sparse import convert, linalg, op, spectral
from raft_tpu_torch.sparse.formats import COO, CSR

__all__ = ["COO", "CSR", "convert", "linalg", "op", "spectral"]
