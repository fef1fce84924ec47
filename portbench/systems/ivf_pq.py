"""System under test: an IVF-PQ index built by
``raft_tpu_torch.spatial.ann.ivf_pq_build`` in set-up (keeping its vectors
for the exact re-rank), searched by ``ivf_pq_search``."""

from __future__ import annotations

# the kernel libraries this system runs: K2 (the probe, the re-rank's
# select and the scan's select where it takes k <= 128) and K4 (k-means
# in the build: the coarse quantizer and the codebooks)
KERNELS = ("select_tile", "nn_tile")


class System:

    def __init__(self, config: dict, x, seed: int, device):
        from raft_tpu_torch.distance.distance_type import DistanceType
        from raft_tpu_torch.spatial.ann import IVFPQParams, ivf_pq_build
        self.nprobe = int(config["nprobe"])
        self.device = device
        params = IVFPQParams(nlist=int(config["nlist"]), nprobe=self.nprobe,
                             M=int(config["pq_dim"]), n_bits=int(config["pq_bits"]),
                             refine_ratio=int(config["refine_ratio"]))
        self.index = ivf_pq_build(x, params, metric=DistanceType[config["metric"]],
                                  seed=int(seed), train_rows=config.get("train_rows"),
                                  device=device)

    def call(self, q, k: int):
        from raft_tpu_torch.spatial.ann import ivf_pq_search
        return ivf_pq_search(self.index, q, k, self.nprobe, device=self.device)

    def judged_state(self) -> dict:
        """The index as the reference judges it: the coarse centroids, the
        codebooks, the lists (which rows each slot stores, and their
        codes), and the stored vectors of the re-rank."""
        ix = self.index
        return {"centroids": ix.centroids, "codebooks": ix.codebooks,
                "slot_codes": ix.slot_codes, "slot_ids": ix.slot_ids,
                "slot_centroid": ix.slot_centroid, "list_sizes": ix.list_sizes,
                "vectors": ix.vectors}
