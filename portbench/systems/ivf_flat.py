"""System under test: an IVF-Flat index built by
``raft_tpu_torch.spatial.ann.ivf_flat_build`` in set-up, searched by
``ivf_flat_search``."""

from __future__ import annotations

# the kernel libraries this system runs: K2 (probe and merge), K3 (the
# scan) and K4 (k-means in the build)
KERNELS = ("select_tile", "ivf_tile", "nn_tile")


class System:

    def __init__(self, config: dict, x, seed: int, device):
        from raft_tpu_torch.distance.distance_type import DistanceType
        from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat_build
        self.nprobe = int(config["nprobe"])
        self.device = device
        self.index = ivf_flat_build(
            x, IVFFlatParams(nlist=int(config["nlist"]), nprobe=self.nprobe),
            metric=DistanceType[config["metric"]], seed=int(seed),
            train_rows=config.get("train_rows"), device=device)

    def call(self, q, k: int):
        from raft_tpu_torch.spatial.ann import ivf_flat_search
        return ivf_flat_search(self.index, q, k, self.nprobe, device=self.device)

    def judged_state(self) -> dict:
        """The index as the reference judges it: the centroids and the
        lists (which rows each slot stores, and their vectors)."""
        return {"centroids": self.index.centroids, "slot_ids": self.index.slot_ids,
                "slot_centroid": self.index.slot_centroid,
                "slot_vecs": self.index.slot_vecs, "list_sizes": self.index.list_sizes}
