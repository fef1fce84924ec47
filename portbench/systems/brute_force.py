"""System under test: ``raft_tpu_torch.spatial.knn.brute_force_knn`` over
one index on the card."""

from __future__ import annotations

# the kernel libraries this system runs: K1 and K2
KERNELS = ("knn_tile", "select_tile")


class System:

    def __init__(self, config: dict, x, seed: int, device):
        from raft_tpu_torch.distance.distance_type import DistanceType
        self.metric = DistanceType[config["metric"]]
        self.precision = config["precision"]
        self.index = x
        self.device = device

    def call(self, q, k: int):
        from raft_tpu_torch.spatial.knn import brute_force_knn
        return brute_force_knn(self.index, q, k, metric=self.metric,
                               precision=self.precision, device=self.device)

    def judged_state(self):
        """What of the program's own state the reference judges: none."""
        return None
