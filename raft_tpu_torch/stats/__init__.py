"""Summary statistics (port of ``raft_tpu/stats``; reference
cpp/include/raft/stats/).  Every function takes ``handle=`` or
``device=`` (default ``"cuda"``)."""

from raft_tpu_torch.stats.stats import mean, mean_add, mean_center, stddev, sum_cols, vars_

__all__ = ["mean", "stddev", "vars_", "sum_cols", "mean_center", "mean_add"]
