"""Linear Assignment Problem solver (reference cpp/include/raft/lap/)."""

from raft_tpu_torch.lap.lap import LapResult, LinearAssignmentProblem, solve_lap

__all__ = ["LapResult", "LinearAssignmentProblem", "solve_lap"]
