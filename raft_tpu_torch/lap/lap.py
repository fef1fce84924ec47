"""Linear Assignment Problem: min-cost perfect matching on a cost matrix.

Port of ``raft_tpu/lap/lap.py`` (reference lap/lap.cuh:37
``LinearAssignmentProblem``, the Date-Nagi GPU Hungarian variant over a
batch of SP x N x N problems).  The JAX package replaces the Hungarian
algorithm's augmenting paths by the auction algorithm (Bertsekas) with
epsilon scaling, and so does the port, with the same rules:

- a round: every unassigned row bids for its best column, by the gap
  between its best and second-best value plus epsilon (one two-max
  reduction over an (n, n) matrix); each column takes its highest bid,
  the smallest row among equal bids, displaces its owner and raises its
  price by the bid;
- a phase: rounds from an empty assignment until every row is assigned;
  epsilon starts at half the cost spread and falls by 5 a phase down to
  1e-6 of the spread;
- at most ``max_rounds`` rounds in all (0: 200 n + 2000), after which
  the assignment may be incomplete (``complete`` False, objective +inf).

A batch runs its problems side by side, each with its own epsilon and
phase, in one Python loop of rounds with one host read a round (whether
any problem still bids).  Both entry points take ``handle=`` or
``device=`` (:func:`raft_tpu_torch.core.handle.takes_handle`, default
``"cuda"``).  Where the optimum is tied, the assignment may differ from
the JAX package's; the objective does not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import takes_handle


class LapResult(NamedTuple):
    row_assignment: torch.Tensor  # (n,) int32 column of each row, -1 if none
    col_assignment: torch.Tensor  # (n,) int32 row of each column, -1 if none
    obj_val: torch.Tensor         # the primal objective; +inf when incomplete
    row_duals: torch.Tensor       # (n,)
    col_duals: torch.Tensor       # (n,) minus the auction prices
    complete: torch.Tensor        # bool: every row assigned


def _col_of_row(row_of_col: torch.Tensor) -> torch.Tensor:
    """(B, n) column assigned to each row, -1 where none."""
    valid = row_of_col >= 0
    cols = torch.arange(row_of_col.shape[1], device=row_of_col.device).expand_as(row_of_col)
    out = torch.full_like(row_of_col, -1)
    return out.scatter_reduce(1, torch.where(valid, row_of_col, 0).long(),
                              torch.where(valid, cols, -1).to(out.dtype), "amax")


def _auction_round(cost, eps, row_of_col, price, bidding):
    """One synchronous round of every unassigned row of the problems that
    are ``bidding`` (B,); the others are left as they are."""
    B, n, _ = cost.shape
    unassigned = (_col_of_row(row_of_col) < 0) & bidding[:, None]
    value = -(cost + price[:, None, :])
    best_v, best_j = value.max(dim=2)
    masked = value.scatter(2, best_j[:, :, None], float("-inf"))
    second_v = masked.max(dim=2).values
    second_v = torch.where(torch.isfinite(second_v), second_v, best_v - eps[:, None])
    bid = best_v - second_v + eps[:, None]
    # per column the highest bid of an unassigned row, and the smallest row
    # among those that bid it
    bid_masked = torch.where(unassigned, bid, float("-inf"))
    col_bid = torch.full_like(price, float("-inf")).scatter_reduce(1, best_j, bid_masked, "amax")
    winner = unassigned & (bid_masked == col_bid.gather(1, best_j))
    rows = torch.arange(n, device=cost.device).expand(B, n)
    win_row = torch.full((B, n), n, dtype=torch.int64, device=cost.device).scatter_reduce(
        1, best_j, torch.where(winner, rows, n), "amin")
    newly = (win_row < n) & torch.isfinite(col_bid)
    return (torch.where(newly, win_row.to(torch.int32), row_of_col),
            torch.where(newly, price + col_bid, price))


def _solve(cost: torch.Tensor, max_rounds: int) -> LapResult:
    """The auction over a batch (B, n, n) of problems (module doc)."""
    B, n, _ = cost.shape
    dev = cost.device
    spread = torch.clamp(cost.amax(dim=(1, 2)) - cost.amin(dim=(1, 2)), min=1.0)
    eps, eps_min = spread / 2.0, spread * 1e-6
    cap = max_rounds if max_rounds else 200 * n + 2000
    row_of_col = torch.full((B, n), -1, dtype=torch.int32, device=dev)
    price = torch.zeros((B, n), dtype=cost.dtype, device=dev)
    rounds = torch.zeros(B, dtype=torch.int64, device=dev)
    fresh = torch.ones(B, dtype=torch.bool, device=dev)     # a phase to start
    while True:
        phase = (eps >= eps_min * 0.99) & (rounds < cap)
        # a phase starts from an empty assignment
        row_of_col = torch.where((fresh & phase)[:, None], -1, row_of_col)
        fresh = fresh & ~phase
        bidding = phase & ((row_of_col >= 0).sum(dim=1) < n)
        done = phase & ~bidding                  # every row assigned at this epsilon
        eps = torch.where(done, eps / 5.0, eps)
        fresh = fresh | done
        if not bool(phase.any()):
            break
        if bool(bidding.any()):
            row_of_col, price = _auction_round(cost, eps, row_of_col, price, bidding)
            rounds = rounds + bidding
    col_of_row = _col_of_row(row_of_col)
    complete = (col_of_row >= 0).all(dim=1)
    chosen = cost.gather(2, torch.clamp(col_of_row, min=0).long()[:, :, None])[:, :, 0]
    obj = torch.where(complete, chosen.sum(dim=1), float("inf"))
    v = -price
    u = (cost - v[:, None, :]).amin(dim=2)
    return LapResult(col_of_row, row_of_col, obj, u, v, complete)


@takes_handle
def solve_lap(cost: torch.Tensor, max_rounds: int = 0) -> LapResult:
    """Min-cost assignment of a square cost matrix (n, n): assignments
    both ways, the objective and the dual prices (reference
    ``LinearAssignmentProblem::solve`` and its getters, lap.cuh:89-160).
    Optimal to within n times the last epsilon (1e-6 of the cost spread)."""
    expects(cost.ndim == 2 and cost.shape[0] == cost.shape[1],
            "solve_lap: square cost matrix required")
    res = _solve(cost[None], max_rounds)
    return LapResult(*(t[0] for t in res))


class LinearAssignmentProblem:
    """Batch LAP solver (reference lap/lap.cuh:37, SP subproblems).
    ``solve(costs, device=...)`` takes (batch, n, n) or (n, n)."""

    def __init__(self, max_rounds: int = 0):
        self.max_rounds = max_rounds

    def solve(self, costs, *, handle=None, device=None) -> LapResult:
        if getattr(costs, "ndim", None) == 2:
            return solve_lap(costs, self.max_rounds, handle=handle, device=device)
        return _solve_batch(costs, self.max_rounds, handle=handle, device=device)


@takes_handle
def _solve_batch(costs: torch.Tensor, max_rounds: int) -> LapResult:
    expects(costs.ndim == 3 and costs.shape[1] == costs.shape[2],
            "LinearAssignmentProblem: (SP, N, N) costs")
    return _solve(costs, max_rounds)
