"""Random number generation (reference cpp/include/raft/random/rng.hpp)."""

from raft_tpu_torch.random.rng import GeneratorType, Rng

__all__ = ["GeneratorType", "Rng"]
