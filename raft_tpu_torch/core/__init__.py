"""Core runtime of the port: the resource handle, errors, tracing, the
span profiler, metrics and small integer utilities (the JAX package's
``raft_tpu.core`` exports, less its ``profiled_jit``)."""

from raft_tpu_torch.core.error import (AllocationError, CommAbortedError, CommError,
                                       CommTimeoutError, LogicError, RaftError, expects, fail)
from raft_tpu_torch.core.handle import Handle
from raft_tpu_torch.core.metrics import default_registry
from raft_tpu_torch.core.profiler import default_profiler, profiled
from raft_tpu_torch.core.tracing import annotate, range_pop, range_push
from raft_tpu_torch.core.utils import Pow2, align_down, align_to, ceildiv, is_pow2, log2

__all__ = [
    "RaftError",
    "LogicError",
    "AllocationError",
    "CommError",
    "CommAbortedError",
    "CommTimeoutError",
    "expects",
    "fail",
    "Handle",
    "annotate",
    "range_push",
    "range_pop",
    "default_registry",
    "default_profiler",
    "profiled",
    "Pow2",
    "ceildiv",
    "align_to",
    "align_down",
    "is_pow2",
    "log2",
]
