"""Resolution of the ``device=`` argument of the public entry points.

Every entry point takes ``device=`` (default ``"cuda"``) and moves numpy
arrays or tensors there.  Asking for CUDA where there is none raises: the
port never carries on quietly on the CPU.  Pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.error import RaftError


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises :class:`RaftError`
    when a CUDA device is asked for and CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RaftError(
            "device=%r asked for CUDA, but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
            % (str(device),), collect_stack=False)
    return dev


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(device=device, dtype=dtype).contiguous()
