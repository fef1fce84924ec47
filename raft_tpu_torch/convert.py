"""State carried between the JAX package and the port.

This system has no weights; its state is the index: the partitions, their
id translations and the metric.  :func:`from_reference` turns the JAX
package's arrays (as numpy, after ``np.asarray``) into the port's tensors
on a device, keeping dtype and layout (ids stay int32);
:func:`to_numpy` goes the other way.  Both walk lists, tuples and dicts.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device


def from_reference(arrays, device="cuda"):
    """numpy arrays (or nested lists/tuples/dicts of them) as tensors on
    ``device``; scalars such as a metric id or a translation pass as they
    are."""
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {key: conv(v) for key, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(conv(v) for v in a)
        if isinstance(a, numbers.Number):
            return a
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(dev)

    return conv(arrays)


def to_numpy(tensors):
    """Tensors (or nested lists/tuples/dicts of them) as numpy arrays."""
    if isinstance(tensors, dict):
        return {key: to_numpy(v) for key, v in tensors.items()}
    if isinstance(tensors, (list, tuple)):
        return type(tensors)(to_numpy(v) for v in tensors)
    if isinstance(tensors, torch.Tensor):
        return tensors.detach().cpu().numpy()
    return np.asarray(tensors)
