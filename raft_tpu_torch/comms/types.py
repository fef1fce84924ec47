"""Communicator datatypes, reduction ops and status codes.

Port of ``raft_tpu/comms/types.py`` (reference
cpp/include/raft/comms/comms.hpp:28-89): ``Op`` (SUM/PROD/MIN/MAX),
``Status`` (SUCCESS/ERROR/ABORT), ``Datatype`` and :func:`get_type`,
which maps a torch or numpy dtype to its wire id.  The datatype travels
with the tensor, so ``Datatype`` exists for API parity and for consumers
that serialise communicator descriptions.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from raft_tpu_torch.core.error import fail


class Op(enum.IntEnum):
    """Reduction operator (reference op_t, comms.hpp:34)."""

    SUM = 0
    PROD = 1
    MIN = 2
    MAX = 3


class Status(enum.IntEnum):
    """Result of :meth:`~raft_tpu_torch.comms.host_comms.HostComms.sync_stream`
    (reference status_t, comms.hpp:41).

    SUCCESS: all work completed.  ERROR: an error occurred in this
    participant's queued work.  ABORT: an error was observed on another
    participant / the communicator is no longer usable.
    """

    SUCCESS = 0
    ERROR = 1
    ABORT = 2


class Datatype(enum.IntEnum):
    """Wire datatype ids (reference datatype_t, comms.hpp:28)."""

    CHAR = 0
    UINT8 = 1
    INT32 = 2
    UINT32 = 3
    INT64 = 4
    UINT64 = 5
    FLOAT32 = 6
    FLOAT64 = 7


_DTYPE_MAP = {
    np.dtype(np.int8): Datatype.CHAR,
    np.dtype(np.uint8): Datatype.UINT8,
    np.dtype(np.int32): Datatype.INT32,
    np.dtype(np.uint32): Datatype.UINT32,
    np.dtype(np.int64): Datatype.INT64,
    np.dtype(np.uint64): Datatype.UINT64,
    np.dtype(np.float32): Datatype.FLOAT32,
    np.dtype(np.float64): Datatype.FLOAT64,
}

_TORCH_MAP = {
    torch.int8: Datatype.CHAR,
    torch.uint8: Datatype.UINT8,
    torch.int32: Datatype.INT32,
    torch.int64: Datatype.INT64,
    torch.float32: Datatype.FLOAT32,
    torch.float64: Datatype.FLOAT64,
}
# the unsigned 32- and 64-bit tensors exist in newer torch releases only
for _name, _wire in (("uint32", Datatype.UINT32), ("uint64", Datatype.UINT64)):
    if hasattr(torch, _name):
        _TORCH_MAP[getattr(torch, _name)] = _wire


def get_type(dtype) -> Datatype:
    """Map a torch or numpy dtype to its wire id (reference
    get_type<T>(), comms.hpp:62-89).

    Unsupported dtypes raise :class:`~raft_tpu_torch.core.error.LogicError`
    naming the dtype: the runtime analog of the reference's compile-time
    error for an unmapped ``get_type<T>()`` instantiation.
    """
    if isinstance(dtype, torch.dtype):
        wire = _TORCH_MAP.get(dtype)
        shown = dtype
    else:
        try:
            shown = np.dtype(dtype)
        except TypeError:
            shown = dtype
            wire = None
        else:
            wire = _DTYPE_MAP.get(shown)
    if wire is None:
        fail("get_type: dtype %s has no communicator wire type (supported: %s)", shown,
             ", ".join(str(k) for k in _DTYPE_MAP))
    return wire
