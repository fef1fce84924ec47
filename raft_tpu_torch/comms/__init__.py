"""The communicator over a mesh of rank slots.

Port of ``raft_tpu/comms`` (reference cpp/include/raft/comms/:
``comms_t``/``comms_iface``, comms.hpp:91,193, with its NCCL+UCX and MPI
implementations injected into the handle, handle.hpp:229).  The JAX
package is single-controller, and so is the port inside a process: one
process drives every rank of its own.  A :class:`Mesh` names axes over
rank slots, each bound to a ``torch.device`` (several may share a card);
:class:`MeshComms` defines each verb once over a list of per-rank
tensors, and :class:`HostComms` runs it eagerly on rank-major data with
tagged p2p, ``comm_split`` and a status-returning ``sync_stream``.
:func:`build_comms` injects a communicator into a
:class:`~raft_tpu_torch.core.handle.Handle` (reference helper.hpp:39
build_comms_nccl_only).

Failure contract: verbs on a latched-aborted communicator fail fast with
:class:`CommAbortedError`; an optional :class:`RetryPolicy` retries
transient failures with deterministic backoff and a watchdog deadline;
:mod:`~raft_tpu_torch.comms.faults` injects failures at the execute seam
(:func:`faults.inject`), so every path runs on the CPU in tests.
:mod:`~raft_tpu_torch.comms.selftest` is the reference's battery.  The
multi-process bootstrap over ``torch.distributed`` and the mesh that
spans processes are :mod:`~raft_tpu_torch.comms.dist` (one process a
card; every process builds the same spanning mesh, and one
:class:`HostComms` spans them all).
"""

from raft_tpu_torch.comms.types import Datatype, Op, Status, get_type  # noqa: F401
from raft_tpu_torch.comms.mesh import Mesh, Rank, default_mesh  # noqa: F401
from raft_tpu_torch.comms.mesh_comms import MeshComms  # noqa: F401
from raft_tpu_torch.comms.host_comms import HostComms, axis_host_group_size  # noqa: F401
from raft_tpu_torch.comms.resilience import RetryPolicy  # noqa: F401
from raft_tpu_torch.comms import faults, selftest  # noqa: F401
from raft_tpu_torch.core.error import (  # noqa: F401
    CommAbortedError,
    CommError,
    CommTimeoutError,
)


def build_comms(handle, mesh=None, n_devices=None):
    """Create a :class:`HostComms` over ``mesh`` (or the first
    ``n_devices`` devices of the handle's kind) and inject it into
    ``handle`` (reference build_comms_nccl_only, comms/helper.hpp:39)."""
    if mesh is None:
        mesh = default_mesh(n_devices, device=handle.device.type)
    comms = HostComms(mesh)
    handle.set_comms(comms)
    handle.mesh = mesh
    return comms
