"""Resource handle: the port's ``raft::handle_t``.

Port of ``raft_tpu/core/handle.py``.  The reference's ``handle_t``
(cpp/include/raft/handle.hpp:49-285) carries a device, a main stream, a
stream pool, an injected communicator with named sub-communicators, and
the device's properties.  On the card those are PyTorch's own:

- the device is a :class:`torch.device` (``device=`` through
  :func:`~raft_tpu_torch.core.device.resolve_device`, default
  ``"cuda"``);
- the main stream and the pool's are :class:`torch.cuda.Stream` objects
  of that device, each held in a :class:`Stream`; on the CPU a
  :class:`Stream` holds none, and its calls do nothing;
- ``Stream.record`` records a CUDA event on the stream, and
  ``Stream.sync`` waits for the last one recorded;
- :meth:`Handle.set_comms` / :meth:`Handle.get_comms` inject a
  communicator, as in the reference, and ``mesh=`` carries the rank
  mesh (:class:`~raft_tpu_torch.comms.mesh.Mesh`) that SPMD primitives
  such as :func:`~raft_tpu_torch.spatial.mnmg_knn.mnmg_knn` fall back to;
- :meth:`Handle.get_device_properties` reads
  :func:`torch.cuda.get_device_properties`.

:func:`takes_handle` gives a primitive the reference's ``handle_t&``
contract: it appends ``handle=None`` and ``device=None`` keywords, moves
every array argument (numpy array, tensor, or a sparse container with a
``to_device`` method) to the handle's device (or
``device``, default ``"cuda"``; a primitive with a ``device`` parameter
of its own, one that makes tensors from no array, is given it), and on
the card runs the call on the handle's main stream.  That stream first
waits for the caller's current stream, on which the inputs may still be
being written; after the call
the caller's stream waits for the handle's (a wait on the card, not on
the host), so whatever the caller enqueues next sees the results, the
order JAX's data dependencies give.  Inputs and outputs are marked as
used on both streams (``record_stream``), so the caching allocator never
hands their memory to one stream while the other still reads it.  Each
call runs in a ``<layer>.<name>`` span of the handle's profiler
(:attr:`Handle.profiler`, the process default of
:mod:`raft_tpu_torch.core.profiler` unless given; the default one without
a handle), which opens the range of that name in
:mod:`raft_tpu_torch.core.tracing` and feeds the
``raft_tpu_<layer>_<name>_seconds`` timer of
:mod:`raft_tpu_torch.core.metrics`: a host-clock time of the call (the
card runs on after it returns).
"""

from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import CommAbortedError, RaftError, expects
from raft_tpu_torch.core.profiler import Profiler, default_profiler


class Stream:
    """A CUDA stream of a handle (``stream`` None on the CPU)."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._event: Optional[torch.cuda.Event] = None

    def record(self, *tensors) -> None:
        """Mark the work enqueued on the stream so far with a CUDA event
        (a no-op on the CPU).  ``tensors`` are accepted for the JAX
        signature; the event covers everything enqueued before it."""
        if self.stream is None:
            return
        self._event = torch.cuda.Event()
        self._event.record(self.stream)

    def sync(self) -> None:
        """Wait for the work recorded on the stream, as the JAX stream
        blocks on the arrays recorded on it; nothing recorded, nothing to
        wait for.  A failure of that work surfaces as :class:`RaftError`,
        once: the mark is dropped either way."""
        event, self._event = self._event, None
        if event is None:
            return
        try:
            event.synchronize()
        except RuntimeError as e:
            raise RaftError("stream '%s' sync failed on its work: %s" % (self.name, e)) from e


class Handle:
    """Central resource context passed to every primitive.

    Parameters
    ----------
    device:
        The device of the handle's streams and of the primitives called
        with it (default ``"cuda"``; raises when CUDA is missing).
    n_streams:
        Size of the stream pool (reference handle.hpp:80); 0 = no pool.
    profiler:
        The span profiler of the primitives called with this handle
        (default: the process profiler, so calls with and without a
        handle land in one report).
    mesh:
        Optional rank mesh (:class:`~raft_tpu_torch.comms.mesh.Mesh`) for
        the SPMD primitives.
    """

    def __init__(self, device="cuda", n_streams: int = 0,
                 profiler: Optional[Profiler] = None, mesh=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._stream = Stream("main", self.device)
        self._stream_pool = [Stream("pool%d" % i, self.device) for i in range(n_streams)]
        self._comms = None
        self._subcomms: Dict[str, Any] = {}
        self.mesh = mesh
        self.profiler = profiler if profiler is not None else default_profiler()

    # streams (reference handle.hpp:148-227)
    def get_stream(self) -> Stream:
        """Main stream (reference ``get_stream``, handle.hpp:148)."""
        return self._stream

    def is_stream_pool_initialized(self) -> bool:
        return len(self._stream_pool) > 0

    def get_stream_pool_size(self) -> int:
        return len(self._stream_pool)

    def get_stream_from_stream_pool(self, idx: int = 0) -> Stream:
        """Pool stream by index (reference handle.hpp:186)."""
        expects(len(self._stream_pool) > 0, "ERROR: rmm::cuda_stream_pool was not initialized")
        return self._stream_pool[idx % len(self._stream_pool)]

    def get_next_usable_stream(self, idx: int = 0) -> Stream:
        """Pool stream if a pool exists, else the main stream
        (reference handle.hpp:205-214)."""
        if self._stream_pool:
            return self._stream_pool[idx % len(self._stream_pool)]
        return self._stream

    def sync_stream(self, stream: Optional[Stream] = None) -> None:
        """Synchronise one stream (reference ``sync_stream``, handle.hpp:158)."""
        (stream or self._stream).sync()

    def sync_stream_pool(self) -> None:
        """Synchronise every pool stream (reference handle.hpp:216)."""
        for s in self._stream_pool:
            s.sync()

    def wait_stream_pool_on_stream(self) -> None:
        """Order pool work after the main stream's (reference
        handle.hpp:221): each pool stream waits for it on the card."""
        if self._stream.stream is None:
            return
        for s in self._stream_pool:
            s.stream.wait_stream(self._stream.stream)

    # comms (reference handle.hpp:229-252)
    def set_comms(self, comms) -> None:
        self._comms = comms

    def get_comms(self):
        expects(self._comms is not None, "ERROR: Communicator was not initialized on the handle")
        if getattr(self._comms, "aborted", False):
            raise CommAbortedError(
                "communicator on this handle is latched aborted; rebuild it before issuing "
                "collectives")
        return self._comms

    def comms_initialized(self) -> bool:
        return self._comms is not None

    def set_subcomm(self, key: str, comms) -> None:
        self._subcomms[key] = comms

    def get_subcomm(self, key: str):
        expects(key in self._subcomms, "%s was not found in subcommunicators.", key)
        return self._subcomms[key]

    # device properties (reference handle.hpp:254-262)
    def get_device(self) -> torch.device:
        return self.device

    def get_device_properties(self) -> Dict[str, Any]:
        """The device's name and sizes (``torch.cuda.get_device_properties``
        on the card; the platform alone on the CPU) and the index of the
        process that drives it (its rank in the ``torch.distributed``
        group of a multi-process session, else 0)."""
        from raft_tpu_torch.comms.dist import process_index

        props: Dict[str, Any] = {"platform": self.device.type, "id": self.device.index,
                                 "process_index": process_index()}
        if self.device.type != "cuda":
            return props
        p = torch.cuda.get_device_properties(self.device)
        props.update(device_kind=p.name, total_memory=p.total_memory,
                     multi_processor_count=p.multi_processor_count,
                     compute_capability=(p.major, p.minor),
                     bytes_in_use=torch.cuda.memory_allocated(self.device))
        return props


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if hasattr(tree, "to_device"):       # a sparse container
        return list(tree.tensors())
    return []


def _on_device(x, dev: torch.device):
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return as_tensor(x, dev)
    return x.to_device(dev) if hasattr(x, "to_device") else x


@contextlib.contextmanager
def _on_handle_stream(handle: Handle, dev: torch.device, inputs):
    """Run the block on the handle's main stream, ordered after the
    caller's stream and before its next work (module doc)."""
    stream = handle.get_stream().stream
    if stream is None:
        yield lambda out: None
        return
    caller = torch.cuda.current_stream(dev)
    stream.wait_stream(caller)
    for t in inputs:
        if t.device.type == "cuda":
            t.record_stream(stream)

    def finish(out):
        for t in _tensors(out):
            if t.device.type == "cuda":
                t.record_stream(caller)
        record_on_handle(handle)
        caller.wait_stream(stream)

    with torch.cuda.stream(stream):
        yield finish


def takes_handle(fn):
    """Give a primitive the reference's ``handle_t&`` argument contract
    (module doc): ``handle=None`` and ``device=None`` keywords, inputs on
    the device, the call on the handle's stream, and a span of the
    handle's profiler (a tracing range and a
    ``raft_tpu_<layer>_<name>_seconds`` timer)."""
    # "raft_tpu_torch.linalg.gemm" -> layer "linalg"
    mod_parts = (fn.__module__ or "").split(".")
    layer = mod_parts[1] if len(mod_parts) > 1 else "core"
    span_name = "%s.%s" % (layer, fn.__name__)
    # a primitive that makes tensors from no array argument takes the
    # device itself
    wants_device = "device" in inspect.signature(fn).parameters

    @functools.wraps(fn)
    def wrapper(*args, handle: Optional[Handle] = None, device=None, **kwargs):
        dev = handle.device if handle is not None else resolve_device(
            "cuda" if device is None else device)
        expects(handle is None or device is None or resolve_device(device).type == dev.type,
                "%s: device=%r differs from the handle's %s", span_name, device, dev)
        args = [_on_device(a, dev) for a in args]
        kwargs = {k: _on_device(v, dev) for k, v in kwargs.items()}
        if wants_device:
            kwargs["device"] = dev
        prof = handle.profiler if handle is not None else default_profiler()
        with prof.span(span_name, layer=layer):
            if handle is None:
                return fn(*args, **kwargs)
            with _on_handle_stream(handle, dev,
                                   _tensors(args) + _tensors(list(kwargs.values()))) as finish:
                out = fn(*args, **kwargs)
                finish(out)
            return out

    wrapper.__doc__ = (wrapper.__doc__ or "") + (
        "\n\n    ``handle`` / ``device``: the resource context (reference ``handle_t&``) "
        "or the device\n    (default ``\"cuda\"``); array arguments are moved there and, "
        "with a handle,\n    the call runs on its main stream.\n")
    return wrapper


class stream_syncer:
    """Scope that synchronises the handle on exit (reference
    ``stream_syncer``, handle.hpp:311)."""

    def __init__(self, handle: Handle):
        self.handle = handle

    def __enter__(self) -> Handle:
        return self.handle

    def __exit__(self, *exc) -> None:
        self.handle.sync_stream()
        self.handle.sync_stream_pool()


def record_on_handle(handle: Optional[Handle], *tensors) -> None:
    """Mark the work enqueued so far on the handle's main stream, so that
    ``handle.sync_stream()`` waits for it (no-op without a handle)."""
    if handle is not None:
        handle.get_stream().record(*tensors)
