"""Communicator self-tests, runnable against a live communicator.

Port of ``raft_tpu/comms/selftest.py`` (reference
cpp/include/raft/comms/test.hpp:40-542: one test per collective plus p2p
and comm_split).  Each returns True on success, so a session can
health-check a communicator the same way (:func:`run_all` is the engine
of :meth:`raft_tpu_torch.session.Comms.health_check`).  Inputs are built
on the CPU and moved to the ranks' devices by the communicator.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.comms.host_comms import HostComms
from raft_tpu_torch.comms.types import Op, Status


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.cpu()


def test_collective_allreduce(comms: HostComms) -> bool:
    """Each rank contributes 1; every rank must see size (reference
    test.hpp:40)."""
    size = comms.get_size()
    out = _host(comms.allreduce(torch.ones((size, 1), dtype=torch.int32)))
    return bool((out == size).all())


def test_collective_broadcast(comms: HostComms) -> bool:
    """Root holds 1, others 0; everyone must end with 1 (test.hpp:76)."""
    size = comms.get_size()
    x = torch.zeros((size, 1), dtype=torch.float32)
    x[0, 0] = 1.0
    return bool((_host(comms.bcast(x, root=0)) == 1.0).all())


def test_collective_reduce(comms: HostComms) -> bool:
    """Sum-to-root of per-rank ranks (test.hpp:114)."""
    size = comms.get_size()
    x = torch.arange(size, dtype=torch.float32)[:, None]
    out = _host(comms.reduce(x, root=0, op=Op.SUM))
    return bool((out[0] == size * (size - 1) / 2).all())


def test_collective_allgather(comms: HostComms) -> bool:
    """Rank r contributes r; every rank must see [0..size) (test.hpp:151)."""
    size = comms.get_size()
    x = torch.arange(size, dtype=torch.float32)[:, None]
    out = _host(comms.allgather(x))
    want = torch.arange(size, dtype=torch.float32)
    return all(bool((out[r].reshape(-1) == want).all()) for r in range(size))


def test_collective_gather(comms: HostComms) -> bool:
    """Root row holds [0..size); every NON-root row must be zeros — true
    root-only semantics, distinguishable from allgather (test.hpp:190)."""
    size = comms.get_size()
    root = size - 1  # a non-default root exercises the mask placement
    x = torch.arange(size, dtype=torch.float32)[:, None] + 1.0
    out = _host(comms.gather(x, root=root))
    want = torch.arange(size, dtype=torch.float32) + 1.0
    if not bool((out[root].reshape(-1) == want).all()):
        return False
    return all(bool((out[r] == 0).all()) for r in range(size) if r != root)


def test_collective_gatherv(comms: HostComms) -> bool:
    """Variable block sizes: rank r contributes r+1 copies of r+1 to the
    root row; non-root rows are zeros (test.hpp:229)."""
    size = comms.get_size()
    counts = [r + 1 for r in range(size)]
    buf = torch.zeros((size, max(counts), 1), dtype=torch.float32)
    for r in range(size):
        buf[r, :counts[r]] = r + 1
    out = _host(comms.gatherv(buf, counts, root=0))
    want = torch.cat([torch.full((c, 1), float(r + 1)) for r, c in enumerate(counts)])
    if not bool((out[0] == want).all()):
        return False
    return all(bool((out[r] == 0).all()) for r in range(1, size))


def test_collective_allgatherv(comms: HostComms) -> bool:
    """Every rank sees the tight concatenation (test.hpp:289)."""
    size = comms.get_size()
    counts = [r + 1 for r in range(size)]
    buf = torch.zeros((size, max(counts), 1), dtype=torch.float32)
    for r in range(size):
        buf[r, :counts[r]] = r
    out = _host(comms.allgatherv(buf, counts))
    want = torch.cat([torch.full((c, 1), float(r)) for r, c in enumerate(counts)])
    return all(bool((out[r] == want).all()) for r in range(size))


def test_collective_reducescatter(comms: HostComms) -> bool:
    """Every rank sends ones(size); each gets back its scalar block == size
    (test.hpp:349)."""
    size = comms.get_size()
    out = _host(comms.reducescatter(torch.ones((size, size), dtype=torch.float32),
                                    op=Op.SUM))
    return bool((out == size).all())


def test_pointToPoint_simple_send_recv(comms: HostComms) -> bool:
    """Ring exchange: rank r sends its payload to (r+1) % size (reference
    test.hpp:385).  The battery passes its own requests to ``waitall``,
    so a health probe never sweeps in (or strands) p2p work the user has
    queued on the live communicator."""
    size = comms.get_size()
    reqs, recvs = [], []
    for r in range(size):
        reqs.append(comms.isend(torch.full((3,), float(r)), rank=r, dest=(r + 1) % size, tag=7))
        recvs.append(comms.irecv(rank=r, source=(r - 1) % size, tag=7))
    comms.waitall(reqs + recvs)
    return all(bool((_host(recvs[r].result) == float((r - 1) % size)).all())
               for r in range(size))


def test_pointToPoint_device_send_or_recv(comms: HostComms) -> bool:
    """Pairwise exchange via the device verbs (reference test.hpp:432):
    even ranks send to rank+1, odd ranks receive."""
    size = comms.get_size()
    if size < 2:
        return True
    reqs, recvs = [], {}
    for r in range(0, size - 1, 2):
        reqs.append(comms.device_send(torch.full((2,), float(r)), rank=r, dest=r + 1))
        recvs[r + 1] = comms.device_recv(rank=r + 1, source=r)
    comms.waitall(reqs + list(recvs.values()))
    return all(bool((_host(req.result) == float(r - 1)).all()) for r, req in recvs.items())


def test_pointToPoint_device_sendrecv(comms: HostComms) -> bool:
    """Static-ring exchange (reference test.hpp:470)."""
    size = comms.get_size()
    perm = [(r, (r + 1) % size) for r in range(size)]
    out = _host(comms.device_sendrecv(torch.arange(size, dtype=torch.float32)[:, None], perm))
    return all(float(out[(r + 1) % size, 0]) == r for r in range(size))


def test_pointToPoint_device_multicast_sendrecv(comms: HostComms) -> bool:
    """Rank 0 multicasts to everyone (reference test.hpp:496)."""
    size = comms.get_size()
    x = torch.zeros((size, 1), dtype=torch.float32)
    x[0, 0] = 42.0
    out = _host(comms.device_multicast_sendrecv(x, [(0, d) for d in range(size)]))
    return bool((out == 42.0).all())


def test_commsplit(comms: HostComms, n_colors: int = 2) -> bool:
    """Split into n_colors round-robin groups and run allreduce in each
    (reference test.hpp:522)."""
    size = comms.get_size()
    n_colors = min(n_colors, size)
    colors = [r % n_colors for r in range(size)]
    for color, sub in comms.comm_split(colors).items():
        if not test_collective_allreduce(sub):
            return False
        if sub.get_size() != sum(1 for c in colors if c == color):
            return False
    return True


def test_sync_stream_status(comms: HostComms) -> bool:
    """sync_stream returns SUCCESS on good work and ABORT after abort()
    (reference std_comms.hpp:443-475 semantics)."""
    size = comms.get_size()
    out = comms.allreduce(torch.ones((size, 1)))
    if comms.sync_stream(out) != Status.SUCCESS:
        return False
    comms.abort()
    return comms.sync_stream(out) == Status.ABORT


ALL_TESTS = [
    test_collective_allreduce,
    test_collective_broadcast,
    test_collective_reduce,
    test_collective_allgather,
    test_collective_gather,
    test_collective_gatherv,
    test_collective_allgatherv,
    test_collective_reducescatter,
    test_pointToPoint_simple_send_recv,
    test_pointToPoint_device_send_or_recv,
    test_pointToPoint_device_sendrecv,
    test_pointToPoint_device_multicast_sendrecv,
    test_commsplit,
]


def run_all(comms: HostComms) -> dict:
    """Run the whole battery against a live communicator, one verdict per
    test.  A test that *raises* (every verb on an aborted communicator)
    counts as False: this is a health probe, and "the probe crashed" is
    the unhealthy signal it exists to report.  Excludes
    ``test_sync_stream_status``, which poisons the communicator it runs
    on."""
    results = {}
    for fn in ALL_TESTS:
        try:
            results[fn.__name__] = bool(fn(comms))
        except Exception:
            results[fn.__name__] = False
    return results
