"""Port parity of the communicator (raft_tpu_torch.comms) against the JAX
package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port runs on a mesh of 8 rank slots on the CPU
(``Mesh([cpu] * 8, ("ranks",))``), in one process.  Every verb's
rank-major output is held to the JAX verb's on the same numpy input:
exactly for integer payloads and for the verbs that only move data,
within 1e-6 for float sums.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.comms import HostComms as JHostComms
from raft_tpu.comms import Op as JOp
from raft_tpu.comms import default_mesh as jdefault_mesh
from raft_tpu_torch.comms import (Datatype, HostComms, Mesh, MeshComms, Op, Rank, Status,
                                  build_comms, default_mesh, get_type, selftest)
from raft_tpu_torch.comms.host_comms import axis_host_group_size
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.core.handle import Handle
from raft_tpu_torch.core.metrics import default_registry

SIZE = 8
CPU = torch.device("cpu")


def _mesh(n=SIZE, axis="ranks"):
    return Mesh([CPU] * n, (axis,))


@pytest.fixture(scope="module")
def pair():
    return JHostComms(jdefault_mesh()), HostComms(_mesh())


def _same(jout, pout, dtype):
    j, p = np.asarray(jout), pout.numpy()
    assert j.shape == p.shape
    if np.issubdtype(dtype, np.integer):
        np.testing.assert_array_equal(p, j)
    else:
        np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-6)


def _input(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-50, 50, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


# --------------------------------------------------------------------- #
# every verb against the JAX verb
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["SUM", "PROD", "MIN", "MAX"])
def test_allreduce_matches_jax(pair, dtype, op):
    jc, pc = pair
    x = _input(dtype, (SIZE, 3, 2), 1)
    if op == "PROD":
        x = (np.abs(x) % 3 + 1).astype(dtype)        # no overflow in 8 factors
    _same(jc.allreduce(jnp.asarray(x), JOp[op]), pc.allreduce(x, Op[op]), dtype)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("root", [0, 3, SIZE - 1])
def test_bcast_reduce_gather_match_jax(pair, dtype, root):
    jc, pc = pair
    x = _input(dtype, (SIZE, 4), root + 2)
    _same(jc.bcast(jnp.asarray(x), root), pc.bcast(x, root), dtype)
    _same(jc.reduce(jnp.asarray(x), root, JOp.SUM), pc.reduce(x, root, Op.SUM), dtype)
    _same(jc.gather(jnp.asarray(x), root), pc.gather(x, root), dtype)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_allgather_and_reducescatter_match_jax(pair, dtype):
    jc, pc = pair
    x = _input(dtype, (SIZE, 3, 2), 7)
    _same(jc.allgather(jnp.asarray(x)), pc.allgather(x), dtype)
    y = _input(dtype, (SIZE, SIZE * 2), 8)
    _same(jc.reducescatter(jnp.asarray(y)), pc.reducescatter(y), dtype)
    _same(jc.reducescatter(jnp.asarray(y), JOp.MAX), pc.reducescatter(y, Op.MAX), dtype)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_allgatherv_and_gatherv_match_jax(pair, dtype):
    jc, pc = pair
    counts = [(r % 3) + 1 for r in range(SIZE)]
    x = _input(dtype, (SIZE, max(counts), 2), 9)
    _same(jc.allgatherv(jnp.asarray(x), counts), pc.allgatherv(x, counts), dtype)
    _same(jc.gatherv(jnp.asarray(x), counts, 2), pc.gatherv(x, counts, 2), dtype)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_sendrecv_and_multicast_match_jax(pair, dtype):
    jc, pc = pair
    x = _input(dtype, (SIZE, 5), 11)
    perm = [(r, (r + 3) % SIZE) for r in range(0, SIZE, 2)]
    _same(jc.device_sendrecv(jnp.asarray(x), perm), pc.device_sendrecv(x, perm), dtype)
    sends = [(0, d) for d in range(SIZE)] + [(5, 1), (6, 1)]
    _same(jc.device_multicast_sendrecv(jnp.asarray(x), sends),
          pc.device_multicast_sendrecv(x, sends), dtype)


def test_multicast_int_payload_exact(pair):
    """Ids above 2^24 survive a multicast exactly (the payload's own dtype)."""
    _, pc = pair
    x = np.zeros((SIZE, 1), np.int32)
    x[0, 0] = 2 ** 24 + 1
    out = pc.device_multicast_sendrecv(x, [(0, d) for d in range(SIZE)]).numpy()
    assert (out == 2 ** 24 + 1).all()


def test_verbs_take_a_list_of_per_rank_tensors(pair):
    _, pc = pair
    rows = [torch.full((2,), float(r)) for r in range(SIZE)]
    out = pc.allgather(rows)
    assert out.shape == (SIZE, 2 * SIZE)
    assert torch.equal(out[3], torch.arange(SIZE, dtype=torch.float32).repeat_interleave(2))


def test_mesh_comms_is_the_per_rank_api():
    """HostComms runs MeshComms' verbs: the per-rank lists agree with the
    rank-major rows."""
    mc = MeshComms("ranks", 4, [CPU] * 4)
    xs = [torch.tensor([float(r), 1.0]) for r in range(4)]
    assert mc.get_rank() == [0, 1, 2, 3]
    assert [t.tolist() for t in mc.allreduce(xs)] == [[6.0, 4.0]] * 4
    g = mc.allgather(xs, dim=0, groups=[[0, 1], [2, 3]])
    assert g[0].tolist() == [0.0, 1.0, 1.0, 1.0] and g[3].tolist() == [2.0, 1.0, 3.0, 1.0]
    assert [int(t) for t in mc.barrier()] == [4] * 4
    with pytest.raises(LogicError, match="permutation"):
        mc.device_sendrecv(xs, [(0, 1), (2, 1)])
    with pytest.raises(LogicError, match="one buffer per rank"):
        mc.allreduce(xs[:3])


# --------------------------------------------------------------------- #
# the self-test battery
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fn", selftest.ALL_TESTS, ids=lambda f: f.__name__)
def test_selftest(fn):
    # a fresh communicator per test: the status test poisons its own
    assert fn(HostComms(_mesh()))


def test_sync_stream_status():
    assert selftest.test_sync_stream_status(HostComms(_mesh()))
    comms = HostComms(_mesh())
    assert comms.sync_stream() == Status.SUCCESS


def test_run_all_on_the_jax_battery_names():
    from raft_tpu.comms import selftest as jselftest

    assert [f.__name__ for f in selftest.ALL_TESTS] == [f.__name__ for f in jselftest.ALL_TESTS]
    results = selftest.run_all(HostComms(_mesh(3)))
    assert all(results.values()) and len(results) == len(selftest.ALL_TESTS)


# --------------------------------------------------------------------- #
# tagged p2p
# --------------------------------------------------------------------- #
def _staged():
    fam = default_registry().get("raft_tpu_comms_host_staged_bytes")
    return 0.0 if fam is None else sum(s.value for _, s in fam.series())


def test_p2p_tags_do_not_cross():
    comms = HostComms(_mesh())
    recv_a, recv_b = [], []
    for r in range(SIZE):
        comms.isend(torch.full((1,), float(r)), rank=r, dest=(r + 1) % SIZE, tag=1)
        comms.isend(torch.full((1,), float(100 + r)), rank=r, dest=(r - 1) % SIZE, tag=2)
        recv_a.append(comms.irecv(rank=r, source=(r - 1) % SIZE, tag=1))
        recv_b.append(comms.irecv(rank=r, source=(r + 1) % SIZE, tag=2))
    comms.waitall()
    for r in range(SIZE):
        assert float(recv_a[r].result[0]) == float((r - 1) % SIZE)
        assert float(recv_b[r].result[0]) == float(100 + (r + 1) % SIZE)
    assert comms._requests == []


@pytest.mark.parametrize("staging", ["device", "ppermute", "host"])
def test_waitall_routes_mixed_shapes(staging):
    """One waitall with heterogeneous shapes and dtypes routes every
    payload on each route; the device routes stage zero host bytes, the
    host route counts its rank-major buffers."""
    comms = HostComms(_mesh())
    f32, i32 = [], []
    for r in range(SIZE):
        comms.isend(torch.full((2, 3), float(10 * r)), rank=r, dest=(r + 1) % SIZE, tag=1)
        comms.isend(torch.full((5,), 1000 + r, dtype=torch.int32), rank=r,
                    dest=(r - 1) % SIZE, tag=2)
        f32.append(comms.irecv(rank=r, source=(r - 1) % SIZE, tag=1))
        i32.append(comms.irecv(rank=r, source=(r + 1) % SIZE, tag=2))
    before = _staged()
    comms.waitall(staging=staging)
    staged = _staged() - before
    want = {"device": 0, "ppermute": 0, "host": SIZE * (2 * 3 * 4 + 5 * 4)}[staging]
    assert staged == want
    for r in range(SIZE):
        assert f32[r].result.dtype == torch.float32 and f32[r].result.shape == (2, 3)
        assert (f32[r].result == 10 * ((r - 1) % SIZE)).all()
        assert (i32[r].result == 1000 + (r + 1) % SIZE).all()


def test_p2p_bytes_total_consistent_across_stagings():
    """``raft_tpu_comms_bytes_total{verb=p2p}`` counts the send rows on
    every route, not the staging buffer."""
    comms = HostComms(_mesh())

    def p2p_bytes():
        fam = default_registry().get("raft_tpu_comms_bytes_total")
        return 0.0 if fam is None else sum(s.value for labels, s in fam.series()
                                           if labels.get("verb") == "p2p")

    payload = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for staging in ("device", "ppermute", "host"):
        comms.isend(payload, rank=0, dest=1, tag=21)
        rq = comms.irecv(rank=1, source=0, tag=21)
        before = p2p_bytes()
        comms.waitall(staging=staging)
        assert p2p_bytes() - before == 24
        assert torch.equal(rq.result, payload)


def test_direct_p2p_copies_where_ranks_share_a_device():
    """A transfer is a copy: the receiver does not alias the sender."""
    comms = HostComms(_mesh(2))
    send = torch.zeros(3)
    comms.isend(send, rank=0, dest=1)
    r = comms.irecv(rank=1, source=0)
    comms.waitall()
    send += 1
    assert (r.result == 0).all()


def test_waitall_unmatched_raises_and_fanout_layers():
    comms = HostComms(_mesh())
    comms.isend(torch.ones(1), rank=0, dest=1, tag=99)
    with pytest.raises(LogicError, match="unmatched send"):
        comms.waitall()
    comms.isend(torch.full((1,), 1.0), rank=0, dest=1, tag=5)
    comms.isend(torch.full((1,), 2.0), rank=0, dest=2, tag=5)
    r1, r2 = comms.irecv(rank=1, source=0, tag=5), comms.irecv(rank=2, source=0, tag=5)
    comms.waitall(staging="ppermute")
    assert float(r1.result[0]) == 1.0 and float(r2.result[0]) == 2.0


# --------------------------------------------------------------------- #
# comm_split, meshes, handles, types
# --------------------------------------------------------------------- #
def test_comm_split_keys_reorder_and_2d_grid():
    comms = HostComms(_mesh())
    subs = comms.comm_split([0] * SIZE, keys=list(range(SIZE))[::-1])
    assert subs[0].get_size() == SIZE and subs[0].mesh.rank_ids() == tuple(range(SIZE))[::-1]
    assert selftest.test_collective_allreduce(subs[0])
    rows = comms.comm_split([r // 2 for r in range(SIZE)])
    cols = comms.comm_split([r % 2 for r in range(SIZE)])
    assert len(rows) == 4 and all(c.get_size() == 2 for c in rows.values())
    assert len(cols) == 2 and all(c.get_size() == 4 for c in cols.values())
    assert cols[1].mesh.rank_ids() == (1, 3, 5, 7)
    for c in list(rows.values()) + list(cols.values()):
        assert selftest.test_collective_allreduce(c)


def test_mesh_rank_slots_keep_their_ids():
    m = Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 4), ("q", "x"))
    assert m.shape == {"q": 2, "x": 4} and m.size == 8
    assert [r.id for r in m.line("x", (1, 0))] == [4, 5, 6, 7]
    sub = m.submesh([6, m.ranks[0, 1]])
    assert sub.rank_ids() == (6, 1) and sub.ranks[0] is m.ranks[1, 2]
    with pytest.raises(LogicError, match="not a rank of this mesh"):
        m.submesh([Rank(1, CPU)])              # a foreign slot with a known id
    with pytest.raises(LogicError, match="repeated rank ids"):
        Mesh([m.ranks[0, 0], m.ranks[0, 0]], ("x",))
    assert axis_host_group_size(m, "x") is None
    cm = default_mesh(3, device="cpu")
    assert cm.axis_names == ("ranks",) and cm.size == 3


def test_host_comms_on_a_2d_mesh_runs_along_its_axis():
    m = Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 4), ("q", "x"))
    comms = HostComms(m, "x")
    assert comms.get_size() == 4
    assert (comms.allreduce(np.ones((4, 1), np.int32)).numpy() == 4).all()


def test_build_comms_and_handle_injection():
    handle = Handle(device="cpu")
    comms = build_comms(handle, mesh=_mesh(4))
    assert handle.get_comms() is comms and handle.mesh is comms.mesh
    assert comms.get_size() == 4
    handle2 = Handle(device="cpu")
    assert build_comms(handle2, n_devices=2).get_size() == 2


@pytest.mark.parametrize("dtype,wire", [(np.int8, Datatype.CHAR), (np.uint8, Datatype.UINT8),
                                        (np.int32, Datatype.INT32), (np.uint32, Datatype.UINT32),
                                        (np.int64, Datatype.INT64), (np.uint64, Datatype.UINT64),
                                        (np.float32, Datatype.FLOAT32),
                                        (np.float64, Datatype.FLOAT64)])
def test_get_type_matches_jax(dtype, wire):
    from raft_tpu.comms import get_type as jget_type

    assert get_type(dtype) == wire == int(jget_type(dtype))


@pytest.mark.parametrize("dtype,wire", [(torch.int8, Datatype.CHAR), (torch.int32, Datatype.INT32),
                                        (torch.float32, Datatype.FLOAT32),
                                        (torch.float64, Datatype.FLOAT64)])
def test_get_type_of_torch_dtypes(dtype, wire):
    assert get_type(dtype) == wire


def test_types_match_jax_values():
    from raft_tpu.comms import Datatype as JDatatype
    from raft_tpu.comms import Status as JStatus

    assert {m.name: int(m) for m in Op} == {m.name: int(m) for m in JOp}
    assert {m.name: int(m) for m in Status} == {m.name: int(m) for m in JStatus}
    assert {m.name: int(m) for m in Datatype} == {m.name: int(m) for m in JDatatype}
