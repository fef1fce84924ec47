"""One process of a multi-process session: the cross-process self-test.

    python -m raft_tpu_torch.comms.mp_selftest --process-id 0 --num-processes 2 \\
        --coordinator 127.0.0.1:29500 --slots 2 --device cuda --out p0.json \\
        [--knn 1000000,128,1024,100] [--ivf DIR --nprobe 32 --k 100] [--seed 7]

Start one such process for each ``--process-id`` (the same arguments
otherwise).  Each joins the session (``Comms(coordinator_address=...)``,
its ``--slots`` rank slots on ``--device``: a world of ``slots x
num_processes`` spanning the processes) and then, every process making
the same calls:

- runs the 14 self-tests of :mod:`raft_tpu_torch.comms.selftest` on the
  spanning communicator (the status test, which aborts what it runs on,
  on a communicator of its own), an allreduce on each child of a split
  by process (so each process runs a child it holds no member of), and
  the session's ``health_check``;
- checks the registry (``local_handle``, ``get_raft_comm_state``),
  ``worker_info``'s process indices and backend, ``axis_host_group_size``,
  ``Handle.get_device_properties()["process_index"]``, and that a remote
  rank's device is refused;
- with ``--knn n,d,nq,k``: the index and queries drawn from ``--seed``
  with numpy (``standard_normal``, float32), ``mnmg_knn`` (L2Expanded)
  over the spanning mesh with each merge (allgather, ring, hierarchical
  with the group size resolved from placement), each answer's digest
  (SHA-256 of the distance and id bytes) beside that of the same search
  over a world of the same slots in this one process, the median ms of
  ``--reps`` searches, the exchange's share of them and the bytes
  exchanged a search; K1 held against its plain version at this
  process's first shard;
- with ``--ivf DIR``: the IVF-Flat index restored from the snapshot under
  ``DIR`` (``persist.snapshot``, written once by the caller) and the
  queries of ``DIR/queries.npy``, the index's digest, then
  ``mnmg_ivf_flat_search`` the same way; K3 held against its plain
  version at this process's first shard.

It writes what it found to ``--out`` (JSON: the verdicts, digests,
timings, bootstrap seconds and retries, the kernels' launches on each
part's first searches and the inventory, ``_build.stats()``, the exchange's
counters) and exits 0 when every check passed, 1 otherwise.  Asked for
CUDA where ``torch.cuda.is_available()`` is False it exits 3 at once:
there is no fallback to the CPU.  The kernels are loaded from the build
directory (a caller on the card builds them first,
``core.specializations.warmup()``); ``build.builds`` tells whether this
process ran ``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time
import traceback

import torch


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _l2_atol(a, b) -> float:
    """Tolerance of expanded-form squared L2 in float32 (the rounding of
    |a|^2 + |b|^2 at the largest norms), as ``chip_smoke.py``'s."""
    return 2e-6 * ((a * a).sum(-1).max() + (b * b).sum(-1).max()).item()


def _check_topk(got_d, got_i, ref_d, ref_i, atol) -> dict:
    """A kernel's top-k against its plain version: distances within
    ``atol``; an id outside the reference's set only at a tie with the
    reference's k-th distance."""
    live = ref_i >= 0
    err = (got_d[live] - ref_d[live]).abs().max().item() if bool(live.any()) else 0.0
    bad = 0
    for row in range(ref_i.shape[0]):
        extra = set(got_i[row].tolist()) - set(ref_i[row].tolist())
        if extra:
            kth = ref_d[row][live[row]][-1].item()
            bad += sum(1 for c, idx in enumerate(got_i[row].tolist())
                       if idx in extra and abs(got_d[row, c].item() - kth) > atol)
    return {"max_abs_err": err, "atol": atol, "non_tie_ids": bad,
            "ok": err <= atol and bad == 0}


def _timed(fn, reps, group, sync) -> dict:
    """Median wall ms of ``fn`` ended by a device sync (after one
    warm-up), with the exchange's ms, share and bytes a call read from
    the process group's counters."""
    fn()
    sync()
    st0 = dict(group.stats)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    st1 = group.stats
    ex_ms = (st1["seconds"] - st0["seconds"]) * 1e3 / reps
    moved = (st1["bytes_sent"] - st0["bytes_sent"]
             + st1["bytes_received"] - st0["bytes_received"]) / reps
    return {"ms": statistics.median(times), "ms_all": times, "exchange_ms": ex_ms,
            "exchange_share": ex_ms / max(sum(times) / reps, 1e-9),
            "bytes_exchanged_per_search": moved}


def _searches(run, local_run, merges, out, failures, name, timed, keep_values):
    """Each merge over the spanning mesh: digest, the one-process world's
    digest, bitwise equality, timing."""
    for merge in merges:
        d, i = run(merge)
        res = {"digest": _digest(d, i)}
        ld, li = local_run(merge)
        res["local_digest"] = _digest(ld, li)
        res["equal_one_process_world"] = bool(
            torch.equal(d.cpu(), ld.cpu()) and torch.equal(i.cpu(), li.cpu()))
        if not res["equal_one_process_world"]:
            failures["%s_%s_vs_one_process" % (name, merge)] = "differs"
        if keep_values:
            res["d"] = d.cpu().tolist()
            res["i"] = i.cpu().tolist()
        res.update(timed(lambda m=merge: run(m)))
        out[merge] = res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True, help="host:port of process 0's store")
    ap.add_argument("--slots", type=int, default=2, help="rank slots in this process")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--knn", default=None, help="n,d,nq,k")
    ap.add_argument("--ivf", default=None, help="snapshot directory with queries.npy")
    ap.add_argument("--nprobe", type=int, default=32)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--bootstrap-timeout", type=float, default=20.0)
    ap.add_argument("--bootstrap-retries", type=int, default=3)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("raft_tpu_torch.comms.mp_selftest %d: --device %s but "
              "torch.cuda.is_available() is False" % (args.process_id, args.device),
              file=sys.stderr)
        return 3

    import numpy as np

    from raft_tpu_torch.comms import HostComms, Mesh, RetryPolicy, selftest
    from raft_tpu_torch.comms.host_comms import axis_host_group_size
    from raft_tpu_torch.core import inventory, tracing
    from raft_tpu_torch.core.error import LogicError
    from raft_tpu_torch.distance.distance_type import DistanceType
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops.ivf_tile import fused_ivf_scan, fused_ivf_scan_plain
    from raft_tpu_torch.ops.knn_tile import fused_knn_tile, knn_tile_plain
    from raft_tpu_torch.session import Comms, get_raft_comm_state, local_handle
    from raft_tpu_torch.spatial.mnmg_knn import (mnmg_ivf_flat_search, mnmg_knn,
                                                 resolve_group_size, shard_ivf_flat_index,
                                                 shard_knn_index)

    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    kernels = ("knn_tile", "select_tile", "ivf_tile")
    report = {"process_id": args.process_id, "num_processes": args.num_processes,
              "slots": args.slots, "device": str(dev),
              "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    failures = {}
    sess = None
    try:
        policy = RetryPolicy(max_retries=args.bootstrap_retries, base_delay=0.2,
                             timeout=args.bootstrap_timeout)
        retries0 = tracing.counters().get("comms.retry", 0)
        t0 = time.perf_counter()
        sess = Comms(mesh=Mesh([dev] * args.slots, ("ranks",)),
                     coordinator_address=args.coordinator, num_processes=args.num_processes,
                     process_id=args.process_id, bootstrap_retry_policy=policy).init()
        report["bootstrap_s"] = time.perf_counter() - t0
        report["bootstrap_retries"] = tracing.counters().get("comms.retry", 0) - retries0
        report["backend"] = sess.backend
        world = args.slots * args.num_processes
        comms, mesh, group = sess.comms, sess.comms.mesh, sess.comms.mesh.group

        # the 14 self-tests, the status test on a communicator of its own
        tests = {}
        for fn in selftest.ALL_TESTS:
            try:
                tests[fn.__name__] = bool(fn(comms))
            except Exception as e:  # noqa: BLE001 - a verdict, reported below
                tests[fn.__name__] = "%s: %s" % (type(e).__name__, e)
        try:
            tests["test_sync_stream_status"] = bool(
                selftest.test_sync_stream_status(HostComms(mesh)))
        except Exception as e:  # noqa: BLE001
            tests["test_sync_stream_status"] = "%s: %s" % (type(e).__name__, e)
        report["selftests"] = tests
        failures.update({k: v for k, v in tests.items() if v is not True})
        # a split by process: every process runs each child's verb, the
        # one that holds none of its members too
        split = comms.comm_split([r.process for r in comms.ranks])
        report["commsplit_by_process"] = all(
            bool((sub.allreduce(torch.ones((sub.get_size(), 1))).cpu() == sub.get_size()).all())
            for _, sub in sorted(split.items()))
        if not report["commsplit_by_process"]:
            failures["commsplit_by_process"] = False
        health = sess.health_check()
        report["health"] = {"ok": health["ok"], "backend": health["backend"],
                            "ranks": {str(k): v for k, v in health["ranks"].items()}}
        if not health["ok"]:
            failures["health_check"] = report["health"]

        # the registry, placement, and the remote-device refusal
        info = sess.worker_info()
        report["process_indices"] = [info[r]["process_index"] for r in sorted(info)]
        report["worker_backends"] = sorted({v["backend"] for v in info.values()})
        report["axis_host_group_size"] = axis_host_group_size(mesh, "ranks")
        report["handle_process_index"] = sess.handle.get_device_properties()["process_index"]
        registry = (local_handle(sess.sessionId) is sess.handle
                    and get_raft_comm_state(sess.sessionId)["nworkers"] == world)
        remote = [r for r in mesh.rank_list() if not r.is_local]
        try:
            remote[0].device
            refused = False
        except LogicError:
            refused = True
        report["remote_device_refused"] = refused
        want_procs = [p for p in range(args.num_processes) for _ in range(args.slots)]
        for name, ok in (("registry", registry), ("remote_device_refused", refused),
                         ("process_indices", report["process_indices"] == want_procs),
                         ("handle_process_index",
                          report["handle_process_index"] == args.process_id)):
            if not ok:
                failures[name] = False

        merges = ("allgather", "ring", "hierarchical")

        def timed(fn):
            return _timed(fn, args.reps, group, sync)

        one = Mesh([dev] * world, ("ranks",))     # the same slots in this one process

        def first_runs(run):
            """Each merge's first search: the kernels it launched, from
            the cost inventory (the main path's; the checks against the
            plain versions come after)."""
            before = inventory.snapshot()
            for merge in merges:
                run(merge)
            sync()
            launched = inventory.launches_since(before)
            return {name: sum(launched.get(name, {}).values()) for name in kernels}

        if args.knn:
            n, d, nq, k = (int(v) for v in args.knn.split(","))
            rng = np.random.default_rng(args.seed)
            index = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
            queries = torch.from_numpy(rng.standard_normal((nq, d), dtype=np.float32)).to(dev)
            sharded, _ = shard_knn_index(index, mesh, "ranks")
            local_sharded, _ = shard_knn_index(index, one, "ranks")
            g = resolve_group_size(mesh, "ranks")

            def run(merge):
                return mnmg_knn(sharded, queries, k, DistanceType.L2Expanded, mesh=mesh,
                                axis="ranks", merge=merge, n_rows=n)

            def local_run(merge):
                return mnmg_knn(local_sharded, queries, k, DistanceType.L2Expanded, mesh=one,
                                axis="ranks", merge=merge, n_rows=n,
                                group_size=g if merge == "hierarchical" else None)

            knn = {"shape": [n, d, nq, k], "group_size": g, "launches": first_runs(run),
                   "runs": {}}
            _searches(run, local_run, merges, knn["runs"], failures, "knn", timed,
                      nq * k <= 4096)
            shard = next(s for s in sharded.shards if s is not None)
            qc = queries[:128]
            knn["k1_check"] = _check_topk(*fused_knn_tile(shard, qc, k),
                                          *knn_tile_plain(shard, qc, k), _l2_atol(qc, shard))
            if not knn["k1_check"]["ok"]:
                failures["k1_check"] = knn["k1_check"]
            report["knn"] = knn
            del index, sharded, local_sharded

        if args.ivf:
            import os

            from raft_tpu_torch.persist.snapshot import load_current
            from raft_tpu_torch.spatial.ann import _probe_compact

            ivf = load_current(args.ivf, device=dev)[0]
            q = torch.from_numpy(np.load(os.path.join(args.ivf, "queries.npy"))).to(dev)
            k = args.k
            sharded = shard_ivf_flat_index(ivf, mesh, "ranks")
            local_sharded = shard_ivf_flat_index(ivf, one, "ranks")
            g = resolve_group_size(mesh, "ranks")

            def run(merge):
                return mnmg_ivf_flat_search(sharded, q, k, nprobe=args.nprobe, merge=merge)

            def local_run(merge):
                return mnmg_ivf_flat_search(local_sharded, q, k, nprobe=args.nprobe, merge=merge,
                                            group_size=g if merge == "hierarchical" else None)

            out = {"launches": first_runs(run),
                   "index_digest": _digest(ivf.centroids, ivf.slot_vecs, ivf.slot_ids,
                                           ivf.cent_slots),
                   "nprobe": args.nprobe, "k": k, "queries": int(q.shape[0]), "runs": {}}
            _searches(run, local_run, merges, out["runs"], failures, "ivf", timed,
                      q.shape[0] * k <= 4096)
            j = next(p for p, v in enumerate(sharded.slot_vecs) if v is not None)
            sv, sn, si = sharded.slot_vecs[j], sharded.slot_norms[j], sharded.slot_ids[j]
            slots, _ = _probe_compact(q, sharded.centroids[j], sharded.cent_slots_local[j],
                                      args.nprobe)
            slots = slots[:, :min(slots.shape[1], sv.shape[0])].contiguous()
            scan = (q, sv, sn, si, slots, k)
            out["k3_check"] = _check_topk(*fused_ivf_scan(*scan), *fused_ivf_scan_plain(*scan),
                                          _l2_atol(q, sv.reshape(-1, sv.shape[-1])))
            if not out["k3_check"]["ok"]:
                failures["k3_check"] = out["k3_check"]
            report["ivf"] = out

        report["inventory"] = inventory.summary()
        report["build"] = _build.stats()
        report["exchange"] = dict(group.stats)
    except Exception as e:  # noqa: BLE001 - the process's verdict, written below
        failures["exception"] = "%s: %s" % (type(e).__name__, e)
        report["traceback"] = traceback.format_exc()
    finally:
        if sess is not None:
            sess.destroy()
    report["failures"] = failures
    report["ok"] = not failures
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1, default=str)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
