"""Fleet worker: one process, one service, one shard on one device.

Port of ``raft_tpu/fleet/worker.py``.  Launched by the supervisor as
``python -m raft_tpu_torch.fleet.worker <spec.json>``.  The spec
(written by :class:`raft_tpu_torch.fleet.supervisor.Fleet`) tells the
worker everything it needs to build, or crash-restore, its shard
deterministically:

- **Device.**  ``device`` (default ``"cuda"``) is where the index lives
  and every search runs.  A worker whose spec asks for CUDA and finds
  none exits non-zero with that message: it never carries on on the
  CPU.  The CPU tests write ``"device": "cpu"``.
- **Build vs rejoin.**  A fresh worker synthesizes the fleet dataset
  from ``(seed, index_rows, dim)`` with numpy (:func:`_synth`, so a
  client can regenerate any shard), takes its shard
  (``full[shard_index::shard_count]``), builds the IVF-Flat index with
  :func:`raft_tpu_torch.spatial.ann.ivf_flat_build` on the device (K4 in
  k-means) and serves it through
  :class:`~raft_tpu_torch.serve.ANNService` (K2 probes, K3 scans, K2
  merges).  A RESTARTED worker finds its persist dir non-empty and
  rebuilds from snapshot + WAL instead: every acknowledged insert
  survives the kill; the replay depth and wall time travel through the
  registration handshake for the router's ``rejoin_lag`` rule.
- **Ephemeral ports.**  The data plane and the ops plane bind port 0;
  the bound ports travel to the router in the ``/register`` payload.
- **Shard-local -> global ids.**  ``ivf_flat_build`` assigns positional
  row ids, so a shard's base hits come back shard-local; the worker
  translates them through an int64 table (global id of local row ``j``
  is ``shard_index + j * shard_count``) before replying, so the router
  merges global ids.  Inserted ids are global by contract (``>=
  index_rows``) and pass through; compaction stays off in sharded mode
  (``compact_rows=0``) so the base/delta split cannot shift under the
  table.  Distances travel as float32 values, which JSON carries
  exactly.
- **Chaos hooks.**  ``POST /chaos`` arms worker-side faults (hang, fsync
  stall through :data:`raft_tpu_torch.persist.wal.FSYNC_HOOK`); a hang
  freezes the data plane and the heartbeat, so the router's lease
  protocol is what notices.
- **Device profile.**  ``POST /debug/profile`` traces the process's
  kernels with ``torch.profiler`` over a window and returns the device's
  busy and idle share (CUDA devices only): the fleet's rows/s is the
  host's and the wire's as much as the card's.

Clean shutdown (SIGTERM or ``POST /admin/shutdown``) drains in-flight
requests and lands a final snapshot before exiting.  SIGKILL is the
crash path: no goodbye, the WAL is the contract.
"""

from __future__ import annotations

import http.server
import json
import os
import signal
import sys
import tempfile
import threading
import time
import urllib.parse
from typing import Callable, Dict, Optional

import torch

from raft_tpu_torch.core import flight
from raft_tpu_torch.fleet import protocol, tracing

__all__ = ["FleetWorker", "main"]


def _synth(index_rows: int, dim: int, seed: int, clusters: int):
    """The fleet dataset: same shape as tools/torch_loadgen.py synth_data —
    deterministic in the spec fields, so every worker (and the test
    harness computing ground truth) regenerates identical bytes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if clusters <= 0:
        return rng.standard_normal((index_rows, dim)).astype(np.float32)
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, index_rows)
    return (centers[assign] + 0.3 * rng.standard_normal(
        (index_rows, dim))).astype(np.float32)


class FleetWorker:
    """Module-doc worker: owns the service, the data plane, the ops
    plane and the heartbeat thread for one fleet member."""

    def __init__(self, spec: dict, *,
                 clock: Callable[[], float] = time.monotonic):
        self.spec = dict(spec)
        self.worker_id = str(spec["worker_id"])
        self.generation = int(spec.get("generation", 0))
        self.mode = str(spec.get("mode", "sharded"))
        self.shard_index = int(spec.get("shard_index", 0))
        self.shard_count = int(spec.get("shard_count", 1))
        self.router_url = str(spec["router_url"])
        self.lease_interval_s = float(spec.get("lease_interval_s", 0.5))
        self.device = str(spec.get("device", "cuda"))
        self._clock = clock
        self._stop = threading.Event()
        self._hang_until = 0.0
        self._svc = None
        self._plane = None
        self._server = None
        self._server_thread = None
        self._beat_thread = None
        self._data_port: Optional[int] = None
        self._restore: Dict[str, object] = {}
        self._base_rows = 0
        self._global_ids = None
        self._lock = threading.Lock()
        # NTP-style clock alignment vs the router, estimated over the
        # register/heartbeat round trip and reported on the next beat
        # (:mod:`raft_tpu_torch.fleet.tracing`)
        self._clock_offset: Optional[float] = None
        self._clock_rtt: Optional[float] = None

    # ------------------------------------------------------------------ #
    # build / restore
    # ------------------------------------------------------------------ #
    def build(self) -> None:
        import numpy as np

        from raft_tpu_torch.core.device import resolve_device
        from raft_tpu_torch.serve import ANNService
        from raft_tpu_torch.serve.opsplane import OpsPlane

        spec = self.spec
        index_rows = int(spec["index_rows"])
        dim = int(spec["dim"])
        k = int(spec["k"])
        seed = int(spec.get("seed", 0))
        persist_dir = spec.get("persist_dir")
        self._global_ids = np.arange(self.shard_index, index_rows,
                                     self.shard_count, dtype=np.int64)
        self._base_rows = int(self._global_ids.shape[0])
        has_state = bool(
            persist_dir and os.path.isdir(persist_dir)
            and any(os.scandir(persist_dir)))
        device = resolve_device(self.device)
        svc_opts = dict(spec.get("service_opts") or {})
        svc_opts.setdefault("name", "ann_%s" % self.worker_id)
        svc_opts.setdefault("device", device)
        # compaction would fold global-id delta rows into positional
        # base slots and shift the translation table (module doc)
        svc_opts.setdefault("compact_rows", 0)
        if persist_dir:
            svc_opts.setdefault("persist_dir", persist_dir)
            svc_opts.setdefault(
                "persist_fsync", spec.get("persist_fsync", "always"))
            svc_opts.setdefault(
                "snapshot_interval_s",
                float(spec.get("snapshot_interval_s", 2.0)))
        t0 = self._clock()
        if has_state:
            # crash-restart rejoin: snapshot + WAL replay owns the
            # state; the synthetic build is skipped entirely
            svc = ANNService(None, k=k, **svc_opts)
        else:
            from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat_build

            full = _synth(index_rows, dim, seed,
                          int(spec.get("clusters", 0)))
            local = full[self.shard_index::self.shard_count]
            nlist = int(spec.get("nlist")
                        or max(8, min(4096, int(len(local) ** 0.5))))
            params = IVFFlatParams(
                nlist=nlist, nprobe=int(spec.get("nprobe", 8)))
            index = ivf_flat_build(local, params,
                                   train_rows=spec.get("train_rows"),
                                   device=device)
            svc = ANNService(index, k=k, **svc_opts)
        # restore_s is what feeds the sentinel's ``rejoin_lag``
        # ms-per-record judgement: it must cover snapshot load + WAL
        # replay only — warmup is constant in the journal depth and
        # would swamp the ratio on shallow replays
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        restore_s = max(0.0, self._clock() - t0)
        t1 = self._clock()
        svc.warmup()
        warmup_s = max(0.0, self._clock() - t1)
        self._svc = svc
        st = self._persist_stats()
        self._restore = {
            "restored": has_state,
            "restore_s": round(restore_s, 6),
            "warmup_s": round(warmup_s, 6),
            "replayed_records": int(st.get("replayed_records", 0) or 0),
            "wal_records": int(st.get("wal_records", 0) or 0),
            "snapshot_seq": int(st.get("snapshot_seq", 0) or 0),
        }
        self._plane = OpsPlane(
            services={svc.name: svc}, port=0,
            sentinel=bool(spec.get("sentinel", True)))

    def _persist_stats(self) -> dict:
        persist = getattr(self._svc, "_persist", None)
        if persist is None:
            return {}
        try:
            return persist.stats()
        except Exception:
            return {}

    # ------------------------------------------------------------------ #
    # data plane
    # ------------------------------------------------------------------ #
    def start_server(self) -> None:
        worker = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: D102 — metrics only
                pass

            def do_GET(self):
                worker._handle(self, "GET")

            def do_POST(self):
                worker._handle(self, "POST")

        host = str(self.spec.get("host", "127.0.0.1"))
        self._server = http.server.ThreadingHTTPServer(
            (host, 0), _Handler)
        self._server.daemon_threads = True
        self._data_port = int(self._server.server_address[1])
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="raft-tpu-fleet-%s" % self.worker_id)
        self._server_thread.start()

    def _handle(self, handler, method: str) -> None:
        self._maybe_hang()
        path, _, query = handler.path.partition("?")
        try:
            body = {}
            if method == "POST":
                length = int(handler.headers.get("Content-Length", 0))
                raw = handler.rfile.read(length) if length else b"{}"
                body = json.loads(raw.decode("utf-8"))
            elif query:
                body = {k: v[-1] for k, v in
                        urllib.parse.parse_qs(query).items()}
            route = {
                ("GET", "/info"): self._ep_info,
                ("GET", "/debug/trace"): self._ep_trace,
                ("POST", "/debug/flight"): self._ep_flight,
                ("POST", "/debug/profile"): self._ep_profile,
                ("POST", "/search"): self._ep_search,
                ("POST", "/insert"): self._ep_insert,
                ("POST", "/admin/shutdown"): self._ep_shutdown,
                ("POST", "/chaos"): self._ep_chaos,
            }.get((method, path))
            if route is None:
                self._reply(handler, 404, {"error": "NotFound",
                                           "message": path})
                return
            status, payload = route(body)
        except Exception as e:  # noqa: BLE001 — typed on the wire
            status, payload = protocol.error_response(e)
        self._reply(handler, status, payload)

    @staticmethod
    def _reply(handler, status: int, payload: dict) -> None:
        try:
            data = json.dumps(payload).encode("utf-8")
            handler.send_response(status)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(data)))
            handler.end_headers()
            handler.wfile.write(data)
        except (BrokenPipeError, ConnectionError, OSError):
            pass  # client gone: its router-side retry owns the outcome

    def _maybe_hang(self) -> None:
        # chaos hang: freeze handler threads until the fault expires
        # (time.sleep, not a busy loop — the process must look wedged,
        # not hot)
        while not self._stop.is_set():
            with self._lock:
                remaining = self._hang_until - self._clock()
            if remaining <= 0:
                return
            time.sleep(min(0.05, remaining))

    # ------------------------------------------------------------------ #
    # endpoints
    # ------------------------------------------------------------------ #
    def info(self) -> dict:
        st = self._persist_stats()
        return {
            "worker_id": self.worker_id,
            "generation": self.generation,
            "pid": os.getpid(),
            "mode": self.mode,
            "shard_index": self.shard_index,
            "shard_count": self.shard_count,
            "data_port": self._data_port,
            "ops_port": (None if self._plane is None
                         else self._plane.port),
            "wal_seq": int(st.get("wal_seq", 0) or 0),
            "wal_records": int(st.get("wal_records", 0) or 0),
            "restore": dict(self._restore),
        }

    def _ep_info(self, body: dict):
        return 200, self.info()

    def _ep_search(self, body: dict):
        import numpy as np

        t_in = self._clock()
        vectors = body.get("vectors")
        if not isinstance(vectors, list) or not vectors:
            return protocol.error_response(ValueError(
                "search: 'vectors' must be a non-empty list of rows"))
        q = torch.as_tensor(np.asarray(vectors, dtype=np.float32), device=self._svc.device)
        timeout = body.get("timeout_s")
        # propagated fleet trace context: binding it here means the
        # local Trace the batcher opens inside submit() — and with it
        # every per-process lifecycle event (admitted, batch_formed,
        # execute bracket, terminal, hedges, breaker trips recorded
        # under batch_scope) — carries the fleet trace id and lands in
        # the recorder's fleet index for /debug/trace to serve
        with flight.trace_context(protocol.parse_trace(
                body.get("trace"))):
            fut = self._svc.submit(
                q, timeout=None if timeout is None else float(timeout),
                tenant=body.get("tenant"))
        dists, ids = fut.result(
            timeout=None if timeout is None else float(timeout) + 5.0)
        dists = dists.cpu().numpy().astype(np.float32, copy=False)
        ids = ids.cpu().numpy().astype(np.int64)
        if self.mode == "sharded" and self.shard_count > 1:
            local = (ids >= 0) & (ids < self._base_rows)
            ids = ids.copy()
            ids[local] = self._global_ids[ids[local]]
        # server_seconds lets the router split its RPC wall time into
        # in-worker handling vs network residual (fleet_rpc_recv span)
        return 200, {"worker_id": self.worker_id,
                     "distances": dists.tolist(),
                     "ids": ids.tolist(),
                     "server_seconds": round(
                         max(0.0, self._clock() - t_in), 6)}

    def _ep_trace(self, body: dict):
        fid = body.get("id")
        if not fid:
            return protocol.error_response(ValueError(
                "debug/trace: 'id' query parameter is required"))
        return 200, tracing.local_payload(
            str(fid), worker_id=self.worker_id,
            generation=self.generation, clock=self._clock)

    def _ep_profile(self, body: dict):
        """The device's busy share over a window of ``seconds`` (default 2)
        of whatever this worker serves meanwhile: a ``torch.profiler``
        trace of the process's kernels, copies and sets, their union over
        the window's wall time.  Needs a CUDA device."""
        from torch.profiler import ProfilerActivity, profile

        if self._svc is None or self._svc.device.type != "cuda":
            return protocol.error_response(ValueError(
                "debug/profile: the worker's device is not a CUDA device"))
        seconds = min(30.0, max(0.1, float(body.get("seconds", 2.0))))
        fd, path = tempfile.mkstemp(suffix=".trace.json")
        os.close(fd)
        try:
            # the device's activity only: recording every host op of the
            # serving threads would slow the worker it measures
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                time.sleep(seconds)
                torch.cuda.synchronize(self._svc.device)
                wall = time.perf_counter() - t0
            prof.export_chrome_trace(path)
            with open(path, "r", encoding="utf-8") as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                        if e.get("ph") == "X"
                        and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
        busy_us, end = 0.0, float("-inf")
        for a, b in device:
            if b > end:
                busy_us += b - max(a, end)
                end = b
        return 200, {"worker_id": self.worker_id, "window_s": wall,
                     "device_busy_s": busy_us / 1e6,
                     "device_idle_share": 1.0 - busy_us / 1e6 / wall,
                     "device_ops": len(device)}

    def _ep_flight(self, body: dict):
        # remote toggle for THIS process's flight recording — the
        # fleet_trace_overhead bench arms its A/B on one warmed fleet
        # (router toggles itself locally; workers need the RPC)
        on = bool(body.get("on", True))
        flight.set_enabled(on)
        return 200, {"worker_id": self.worker_id, "flight_enabled": on}

    def _ep_insert(self, body: dict):
        import numpy as np

        t_in = self._clock()
        ids = body.get("ids")
        vectors = body.get("vectors")
        if not isinstance(ids, list) or not isinstance(vectors, list) \
                or len(ids) != len(vectors) or not ids:
            return protocol.error_response(ValueError(
                "insert: 'ids' and 'vectors' must be equal-length "
                "non-empty lists"))
        id_arr = np.asarray(ids, dtype=np.int64)
        index_rows = int(self.spec["index_rows"])
        if self.mode == "sharded" and int(id_arr.min()) < index_rows:
            # global-id contract (module doc): an insert id below the
            # base row count would collide with the translation table
            return protocol.error_response(ValueError(
                "insert: global ids must be >= index_rows=%d (got "
                "min=%d)" % (index_rows, int(id_arr.min()))))
        acked = self._svc.insert(
            id_arr, np.asarray(vectors, dtype=np.float32))
        st = self._persist_stats()
        return 200, {"worker_id": self.worker_id, "acked": int(acked),
                     "wal_seq": int(st.get("wal_seq", 0) or 0),
                     "server_seconds": round(
                         max(0.0, self._clock() - t_in), 6)}

    def _ep_shutdown(self, body: dict):
        # quiesce → snapshot half of the drain choreography; the reply
        # is sent before the exit so the supervisor sees the ack
        snapshot = bool(body.get("snapshot", True))
        threading.Thread(target=self._shutdown, args=(snapshot,),
                         daemon=True,
                         name="raft-tpu-fleet-%s-shutdown"
                         % self.worker_id).start()
        return 200, {"worker_id": self.worker_id, "stopping": True,
                     "snapshot": snapshot}

    def _ep_chaos(self, body: dict):
        fault = str(body.get("fault", ""))
        duration = float(body.get("duration_s", 0.5))
        if fault == "hang":
            with self._lock:
                self._hang_until = self._clock() + duration
        elif fault == "unhang":
            with self._lock:
                self._hang_until = 0.0
        elif fault == "fsync_stall":
            self._arm_fsync_stall(float(body.get("stall_s", 0.05)),
                                  duration)
        else:
            return protocol.error_response(ValueError(
                "chaos: unknown fault %r" % fault))
        return 200, {"worker_id": self.worker_id, "fault": fault,
                     "duration_s": duration}

    def _arm_fsync_stall(self, stall_s: float, duration: float) -> None:
        from raft_tpu_torch.persist import wal as _wal

        deadline = self._clock() + duration
        clock = self._clock

        def _stall():
            if clock() < deadline:
                time.sleep(stall_s)
            else:
                _wal.FSYNC_HOOK = None

        _wal.FSYNC_HOOK = _stall

    # ------------------------------------------------------------------ #
    # membership
    # ------------------------------------------------------------------ #
    def register(self) -> dict:
        payload = dict(self.info())
        payload["event"] = "register"
        t0 = self._clock()
        reply = protocol.post_json(
            self.router_url.rstrip("/") + "/register", payload,
            timeout=max(5.0, 10.0 * self.lease_interval_s))
        self._note_clock(reply.get("now"), t0, self._clock())
        self.lease_interval_s = float(
            reply.get("lease_interval_s", self.lease_interval_s))
        return reply

    def _note_clock(self, router_now, t0: float, t1: float) -> None:
        """NTP-client midpoint estimate over one router exchange:
        ``offset = router_now - (t0 + t1) / 2`` (router clock = worker
        clock + offset), trustworthy to ~rtt/2.  Samples with a worse
        round trip than the retained best are rejected (a GC pause or
        accept-queue stall would skew the midpoint), but the retained
        rtt decays each beat so the estimate re-learns after a real
        shift instead of pinning a stale fast sample forever."""
        if router_now is None:
            return
        try:
            router_now = float(router_now)
        except (TypeError, ValueError):
            return
        rtt = max(0.0, t1 - t0)
        offset = router_now - 0.5 * (t0 + t1)
        with self._lock:
            best = self._clock_rtt
            if best is None or rtt <= best * 1.25 + 1e-4:
                self._clock_offset = offset
                self._clock_rtt = rtt
            else:
                self._clock_rtt = best * 1.05

    def _beat_loop(self) -> None:
        while not self._stop.wait(self.lease_interval_s):
            with self._lock:
                hung = self._hang_until > self._clock()
            if hung:
                continue  # a hung worker misses its lease — that IS
                # the fault being injected
            st = self._persist_stats()
            batcher = getattr(self._svc, "batcher", None)
            payload = {
                "worker_id": self.worker_id,
                "generation": self.generation,
                "wal_seq": int(st.get("wal_seq", 0) or 0),
                "queue_depth": (0 if batcher is None
                                else int(batcher.depth())),
            }
            with self._lock:
                if self._clock_offset is not None:
                    payload["clock_offset_s"] = round(
                        self._clock_offset, 6)
                    payload["clock_rtt_s"] = round(
                        self._clock_rtt or 0.0, 6)
            t0 = self._clock()
            try:
                reply = protocol.post_json(
                    self.router_url.rstrip("/") + "/heartbeat",
                    payload, timeout=max(2.0,
                                         4.0 * self.lease_interval_s))
            except Exception:  # noqa: BLE001 — beat again next tick;
                continue  # the router's lease timer owns eviction
            self._note_clock(reply.get("now"), t0, self._clock())
            if reply.get("rereg"):
                # the router evicted us (e.g. we hung past the lease)
                # but the process survived: rejoin without a restart
                try:
                    self.register()
                except Exception:  # noqa: BLE001 — retried next beat
                    pass

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def run(self) -> int:
        slow_join = float(self.spec.get("slow_join_s", 0.0))
        if slow_join > 0:
            time.sleep(slow_join)  # chaos: a straggling rejoin
        self.build()
        self.start_server()
        signal.signal(signal.SIGTERM,
                      lambda *_: self._shutdown(True))
        self.register()
        self._beat_thread = threading.Thread(
            target=self._beat_loop, daemon=True,
            name="raft-tpu-fleet-%s-beat" % self.worker_id)
        self._beat_thread.start()
        self._stop.wait()
        return 0

    def _shutdown(self, snapshot: bool) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            if self._svc is not None:
                self._svc.close(drain=True, timeout=10.0,
                                snapshot=snapshot)
        finally:
            if self._plane is not None:
                self._plane.close()
            if self._server is not None:
                self._server.shutdown()
                self._server.server_close()


def main(argv) -> int:
    if len(argv) != 1:
        print("usage: python -m raft_tpu_torch.fleet.worker <spec.json>",
              file=sys.stderr)
        return 2
    with open(argv[0], "r", encoding="utf-8") as f:
        spec = json.load(f)
    device = str(spec.get("device", "cuda"))
    if device.startswith("cuda") and not torch.cuda.is_available():
        # no fallback: a worker asked for the card runs on the card
        print("raft_tpu_torch.fleet.worker %s: the spec asks for device %r but "
              "torch.cuda.is_available() is False" % (spec.get("worker_id"), device),
              file=sys.stderr)
        return 3
    worker = FleetWorker(spec)
    return worker.run()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
