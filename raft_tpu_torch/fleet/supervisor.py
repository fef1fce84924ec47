"""Fleet supervisor: spawn, kill, restart, drain — the process hands.

Port of ``raft_tpu/fleet/supervisor.py``.  The router
(:mod:`raft_tpu_torch.fleet.router`) decides *where traffic goes*; this
module owns *which processes exist*.  It spawns each worker as ``python
-m raft_tpu_torch.fleet.worker <spec.json>`` with its own persist dir,
restarts the dead (bumping the spec's generation so the router can tell
a rejoin from a duplicate), and runs the rolling restart choreography:
quiesce -> snapshot -> restart -> wait for rejoin, one worker at a time.

The device travels in the spec (``device``, default ``"cuda"``), so a
worker never picks one for itself.  On a CUDA device the supervisor
builds the kernels the workers run (:func:`raft_tpu_torch.ops._build.build`)
once, in its own process, before it spawns any: every worker then loads
the built libraries instead of running its own ``nvcc`` on the same
sources.  :meth:`Fleet.wait_ready` fails fast: a worker that exits
before it registers raises at once, naming its exit code and the tail
of its log.

Worker stdout/stderr land in ``<root>/<worker_id>.log``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.error import RaftError, expects
from raft_tpu_torch.fleet import protocol
from raft_tpu_torch.fleet.router import Router

__all__ = ["WorkerSpec", "Fleet"]

# the kernel libraries a worker loads: K2 (probe and merge), K3 (scan),
# K4 (the build's k-means) and K1 (warmup's brute-force probe)
WORKER_KERNELS = ("select_tile", "ivf_tile", "nn_tile", "knn_tile")


class WorkerSpec:
    """Everything a worker process needs, JSON-serializable.  The
    supervisor rewrites the spec file on every (re)launch — the
    ``generation`` field is how a rejoin proves it is a new
    incarnation of the same fault domain."""

    def __init__(self, worker_id: str, *, router_url: str,
                 index_rows: int, dim: int, k: int,
                 mode: str = "sharded", shard_index: int = 0,
                 shard_count: int = 1, seed: int = 0,
                 clusters: int = 0, nlist: Optional[int] = None,
                 nprobe: int = 8, persist_dir: Optional[str] = None,
                 persist_fsync: str = "always",
                 snapshot_interval_s: float = 2.0,
                 lease_interval_s: float = 0.5,
                 service_opts: Optional[dict] = None,
                 slow_join_s: float = 0.0, host: str = "127.0.0.1",
                 generation: int = 0, device: str = "cuda"):
        self.payload = {
            "worker_id": worker_id, "router_url": router_url,
            "index_rows": int(index_rows), "dim": int(dim),
            "k": int(k), "mode": mode,
            "shard_index": int(shard_index),
            "shard_count": int(shard_count), "seed": int(seed),
            "clusters": int(clusters), "nlist": nlist,
            "nprobe": int(nprobe), "persist_dir": persist_dir,
            "persist_fsync": persist_fsync,
            "snapshot_interval_s": float(snapshot_interval_s),
            "lease_interval_s": float(lease_interval_s),
            "service_opts": dict(service_opts or {}),
            "slow_join_s": float(slow_join_s), "host": host,
            "generation": int(generation), "device": str(device),
        }

    @property
    def worker_id(self) -> str:
        return str(self.payload["worker_id"])


class _Member:
    __slots__ = ("spec", "proc", "spec_path", "log_path", "spawns")

    def __init__(self, spec: WorkerSpec, spec_path: str,
                 log_path: str):
        self.spec = spec
        self.proc: Optional[subprocess.Popen] = None
        self.spec_path = spec_path
        self.log_path = log_path
        self.spawns = 0


class Fleet:
    """A router plus N supervised worker processes.

    ``mode="sharded"`` (default): worker *i* owns shard
    ``full[i::n]``; queries fan out and merge; inserts place by
    rendezvous on the row id.  ``mode="replicated"``: every worker
    holds the full index; queries place by rendezvous with hedged
    re-dispatch; query-only.

    ``device`` is every worker's device (``"cuda"`` unless the caller
    passes ``"cpu"``, as the CPU tests do).

    Use as a context manager; :meth:`close` tears down workers
    (clean SIGTERM first, SIGKILL stragglers) and the router, and leaves
    no worker process alive.
    """

    def __init__(self, n_workers: int, *, root: str, index_rows: int,
                 dim: int, k: int, mode: str = "sharded",
                 seed: int = 0, clusters: int = 0,
                 nlist: Optional[int] = None, nprobe: int = 8,
                 persist: bool = True,
                 persist_fsync: str = "always",
                 snapshot_interval_s: float = 2.0,
                 lease_interval_s: Optional[float] = None,
                 service_opts: Optional[dict] = None,
                 router: Optional[Router] = None,
                 device: str = "cuda",
                 python: str = sys.executable,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True):
        expects(n_workers >= 1, "Fleet: n_workers=%d", n_workers)
        # a fleet asked for the card fails here, before any router or
        # worker exists, when there is none
        resolve_device(device)
        self.n_workers = int(n_workers)
        self.mode = mode
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._clock = clock
        self._python = python
        self.device = str(device)
        self._lock = threading.Lock()
        self._heal_thread: Optional[threading.Thread] = None
        self._heal_stop = threading.Event()
        self._closed = False
        self.router = router or Router(
            mode=mode,
            shard_count=(n_workers if mode == "sharded" else 1),
            lease_interval_s=lease_interval_s)
        self._members: Dict[str, _Member] = {}
        for i in range(self.n_workers):
            wid = "w%d" % i
            spec = WorkerSpec(
                wid, router_url=self.router.url,
                index_rows=index_rows, dim=dim, k=k, mode=mode,
                shard_index=(i if mode == "sharded" else 0),
                shard_count=(n_workers if mode == "sharded" else 1),
                seed=seed, clusters=clusters, nlist=nlist,
                nprobe=nprobe,
                persist_dir=(os.path.join(self.root, wid)
                             if persist else None),
                persist_fsync=persist_fsync,
                snapshot_interval_s=snapshot_interval_s,
                lease_interval_s=self.router._lease_interval,
                service_opts=service_opts, device=self.device)
            self._members[wid] = _Member(
                spec, os.path.join(self.root, "%s.spec.json" % wid),
                os.path.join(self.root, "%s.log" % wid))
        if start:
            try:
                self.start()
            except BaseException:
                # a failed build or spawn leaves no router or worker behind
                self.close()
                raise

    # ------------------------------------------------------------------ #
    # process lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "Fleet":
        if self.device.startswith("cuda"):
            # build once, here: N workers would otherwise each run nvcc
            # on the same sources (race-safe, but not free)
            from raft_tpu_torch.ops import _build

            _build.build(WORKER_KERNELS)
        for wid in sorted(self._members):
            self.spawn(wid)
        return self

    def spawn(self, worker_id: str, *,
              slow_join_s: float = 0.0) -> subprocess.Popen:
        m = self._members[worker_id]
        with self._lock:
            if m.proc is not None and m.proc.poll() is None:
                return m.proc
            m.spec.payload["generation"] = m.spawns
            m.spec.payload["slow_join_s"] = float(slow_join_s)
            m.spawns += 1
            with open(m.spec_path, "w", encoding="utf-8") as f:
                json.dump(m.spec.payload, f, indent=1)
            env = dict(os.environ)
            # the worker resolves `-m raft_tpu_torch.fleet.worker` from
            # its own interpreter: when the supervisor imported the
            # package off sys.path (checkout, not site-packages), the
            # child needs the same root — a caller's cwd is not it
            pkg_root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            parts = env.get("PYTHONPATH", "")
            if pkg_root not in parts.split(os.pathsep):
                env["PYTHONPATH"] = (pkg_root + os.pathsep + parts
                                     if parts else pkg_root)
            log = open(m.log_path, "ab")
            try:
                m.proc = subprocess.Popen(
                    [self._python, "-m", "raft_tpu_torch.fleet.worker",
                     m.spec_path],
                    stdout=log, stderr=subprocess.STDOUT, env=env)
            finally:
                log.close()
            return m.proc

    def wait_ready(self, timeout: float = 120.0,
                   n: Optional[int] = None) -> List[str]:
        """Block until ``n`` (default: all) workers are registered and
        active; returns the active ids.  Raises on timeout — a fleet
        that never formed is a setup failure, not a degraded state —
        and at once when a worker process exits before it registers,
        naming its exit code and the tail of its log."""
        want = self.n_workers if n is None else int(n)
        deadline = self._clock() + timeout
        while True:
            active = self.router.active_workers()
            if len(active) >= want:
                return active
            self._raise_if_exited(active)
            if self._clock() > deadline:
                raise TimeoutError(
                    "fleet: %d/%d workers active after %.0fs (logs "
                    "under %s)" % (len(active), want, timeout,
                                   self.root))
            time.sleep(0.1)

    def _raise_if_exited(self, active: List[str]) -> None:
        """Raise for a worker whose process has exited without being
        active: nothing will bring it up, so waiting on is waste."""
        with self._lock:
            dead = [(wid, m.proc.returncode, m.log_path)
                    for wid, m in sorted(self._members.items())
                    if wid not in active and m.proc is not None
                    and m.proc.poll() is not None]
        if dead:
            wid, code, log_path = dead[0]
            try:
                with open(log_path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    f.seek(max(0, f.tell() - 2000))
                    tail = f.read().decode("utf-8", errors="replace")
            except OSError:
                tail = "<no log>"
            raise RaftError("fleet: worker %s exited with code %s before it registered "
                            "(log %s):\n%s" % (wid, code, log_path, tail),
                            collect_stack=False)

    def trace(self, request_id: str) -> dict:
        """The joined cross-process waterfall for one fleet request —
        the in-process twin of ``GET /fleet/debug/trace/<id>`` (same
        payload; tests and tools/loadgen.py call it without going
        through HTTP).  Raises ``KeyError`` for an unknown/evicted id
        so callers distinguish "never traced" from "empty join"."""
        status, payload = self.router.fleet_trace(request_id)
        if status != 200:
            raise KeyError("fleet trace %r: %s"
                           % (request_id, payload.get("message")))
        return payload

    def kill(self, worker_id: str,
             sig: int = signal.SIGKILL) -> None:
        """The crash path: no goodbye, no snapshot — the WAL is the
        contract (chaos harness; SIGKILL by default)."""
        m = self._members[worker_id]
        with self._lock:
            proc = m.proc
        if proc is not None and proc.poll() is None:
            proc.send_signal(sig)
            if sig in (signal.SIGKILL, signal.SIGTERM):
                proc.wait(timeout=30.0)

    def restart(self, worker_id: str, *,
                slow_join_s: float = 0.0) -> None:
        """Relaunch a (presumed dead) worker; it crash-restores from
        its persist dir and re-registers — the rejoin half of the
        crash-restart contract."""
        self.spawn(worker_id, slow_join_s=slow_join_s)

    def proc_alive(self, worker_id: str) -> bool:
        m = self._members[worker_id]
        with self._lock:
            proc = m.proc
        return proc is not None and proc.poll() is None

    # ------------------------------------------------------------------ #
    # choreography
    # ------------------------------------------------------------------ #
    def drain_restart(self, worker_id: str,
                      timeout: float = 120.0) -> None:
        """Quiesce → snapshot → handoff → restart for ONE worker:
        the router stops placing new inserts (typed sheds with a
        rejoin-scaled hint), the worker drains in-flight work and
        lands a final snapshot on clean shutdown, the supervisor
        relaunches it, and the router re-admits it on registration.
        The restarted worker replays a near-empty WAL (the snapshot
        just landed) — rolling maintenance costs seconds, not
        replay."""
        m = self._members[worker_id]
        self.router.begin_drain(worker_id)
        reg = self.router.registry().get(worker_id) or {}
        port = int(reg.get("data_port", 0) or 0)
        deadline = self._clock() + timeout
        if port and self.proc_alive(worker_id):
            try:
                protocol.post_json(
                    "http://127.0.0.1:%d/admin/shutdown" % port,
                    {"snapshot": True}, timeout=10.0)
            except Exception:  # noqa: BLE001 — SIGTERM is the backstop
                with self._lock:
                    proc = m.proc
                if proc is not None and proc.poll() is None:
                    proc.terminate()
        with self._lock:
            proc = m.proc
        if proc is not None:
            try:
                proc.wait(timeout=max(1.0, deadline - self._clock()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30.0)
        self.router.note_exit(worker_id, reason="drain")
        self.restart(worker_id)
        self._wait_worker_active(worker_id,
                                 max(1.0, deadline - self._clock()))

    def rolling_restart(self, timeout_per_worker: float = 120.0
                        ) -> None:
        """Drain-restart every worker, one at a time."""
        for wid in sorted(self._members):
            self.drain_restart(wid, timeout=timeout_per_worker)

    def _wait_worker_active(self, worker_id: str,
                            timeout: float) -> None:
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            reg = self.router.registry().get(worker_id) or {}
            if reg.get("state") == "active":
                return
            time.sleep(0.1)
        raise TimeoutError("fleet: %s not active after restart "
                           "(log: %s)" % (worker_id,
                                          self._members[
                                              worker_id].log_path))

    # ------------------------------------------------------------------ #
    # autoheal (the chaos loop's repair hand)
    # ------------------------------------------------------------------ #
    def start_autoheal(self, interval_s: float = 0.25) -> None:
        """Restart any worker whose PROCESS died (crash, chaos kill).
        Eviction of hung-but-alive workers stays with the router's
        lease protocol — healing is for dead processes only."""
        if self._heal_thread is not None:
            return
        self._heal_stop.clear()

        def _loop():
            while not self._heal_stop.wait(interval_s):
                for wid in sorted(self._members):
                    if self._closed:
                        return
                    if not self.proc_alive(wid):
                        self.router.note_exit(wid, reason="crash")
                        try:
                            self.restart(wid)
                        except Exception:  # noqa: BLE001 — retried
                            pass  # next heal tick

        self._heal_thread = threading.Thread(
            target=_loop, daemon=True, name="raft-tpu-fleet-heal")
        self._heal_thread.start()

    def stop_autoheal(self) -> None:
        self._heal_stop.set()
        t, self._heal_thread = self._heal_thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    # ------------------------------------------------------------------ #
    # teardown
    # ------------------------------------------------------------------ #
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.stop_autoheal()
        procs = []
        with self._lock:
            for m in self._members.values():
                if m.proc is not None and m.proc.poll() is None:
                    m.proc.terminate()
                    procs.append(m.proc)
        try:
            for p in procs:
                try:
                    p.wait(timeout=15.0)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=15.0)
        finally:
            self.router.close()

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
