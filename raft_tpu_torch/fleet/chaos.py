"""Fleet chaos harness: seeded process-level fault injection.

Port of ``raft_tpu/fleet/chaos.py`` (host-side only: the same schedules
from the same seed).  It carries the in-process fault-injection style
(seeded, reproducible, typed outcomes only) to PROCESS faults:

==============  ======================================================
``kill``        SIGKILL a worker mid-traffic (no goodbye, no
                snapshot), restart it after a scheduled delay — the
                crash-restart rejoin path (snapshot + WAL) under load
``hang``        freeze a worker's data plane AND heartbeats without
                killing it — only the router's lease protocol can
                notice; the worker un-hangs and must rejoin via the
                heartbeat ``rereg`` handshake
``slow_join``   the restart after a kill sleeps before building —
                a straggling rejoin stretching the degraded window
``frame``       a time window in which router→worker frames are
                dropped before send, and idempotent (search/scrape)
                response frames are garbled — both surface as typed
                :class:`CommError` and are absorbed by the router's
                retry policy.  Insert responses are never garbled:
                an insert ack is not idempotent to lose (the row is
                WAL-durable at the worker), so a chaos schedule that
                garbled acks would manufacture false double-insert
                failures rather than test real ones
``fsync_stall`` every WAL fsync at one worker sleeps — the
                acknowledge path slows, backpressure hints grow, and
                the contract under test is typed sheds, not loss
==============  ======================================================

Every schedule derives from ONE integer seed
(:meth:`ChaosSchedule.from_seed`) — any failure reproduces with the
printed seed, same as ``stress.sh faults``.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, List, Optional

from raft_tpu_torch.core.error import CommError
from raft_tpu_torch.fleet import protocol

__all__ = ["FrameFaults", "ChaosSchedule", "ChaosHarness"]


class FrameFaults:
    """Transport wrapper injecting frame faults inside armed windows.
    Drops happen BEFORE the frame is sent (a dropped insert never
    reached the worker, so the router's retry is duplicate-safe);
    garbles corrupt the RESPONSE of idempotent paths only (module
    doc)."""

    _IDEMPOTENT = ("/search", "/metrics", "/healthz", "/statusz",
                   "/debug/snapshot", "/debug/trace", "/debug/flight",
                   "/info")

    def __init__(self, seed: int, base=protocol.http_transport,
                 clock: Callable[[], float] = time.monotonic):
        self._rng = random.Random(seed)
        self._base = base
        self._clock = clock
        self._lock = threading.Lock()
        self._until = 0.0
        self._drop_p = 0.0
        self._garble_p = 0.0
        self.injected = {"drop": 0, "garble": 0}

    def arm(self, *, drop_p: float, garble_p: float,
            duration_s: float) -> None:
        with self._lock:
            self._drop_p = float(drop_p)
            self._garble_p = float(garble_p)
            self._until = self._clock() + float(duration_s)

    def disarm(self) -> None:
        with self._lock:
            self._until = 0.0

    def __call__(self, method: str, url: str, body, timeout: float,
                 headers=None):
        with self._lock:
            active = self._clock() < self._until
            drop = active and self._rng.random() < self._drop_p
            garble = active and self._rng.random() < self._garble_p
        if drop:
            with self._lock:
                self.injected["drop"] += 1
            raise CommError("chaos: injected frame drop (%s %s)"
                            % (method, url))
        if headers:
            status, data = self._base(method, url, body, timeout,
                                      headers)
        else:
            status, data = self._base(method, url, body, timeout)
        if garble and any(url.endswith(p) or ("%s?" % p) in url
                          for p in self._IDEMPOTENT):
            with self._lock:
                self.injected["garble"] += 1
            # flip bytes in the middle of the frame: json.loads fails,
            # protocol raises a typed CommError, the router retries
            data = bytes(b ^ 0xFF for b in data[:16]) + data[16:]
        return status, data


class ChaosSchedule:
    """A seeded, sorted list of timed fault events."""

    def __init__(self, events: List[dict]):
        self.events = sorted(events, key=lambda e: e["at"])

    @classmethod
    def from_seed(cls, seed: int, *, duration_s: float,
                  n_workers: int,
                  kinds=("kill", "hang", "slow_join", "frame",
                         "fsync_stall")) -> "ChaosSchedule":
        rng = random.Random(seed)
        events: List[dict] = []
        # one headline process fault per run (kill / hang /
        # slow_join), placed early enough that recovery is observable
        # before the run ends, plus 1-2 transport/persist faults
        process_kinds = [k for k in ("kill", "hang", "slow_join")
                         if k in kinds]
        headline = rng.choice(process_kinds) if process_kinds else None
        at = (0.15 + 0.25 * rng.random()) * duration_s
        w = rng.randrange(n_workers)
        if headline == "hang":
            events.append({"at": at, "kind": "hang", "worker": w,
                           "duration_s": min(2.0,
                                             0.4 * duration_s)})
        elif headline in ("kill", "slow_join"):
            events.append({
                "at": at, "kind": "kill", "worker": w,
                "restart_after_s": 0.2 + 0.3 * rng.random(),
                "slow_join_s": (0.5 + 0.5 * rng.random()
                                if headline == "slow_join" else 0.0)})
        if "frame" in kinds:
            events.append({
                "at": 0.1 + 0.5 * rng.random() * duration_s,
                "kind": "frame",
                "drop_p": 0.05 + 0.15 * rng.random(),
                "garble_p": 0.05 + 0.10 * rng.random(),
                "duration_s": 0.3 + 0.3 * duration_s * rng.random()})
        if "fsync_stall" in kinds and rng.random() < 0.5:
            events.append({
                "at": 0.1 + 0.6 * rng.random() * duration_s,
                "kind": "fsync_stall",
                "worker": rng.randrange(n_workers),
                "stall_s": 0.01 + 0.04 * rng.random(),
                "duration_s": 0.2 + 0.2 * duration_s})
        return cls(events)


class ChaosHarness:
    """Applies a :class:`ChaosSchedule` against a live
    :class:`~raft_tpu_torch.fleet.supervisor.Fleet` on a background thread;
    owns the restarts its kills require (autoheal stays off during a
    schedule so restart timing — including slow joins — is the
    schedule's, not a healer's)."""

    def __init__(self, fleet, schedule: ChaosSchedule,
                 frame_faults: Optional[FrameFaults] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.fleet = fleet
        self.schedule = schedule
        self.frame_faults = frame_faults
        self._clock = clock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.applied: List[dict] = []

    def start(self) -> "ChaosHarness":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="raft-tpu-fleet-chaos")
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def stop(self) -> None:
        self._stop.set()
        self.join(10.0)
        if self.frame_faults is not None:
            self.frame_faults.disarm()

    def _run(self) -> None:
        t0 = self._clock()
        # expand kills into (kill, restart) pairs up front so the
        # timeline stays a single sorted pass
        timeline: List[dict] = []
        for ev in self.schedule.events:
            timeline.append(ev)
            if ev["kind"] == "kill":
                timeline.append({
                    "at": ev["at"] + ev.get("restart_after_s", 0.3),
                    "kind": "restart", "worker": ev["worker"],
                    "slow_join_s": ev.get("slow_join_s", 0.0)})
        for ev in sorted(timeline, key=lambda e: e["at"]):
            while not self._stop.is_set():
                delay = ev["at"] - (self._clock() - t0)
                if delay <= 0:
                    break
                time.sleep(min(0.05, delay))
            if self._stop.is_set():
                return
            try:
                self._apply(ev)
                self.applied.append(dict(ev))
            except Exception as e:  # noqa: BLE001 — chaos must not
                # crash the driver; a failed injection is recorded
                self.applied.append(dict(ev, failed=str(e)))

    def _apply(self, ev: dict) -> None:
        kind = ev["kind"]
        wid = "w%d" % ev["worker"] if "worker" in ev else None
        if kind == "kill":
            self.fleet.kill(wid)
        elif kind == "restart":
            self.fleet.restart(wid,
                               slow_join_s=ev.get("slow_join_s", 0.0))
        elif kind == "hang":
            self._worker_chaos(wid, {"fault": "hang",
                                     "duration_s": ev["duration_s"]})
        elif kind == "frame":
            if self.frame_faults is not None:
                self.frame_faults.arm(drop_p=ev["drop_p"],
                                      garble_p=ev["garble_p"],
                                      duration_s=ev["duration_s"])
        elif kind == "fsync_stall":
            self._worker_chaos(wid, {"fault": "fsync_stall",
                                     "stall_s": ev["stall_s"],
                                     "duration_s": ev["duration_s"]})

    def _worker_chaos(self, wid: str, payload: dict) -> None:
        reg = self.fleet.router.registry().get(wid) or {}
        port = int(reg.get("data_port", 0) or 0)
        if port:
            protocol.post_json("http://127.0.0.1:%d/chaos" % port,
                               payload, timeout=5.0)
