"""Fleet router: placement, admission, retries, leases, aggregation.

Port of ``raft_tpu/fleet/router.py``, the front-end of the process
fleet; it does no device work.  One router process faces clients; N worker processes
(:mod:`raft_tpu_torch.fleet.worker`) own the data.  The router:

- **Places.**  Rendezvous hashing over the *stable worker roster* for
  inserts (a row's owner never moves when a worker dies — its WAL is
  the row's home, and the rejoining worker must line back up with the
  traffic the router sends it) and over the *live* membership for
  replicated-query placement.
- **Admits.**  A global in-flight cap sheds with a typed
  :class:`ServiceOverloadError` before any dispatch; per-worker
  ``retry_after_s`` hints from worker-side sheds are honored on the
  retry path (backpressure propagates end-to-end rather than being
  flattened into blind retries).
- **Retries and hedges.**  Deadline-aware retry-with-backoff absorbs
  transient faults (dropped/garbled frames, a worker mid-restart);
  in replicated mode a straggling primary gets a hedged re-dispatch
  to the next worker in rendezvous order after ``fleet_hedge_ms``
  (the in-process replica hedging lifted across processes) — first
  success wins, exactly once.
- **Fans out and merges.**  Sharded queries go to every live shard;
  the router merges per-shard top-k by ``(distance, id)``.  A shard
  with no live owner within the deadline yields a PARTIAL result
  carrying an explicit ``degraded`` flag — surviving shards keep
  serving rather than failing closed.
- **Leases.**  Workers heartbeat every ``fleet_lease_interval_s``;
  ``fleet_lease_misses`` missed beats is a typed eviction (flight
  event ``fleet_eviction``, ``raft_tpu_fleet_evictions_total``).  A
  re-registration after eviction is a ``fleet_rejoin`` — its replay
  depth and restore time feed the sentinel's ``rejoin_lag`` rule.
- **Aggregates.**  ``/fleet/metrics`` is one scrape surface: every
  worker's ``/metrics`` with a ``worker=`` label injected, plus the
  router's own registry.  ``/fleet/healthz`` rolls worker health into
  ``ok`` (anything still serving) + ``degraded`` (anything wrong).
  ``/debug/snapshot`` carries a ``fleet`` section so
  ``tools/torch_metrics_report.py --url`` works against a router unchanged.

Exactly-once accounting: every admitted request records
``fleet_admitted`` and EXACTLY one terminal ``fleet_resolved`` /
``fleet_failed`` / ``fleet_expired`` flight event — the chaos suites
assert this over the recorder, not over best-effort client counts.

The router is host-side routing state only: it imports no device
library and nothing of the JAX package.
"""

from __future__ import annotations

import http.server
import itertools
import json
import re
import threading
import time
import urllib.parse
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional, Tuple

from raft_tpu_torch import config
from raft_tpu_torch.core import flight
from raft_tpu_torch.core import metrics as _metrics
from raft_tpu_torch.core.error import (CommError, CommTimeoutError, LogicError,
                                 RaftError, ServiceOverloadError,
                                 ServiceUnavailableError, expects)
from raft_tpu_torch.fleet import protocol, tracing
from raft_tpu_torch.serve import sentinel as _sentinel

__all__ = ["Router"]

_router_seq = itertools.count()

# prometheus exposition line: name{labels} value  |  name value
_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)\s*$")


def _counter(name: str, help: str, **labels):
    return _metrics.default_registry().counter(
        name, help=help, labels=tuple(sorted(labels))).labels(**labels)


def _gauge(name: str, help: str, **labels):
    return _metrics.default_registry().gauge(
        name, help=help, labels=tuple(sorted(labels))).labels(**labels)


def _relabel_metrics(text: str, worker: str,
                     seen_meta: set) -> List[str]:
    """Inject ``worker="<id>"`` into every sample line of a prometheus
    exposition; de-duplicate ``# HELP``/``# TYPE`` lines across
    workers (one family header per aggregated surface)."""
    out: List[str] = []
    for line in text.splitlines():
        if line.startswith("#"):
            if line not in seen_meta:
                seen_meta.add(line)
                out.append(line)
            continue
        if not line.strip():
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            continue  # never forward a garbled line to a scraper
        name, _, labels, value = m.groups()
        # worker ids are operator input (hostile names included):
        # escape per the prometheus text format or the aggregated
        # surface stops round-tripping through parse_prometheus
        inner = 'worker="%s"' % _metrics._escape(worker)
        if labels:
            inner = "%s,%s" % (labels, inner)
        out.append("%s{%s} %s" % (name, inner, value))
    return out


class _WorkerHandle:
    """Router-side record of one worker process."""

    __slots__ = ("worker_id", "generation", "pid", "host", "data_port",
                 "ops_port", "shard_index", "state", "last_beat",
                 "wal_seq", "queue_depth", "registered_t", "restore",
                 "backpressure_until", "dead_t", "clock_offset",
                 "clock_rtt")

    def __init__(self, worker_id: str):
        self.worker_id = worker_id
        self.generation = 0
        self.pid = 0
        self.host = "127.0.0.1"
        self.data_port = 0
        self.ops_port = 0
        self.shard_index = 0
        self.state = "dead"  # until the first /register lands
        self.last_beat = 0.0
        self.wal_seq = 0
        self.queue_depth = 0
        self.registered_t = 0.0
        self.restore: Dict[str, object] = {}
        self.backpressure_until = 0.0
        self.dead_t = 0.0
        # NTP-style clock alignment, estimated worker-side over the
        # heartbeat ping and reported back: router_clock = worker_clock
        # + clock_offset, trustworthy to ~clock_rtt / 2
        self.clock_offset = 0.0
        self.clock_rtt = 0.0

    @property
    def data_url(self) -> str:
        return "http://%s:%d" % (self.host, self.data_port)

    @property
    def ops_url(self) -> str:
        return "http://%s:%d" % (self.host, self.ops_port)

    def public(self) -> dict:
        return {"worker_id": self.worker_id,
                "generation": self.generation, "pid": self.pid,
                "state": self.state, "shard_index": self.shard_index,
                "data_port": self.data_port, "ops_port": self.ops_port,
                "wal_seq": self.wal_seq,
                "queue_depth": self.queue_depth,
                "clock_offset_s": round(self.clock_offset, 6),
                "clock_rtt_s": round(self.clock_rtt, 6),
                "restore": dict(self.restore)}


class Router:
    """Module-doc router.  ``mode`` picks the fleet topology:
    ``"sharded"`` (disjoint shard per worker, fan-out + merge,
    single-owner inserts) or ``"replicated"`` (full index per worker,
    rendezvous placement + hedged re-dispatch, query-only)."""

    def __init__(self, *, mode: str = "sharded",
                 shard_count: Optional[int] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 lease_interval_s: Optional[float] = None,
                 lease_misses: Optional[int] = None,
                 retry_max: Optional[int] = None,
                 retry_backoff_s: Optional[float] = None,
                 hedge_ms: Optional[float] = None,
                 timeout_s: Optional[float] = None,
                 inflight_cap: Optional[int] = None,
                 sentinel: bool = True,
                 transport=protocol.http_transport,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True):
        expects(mode in ("sharded", "replicated"),
                "Router: mode=%r not in ('sharded', 'replicated')",
                mode)
        self.mode = mode
        self.shard_count = int(shard_count or 1)
        self._host = host
        self._want_port = int(port)
        self._lease_interval = (
            config.get_float("fleet_lease_interval_s")
            if lease_interval_s is None else float(lease_interval_s))
        self._lease_misses = (
            config.get_int("fleet_lease_misses")
            if lease_misses is None else int(lease_misses))
        self._retry_max = (config.get_int("fleet_retry_max")
                           if retry_max is None else int(retry_max))
        self._retry_backoff = (
            config.get_float("fleet_retry_backoff_s")
            if retry_backoff_s is None else float(retry_backoff_s))
        self._hedge_s = ((config.get_float("fleet_hedge_ms")
                          if hedge_ms is None else float(hedge_ms))
                         / 1000.0)
        self._timeout = (config.get_float("fleet_timeout_s")
                         if timeout_s is None else float(timeout_s))
        self._inflight_cap = (
            config.get_int("fleet_inflight_cap")
            if inflight_cap is None else int(inflight_cap))
        self._transport = transport
        self._clock = clock
        self._name = "router%d" % next(_router_seq)
        self._lock = threading.Lock()
        self._handles: Dict[str, _WorkerHandle] = {}
        self._roster: List[str] = []
        self._inflight = 0
        self._rid_seq = itertools.count()
        self._last_rejoin: Optional[dict] = None
        self._last_rejoin_t: Optional[float] = None
        self._started_t: Optional[float] = None
        self._server = None
        self._server_thread = None
        self._lease_thread = None
        self._stop = threading.Event()
        self._closed = False
        self._pool = ThreadPoolExecutor(
            max_workers=16,
            thread_name_prefix="raft-tpu-%s" % self._name)
        # fleet-level SLO burn + slowest-K exemplars: the router is
        # the only process that sees true client latency, so the
        # "fleet" service gets its own tracker next to the per-worker
        # ones the aggregation surfaces roll up
        self._slo = flight.slo_for(
            "fleet",
            target_s=config.get_float("serve_slo_target_ms") / 1e3,
            objective=config.get_float("serve_slo_objective"),
            windows_s=tuple(sorted(
                float(w) for w in
                config.get_float_list("serve_slo_windows_s"))),
            clock=clock)
        self._exemplars = flight.exemplars_for("fleet")
        self.sentinel = (_sentinel.AnomalySentinel(
            lambda: {"fleet": self}, clock=clock)
            if sentinel else None)
        if start:
            self.start()

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "Router":
        expects(not self._closed, "Router %s is closed", self._name)
        if self._server is not None:
            return self
        router = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: D102 — metrics only
                pass

            def do_GET(self):
                router._handle(self, "GET")

            def do_POST(self):
                router._handle(self, "POST")

        self._server = http.server.ThreadingHTTPServer(
            (self._host, self._want_port), _Handler)
        self._server.daemon_threads = True
        self._port = int(self._server.server_address[1])
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="raft-tpu-%s" % self._name)
        self._server_thread.start()
        self._started_t = self._clock()
        if self.sentinel is not None:
            _sentinel.register(self.sentinel)
        self._stop.clear()
        self._lease_thread = threading.Thread(
            target=self._lease_loop, daemon=True,
            name="raft-tpu-%s-lease" % self._name)
        self._lease_thread.start()
        return self

    @property
    def port(self) -> Optional[int]:
        return getattr(self, "_port", None)

    @property
    def url(self) -> Optional[str]:
        p = self.port
        return None if p is None else "http://%s:%d" % (self._host, p)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        if self.sentinel is not None:
            _sentinel.unregister(self.sentinel)
        srv, self._server = self._server, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        for t in (self._server_thread, self._lease_thread):
            if t is not None and t.is_alive():
                t.join(timeout=5.0)
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # membership
    # ------------------------------------------------------------------ #
    def _on_register(self, body: dict) -> Tuple[int, dict]:
        wid = str(body["worker_id"])
        now = self._clock()
        with self._lock:
            h = self._handles.get(wid)
            fresh = h is None
            if fresh:
                h = self._handles[wid] = _WorkerHandle(wid)
                self._roster.append(wid)
                self._roster.sort()
            was_dead = h.state in ("dead", "draining")
            rejoin = (not fresh) and (
                was_dead or int(body.get("generation", 0))
                > h.generation)
            h.generation = int(body.get("generation", 0))
            h.pid = int(body.get("pid", 0))
            h.host = str(body.get("host", self._host))
            h.data_port = int(body.get("data_port", 0))
            h.ops_port = int(body.get("ops_port", 0) or 0)
            h.shard_index = int(body.get("shard_index", 0))
            h.wal_seq = int(body.get("wal_seq", 0))
            h.restore = dict(body.get("restore") or {})
            h.state = "active"
            h.last_beat = now
            h.registered_t = now
            h.backpressure_until = 0.0
        if rejoin:
            _counter("raft_tpu_fleet_rejoins_total",
                     "workers re-registered after eviction/restart"
                     ).inc()
            rj = dict(h.restore)
            rj["worker_id"] = wid
            rj["generation"] = h.generation
            self._last_rejoin = rj
            self._last_rejoin_t = now
            flight.record("fleet_rejoin", service="fleet", worker=wid,
                          generation=h.generation,
                          replayed=rj.get("replayed_records"),
                          restore_s=rj.get("restore_s"))
        else:
            flight.record("fleet_join", service="fleet", worker=wid,
                          generation=h.generation,
                          shard=h.shard_index)
        self._publish_worker_gauges()
        # "now" seeds the worker's clock-offset estimator (NTP-style
        # midpoint over this very exchange) before the first heartbeat
        return 200, {"ok": True,
                     "lease_interval_s": self._lease_interval,
                     "rejoin": bool(rejoin),
                     "now": round(now, 6)}

    def _on_heartbeat(self, body: dict) -> Tuple[int, dict]:
        wid = str(body.get("worker_id", ""))
        now = self._clock()
        with self._lock:
            h = self._handles.get(wid)
            if h is None or h.state == "dead":
                # evicted (or unknown): tell the survivor to rejoin —
                # a long hang must not leave a live-but-unrouted zombie
                return 200, {"ok": False, "rereg": True,
                             "now": round(now, 6)}
            h.last_beat = now
            h.wal_seq = int(body.get("wal_seq", h.wal_seq))
            h.queue_depth = int(body.get("queue_depth", 0))
            if body.get("clock_offset_s") is not None:
                try:
                    h.clock_offset = float(body["clock_offset_s"])
                    h.clock_rtt = float(body.get("clock_rtt_s", 0.0))
                except (TypeError, ValueError):
                    pass  # a garbled estimate must not drop the beat
        _gauge("raft_tpu_fleet_clock_offset_seconds",
               "estimated worker->router monotonic clock offset "
               "(router = worker + offset), NTP-style over the "
               "heartbeat ping", worker=wid).set(h.clock_offset)
        _gauge("raft_tpu_fleet_clock_rtt_seconds",
               "heartbeat round-trip time backing the clock-offset "
               "estimate (alignment is trusted to ~rtt/2)",
               worker=wid).set(h.clock_rtt)
        return 200, {"ok": True, "now": round(now, 6)}

    def _lease_loop(self) -> None:
        while not self._stop.wait(self._lease_interval):
            now = self._clock()
            horizon = self._lease_interval * self._lease_misses
            expired: List[_WorkerHandle] = []
            with self._lock:
                for h in self._handles.values():
                    if (h.state in ("active", "draining")
                            and now - h.last_beat > horizon):
                        expired.append(h)
            for h in expired:
                self._evict(h, "missed_lease")
            if self.sentinel is not None:
                self.sentinel.tick()

    def _evict(self, h: _WorkerHandle, reason: str) -> None:
        with self._lock:
            if h.state == "dead":
                return
            h.state = "dead"
            h.dead_t = self._clock()
        _counter("raft_tpu_fleet_evictions_total",
                 "workers evicted from the fleet, by cause",
                 reason=reason).inc()
        flight.record("fleet_eviction", service="fleet",
                      worker=h.worker_id, reason=reason,
                      generation=h.generation)
        self._publish_worker_gauges()

    def begin_drain(self, worker_id: str) -> dict:
        """Choreography step 1: stop placing NEW inserts on the worker
        (they shed typed, with a rejoin-scaled ``retry_after_s``);
        queries keep routing to it until it actually exits — drain
        narrows the blast radius, it does not widen it."""
        with self._lock:
            h = self._handles.get(worker_id)
            expects(h is not None, "begin_drain: unknown worker %r",
                    worker_id)
            if h.state == "active":
                h.state = "draining"
        flight.record("fleet_drain", service="fleet", worker=worker_id)
        self._publish_worker_gauges()
        return {"worker_id": worker_id, "state": "draining"}

    def note_exit(self, worker_id: str, reason: str = "exit") -> None:
        """Supervisor-observed process exit: immediate typed eviction
        (no need to wait out the lease when the exit was witnessed)."""
        with self._lock:
            h = self._handles.get(worker_id)
        if h is not None:
            self._evict(h, reason)

    def _publish_worker_gauges(self) -> None:
        with self._lock:
            counts = {"active": 0, "draining": 0, "dead": 0}
            for h in self._handles.values():
                counts[h.state] = counts.get(h.state, 0) + 1
        for state, n in counts.items():
            _gauge("raft_tpu_fleet_workers",
                   "fleet workers by lifecycle state",
                   state=state).set(n)

    # ------------------------------------------------------------------ #
    # views
    # ------------------------------------------------------------------ #
    def registry(self) -> Dict[str, dict]:
        with self._lock:
            return {wid: h.public()
                    for wid, h in sorted(self._handles.items())}

    def active_workers(self) -> List[str]:
        with self._lock:
            return sorted(w for w, h in self._handles.items()
                          if h.state == "active")

    def fleet_stats(self) -> dict:
        """The sentinel's view (rules ``worker_dead``/``rejoin_lag``)."""
        with self._lock:
            dead = sum(1 for h in self._handles.values()
                       if h.state == "dead")
            total = len(self._handles)
        rj = None
        if self._last_rejoin is not None:
            rj = dict(self._last_rejoin)
            # age lets the sentinel treat a slow rejoin as an incident
            # that expires (``ops_sentinel_rejoin_hold_s``), not a
            # permanently latched degradation
            if self._last_rejoin_t is not None:
                rj["age_s"] = max(0.0,
                                  self._clock() - self._last_rejoin_t)
        return {"workers_total": total, "workers_dead": dead,
                "last_rejoin": rj}

    # ------------------------------------------------------------------ #
    # data plane: search
    # ------------------------------------------------------------------ #
    def search(self, vectors, *, tenant: Optional[str] = None,
               timeout_s: Optional[float] = None,
               request_id: Optional[str] = None) -> dict:
        expects(isinstance(vectors, (list, tuple)) and len(vectors) > 0,
                "Router.search: vectors must be a non-empty list of "
                "rows")
        timeout = self._timeout if timeout_s is None else float(
            timeout_s)
        rid = request_id or "flt-%08d" % next(self._rid_seq)
        rtrace = self._new_trace(rid, tenant)
        self._admit(rid, "search", rtrace)
        t0 = self._clock()
        deadline = t0 + timeout
        try:
            if self.mode == "replicated":
                out = self._search_replicated(list(vectors), tenant,
                                              deadline, rid, rtrace)
            else:
                out = self._search_sharded(list(vectors), tenant,
                                           deadline, rid, rtrace)
        except CommTimeoutError as e:
            self._terminal(rid, "search", "expired", t0, rtrace,
                           tenant=tenant, error=type(e).__name__)
            raise
        except BaseException as e:
            self._terminal(rid, "search", "failed", t0, rtrace,
                           tenant=tenant, error=type(e).__name__)
            raise
        else:
            self._terminal(rid, "search", "resolved", t0, rtrace,
                           tenant=tenant, degraded=out["degraded"])
            if out["degraded"]:
                _counter("raft_tpu_fleet_degraded_total",
                         "partial (degraded-flagged) fleet responses"
                         ).inc()
            out["request_id"] = rid
            return out
        finally:
            with self._lock:
                self._inflight -= 1

    def _new_trace(self, rid: str, tenant: Optional[str]):
        """The router's own span timeline for one fleet request,
        indexed by the fleet id (= the request id) in the router-local
        flight ring — the half of ``/fleet/debug/trace/<id>`` this
        process owns."""
        return flight.default_recorder().new_trace(
            "fleet", tenant, fleet={"id": rid, "parent": "client"})

    def _admit(self, rid: str, op: str, trace=None) -> None:
        with self._lock:
            if self._closed:
                raise ServiceUnavailableError(
                    "router is closed", "fleet", "worker_dead")
            if self._inflight >= self._inflight_cap:
                _counter("raft_tpu_fleet_requests_total",
                         "fleet requests by terminal outcome",
                         outcome="shed").inc()
                raise ServiceOverloadError(
                    "fleet admission cap reached", self._inflight,
                    self._inflight_cap,
                    retry_after_s=self._lease_interval)
            self._inflight += 1
        flight.record("fleet_admitted", service="fleet", trace=trace,
                      rid=rid, op=op)

    def _terminal(self, rid: str, op: str, outcome: str, t0: float,
                  trace=None, tenant: Optional[str] = None,
                  **attrs) -> None:
        latency = max(0.0, self._clock() - t0)
        flight.record("fleet_%s" % outcome, service="fleet",
                      trace=trace, rid=rid, op=op,
                      latency_s=round(latency, 6), **attrs)
        _counter("raft_tpu_fleet_requests_total",
                 "fleet requests by terminal outcome",
                 outcome=outcome).inc()
        _metrics.default_registry().timer(
            "raft_tpu_fleet_request_seconds",
            help="router end-to-end request latency",
            labels=("op",)).labels(op=op).observe(latency)
        self._slo.observe(tenant, latency,
                          deadline_ok=(outcome == "resolved"))
        if trace is not None:
            self._exemplars.observe(latency, trace.trace_id)

    def _search_sharded(self, vectors, tenant, deadline, rid,
                        trace=None) -> dict:
        shards = list(range(self.shard_count))
        futs = {self._pool.submit(self._query_shard, s, vectors,
                                  tenant, deadline, rid, trace): s
                for s in shards}
        parts, answered = [], []
        remaining = max(0.0, deadline - self._clock())
        done, pending = wait(list(futs), timeout=remaining + 1.0)
        for f in pending:
            f.cancel()
        for f in done:
            part = f.result()  # LogicError propagates: caller bug
            if part is not None:
                parts.append(part)
                answered.append(futs[f])
        if not parts:
            raise ServiceUnavailableError(
                "no fleet shard answered within the deadline",
                "fleet", "no_workers",
                retry_after_s=self._lease_interval)
        k = max(len(row) for d, _ in parts for row in d)
        dists, ids = protocol.merge_topk(parts, k)
        degraded = len(parts) < len(shards)
        flight.record("fleet_merge", service="fleet", trace=trace,
                      rid=rid, parts=len(parts), k=k,
                      degraded=degraded)
        return {"distances": dists, "ids": ids, "degraded": degraded,
                "shards_answered": sorted(answered),
                "shards_total": len(shards), "hedged": False}

    def _shard_owner(self, shard: int) -> Optional[_WorkerHandle]:
        with self._lock:
            for h in self._handles.values():
                if (h.shard_index == shard
                        and h.state in ("active", "draining")):
                    return h
        return None

    def _rpc(self, h: _WorkerHandle, path: str, body: dict,
             remaining: float, rid: str, trace, attempt: int) -> dict:
        """One traced router→worker exchange: the propagated trace
        context rides the body (and the :data:`protocol.TRACE_HEADER`
        mirror), the span pair ``fleet_rpc_send``/``fleet_rpc_recv``
        lands in the router's flight ring, and the network residual
        (wire + queue time outside the worker's own handler clock)
        feeds ``raft_tpu_fleet_network_seconds`` per worker."""
        sent_at = self._clock()
        tctx = protocol.trace_frame(rid, "router", sent_at)
        body = dict(body)
        body["trace"] = tctx
        flight.record("fleet_rpc_send", service="fleet", trace=trace,
                      rid=rid, worker=h.worker_id, path=path,
                      attempt=attempt)
        try:
            rep = protocol.post_json(
                h.data_url + path, body, timeout=remaining + 1.0,
                transport=self._transport, trace=tctx)
        except BaseException as e:
            flight.record("fleet_rpc_fail", service="fleet",
                          trace=trace, rid=rid, worker=h.worker_id,
                          path=path, attempt=attempt,
                          error=type(e).__name__)
            raise
        elapsed = max(0.0, self._clock() - sent_at)
        server_s = rep.get("server_seconds")
        network_s = None
        if server_s is not None:
            try:
                network_s = max(0.0, elapsed - float(server_s))
            except (TypeError, ValueError):
                server_s = None
        # a hedged loser's reply lands AFTER the request already
        # terminated (first success won); tag it so the join keeps
        # the straggler visible without it breaking the RPC-bracket
        # invariants or stretching the merge segment
        late = trace is not None and any(
            e.get("kind") in tracing.ROUTER_TERMINALS
            for e in trace.timeline())
        extra = {"late": True} if late else {}
        flight.record("fleet_rpc_recv", service="fleet", trace=trace,
                      rid=rid, worker=h.worker_id, path=path,
                      attempt=attempt, elapsed_s=round(elapsed, 6),
                      server_s=server_s, network_s=network_s, **extra)
        if network_s is not None:
            _metrics.default_registry().timer(
                "raft_tpu_fleet_network_seconds",
                help="router->worker RPC time outside the worker's "
                     "own handler (wire + accept-queue residual), "
                     "per worker",
                labels=("worker",)).labels(
                    worker=h.worker_id).observe(network_s)
        return rep

    def _query_shard(self, shard, vectors, tenant, deadline,
                     rid, trace=None) -> Optional[tuple]:
        """One shard's retry loop.  Returns ``(distances, ids)`` or
        None when the shard stayed unreachable through the deadline —
        the caller degrades instead of failing closed.  Caller bugs
        (:class:`LogicError`) propagate: they would fail identically
        everywhere."""
        attempt = 0
        backoff = self._retry_backoff
        while True:
            now = self._clock()
            remaining = deadline - now
            if remaining <= 0 or attempt > self._retry_max:
                return None
            h = self._shard_owner(shard)
            wait_s = backoff
            if h is not None:
                try:
                    rep = self._rpc(
                        h, "/search",
                        {"vectors": vectors, "tenant": tenant,
                         "timeout_s": round(remaining, 3)},
                        remaining, rid, trace, attempt)
                    return rep["distances"], rep["ids"]
                except LogicError:
                    raise
                except ServiceOverloadError as e:
                    self._note_backpressure(h, e.retry_after_s)
                    wait_s = max(backoff, e.retry_after_s)
                except ServiceUnavailableError as e:
                    wait_s = max(backoff, e.retry_after_s)
                except CommTimeoutError:
                    self._note_frame_error("timeout")
                except CommError:
                    self._note_frame_error("comm")
            attempt += 1
            _counter("raft_tpu_fleet_retries_total",
                     "per-shard/worker dispatch retries", op="search"
                     ).inc()
            time.sleep(max(0.0, min(wait_s, deadline - self._clock())))
            backoff *= 2.0

    def _search_replicated(self, vectors, tenant, deadline,
                           rid, trace=None) -> dict:
        order = protocol.rendezvous_rank(tenant or rid,
                                         self.active_workers())
        if not order:
            raise ServiceUnavailableError(
                "fleet has no live workers", "fleet", "no_workers",
                retry_after_s=self._lease_interval)
        payload = {"vectors": vectors, "tenant": tenant}
        futs = {self._pool.submit(self._query_worker, order[0],
                                  payload, deadline, rid=rid,
                                  trace=trace): order[0]}
        hedged = False
        last_error: Optional[BaseException] = None
        winner = None
        while True:
            now = self._clock()
            remaining = deadline - now
            if remaining <= 0:
                for f in futs:
                    f.cancel()
                raise CommTimeoutError(
                    "fleet search deadline exceeded (%s)" % rid)
            can_hedge = (not hedged and len(order) > 1
                         and self._hedge_s > 0)
            slice_s = (min(remaining, self._hedge_s) if can_hedge
                       else remaining)
            done, _pending = wait(list(futs), timeout=slice_s,
                                  return_when=FIRST_COMPLETED)
            for f in done:
                wid = futs.pop(f)
                try:
                    rep = f.result()
                except (RaftError, OSError) as e:
                    last_error = e
                    continue
                winner = wid
                if hedged and wid != order[0]:
                    _counter("raft_tpu_fleet_hedge_wins_total",
                             "hedged re-dispatches that beat the "
                             "primary").inc()
                return {"distances": rep["distances"],
                        "ids": rep["ids"], "degraded": False,
                        "worker": winner, "hedged": hedged,
                        "shards_total": 1, "shards_answered": [0]}
            if not futs and (done or last_error is not None):
                if not can_hedge:
                    raise (last_error or ServiceUnavailableError(
                        "all fleet replicas failed", "fleet",
                        "no_workers"))
            if can_hedge:
                hedged = True
                _counter("raft_tpu_fleet_hedges_total",
                         "hedged cross-worker re-dispatches").inc()
                flight.record("fleet_hedge", service="fleet",
                              trace=trace, rid=rid, worker=order[1],
                              primary=order[0])
                futs[self._pool.submit(self._query_worker, order[1],
                                       payload, deadline, rid=rid,
                                       trace=trace)] = order[1]

    def _query_worker(self, worker_id: str, payload: dict,
                      deadline: float, *, path: str = "/search",
                      op: str = "search",
                      rid: Optional[str] = None, trace=None) -> dict:
        """Pinned-worker retry loop (replicated queries, insert
        groups): retries the SAME worker — cross-worker failover is
        the hedger's/owner-contract's decision, not this loop's."""
        attempt = 0
        backoff = self._retry_backoff
        last: Optional[BaseException] = None
        while True:
            now = self._clock()
            remaining = deadline - now
            if remaining <= 0 or attempt > self._retry_max:
                raise (last or CommTimeoutError(
                    "fleet dispatch deadline exceeded for %s"
                    % worker_id))
            with self._lock:
                h = self._handles.get(worker_id)
                live = h is not None and h.state == "active"
            wait_s = backoff
            if live:
                try:
                    body = dict(payload)
                    body["timeout_s"] = round(remaining, 3)
                    if rid is not None:
                        return self._rpc(h, path, body, remaining,
                                         rid, trace, attempt)
                    return protocol.post_json(
                        h.data_url + path,
                        body, timeout=remaining + 1.0,
                        transport=self._transport)
                except LogicError:
                    raise
                except ServiceOverloadError as e:
                    self._note_backpressure(h, e.retry_after_s)
                    last = e
                    wait_s = max(backoff, e.retry_after_s)
                except ServiceUnavailableError as e:
                    last = e
                    wait_s = max(backoff, e.retry_after_s)
                except CommTimeoutError as e:
                    last = e
                    self._note_frame_error("timeout")
                except CommError as e:
                    last = e
                    self._note_frame_error("comm")
            else:
                last = ServiceUnavailableError(
                    "fleet worker %s is not serving" % worker_id,
                    "fleet", "worker_dead",
                    retry_after_s=self._lease_interval)
            attempt += 1
            _counter("raft_tpu_fleet_retries_total",
                     "per-shard/worker dispatch retries", op=op).inc()
            time.sleep(max(0.0, min(wait_s, deadline - self._clock())))
            backoff *= 2.0

    def _note_backpressure(self, h: _WorkerHandle,
                           retry_after_s: float) -> None:
        with self._lock:
            h.backpressure_until = max(
                h.backpressure_until,
                self._clock() + max(0.0, retry_after_s))

    @staticmethod
    def _note_frame_error(kind: str) -> None:
        _counter("raft_tpu_fleet_frame_errors_total",
                 "router<->worker transport faults by kind",
                 kind=kind).inc()

    # ------------------------------------------------------------------ #
    # data plane: insert
    # ------------------------------------------------------------------ #
    def insert(self, ids, vectors, *,
               timeout_s: Optional[float] = None,
               request_id: Optional[str] = None) -> dict:
        """Placed, WAL-acked ingestion.  Returns a result dict rather
        than raising on partial failure: rows in ``acked_ids`` are
        DURABLE at their owner (WAL-acked before the worker replied)
        no matter what the other groups did — collapsing a partial
        ack into an exception would lose exactly that information.
        ``ok`` is True only when every row acked."""
        expects(self.mode == "sharded",
                "Router.insert: the replicated fleet is query-only "
                "(per-replica WALs would diverge); use sharded mode")
        expects(isinstance(ids, (list, tuple)) and len(ids) > 0
                and len(ids) == len(vectors),
                "Router.insert: ids and vectors must be equal-length "
                "non-empty lists")
        timeout = self._timeout if timeout_s is None else float(
            timeout_s)
        rid = request_id or "flt-%08d" % next(self._rid_seq)
        rtrace = self._new_trace(rid, None)
        self._admit(rid, "insert", rtrace)
        t0 = self._clock()
        deadline = t0 + timeout
        try:
            return self._insert_admitted(ids, vectors, rid, t0,
                                         deadline, rtrace)
        except BaseException as e:
            self._terminal(rid, "insert", "failed", t0, rtrace,
                           error=type(e).__name__)
            raise
        finally:
            with self._lock:
                self._inflight -= 1

    def _insert_admitted(self, ids, vectors, rid: str, t0: float,
                         deadline: float, rtrace=None) -> dict:
        with self._lock:
            roster = list(self._roster)
        if not roster:
            raise ServiceUnavailableError(
                "fleet has no registered workers", "fleet",
                "no_workers", retry_after_s=self._lease_interval)
        groups: Dict[str, Tuple[list, list]] = {}
        for i, v in zip(ids, vectors):
            owner = protocol.rendezvous(str(int(i)), roster)
            g = groups.setdefault(owner, ([], []))
            g[0].append(int(i))
            g[1].append(v)
        futs = {self._pool.submit(self._insert_group, wid, g[0],
                                  g[1], deadline, rid,
                                  rtrace): (wid, g[0])
                for wid, g in groups.items()}
        acked: List[int] = []
        errors: List[dict] = []
        wal: Dict[str, int] = {}
        remaining = max(0.0, deadline - self._clock())
        done, pending = wait(list(futs), timeout=remaining + 1.0)
        for f in pending:
            f.cancel()
            wid, gids = futs[f]
            errors.append(protocol.encode_error(CommTimeoutError(
                "insert group for %s missed the deadline" % wid)))
        for f in done:
            wid, gids = futs[f]
            try:
                rep = f.result()
            except BaseException as e:  # noqa: BLE001 — typed out
                errors.append(protocol.encode_error(e))
                continue
            acked.extend(gids)
            wal[wid] = int(rep.get("wal_seq", 0))
        ok = not errors and len(acked) == len(ids)
        self._terminal(rid, "insert",
                       "resolved" if ok else "failed", t0, rtrace,
                       acked=len(acked), failed_groups=len(errors))
        return {"ok": ok, "request_id": rid, "acked_ids": sorted(acked),
                "errors": errors, "wal": wal}

    def _insert_group(self, worker_id: str, gids: list, gvecs: list,
                      deadline: float, rid: Optional[str] = None,
                      trace=None) -> dict:
        with self._lock:
            h = self._handles.get(worker_id)
            if h is not None and h.state == "draining":
                # drain choreography: inserts shed typed with a hint
                # scaled to the restart window; the caller's retry
                # lands after rejoin
                raise ServiceUnavailableError(
                    "fleet worker %s is draining" % worker_id,
                    "fleet", "recovering",
                    retry_after_s=self._lease_interval
                    * self._lease_misses)
            bp = 0.0 if h is None else h.backpressure_until
        now = self._clock()
        if bp > now:
            # worker-side shed hint honored BEFORE dispatch: end-to-end
            # backpressure propagation, not blind hammering
            time.sleep(min(bp - now, max(0.0, deadline - now)))
        return self._query_worker(worker_id,
                                  {"ids": gids, "vectors": gvecs},
                                  deadline, path="/insert",
                                  op="insert", rid=rid, trace=trace)

    # ------------------------------------------------------------------ #
    # aggregation surfaces
    # ------------------------------------------------------------------ #
    def _scrape(self, url: str, timeout: float = 2.0):
        try:
            status, data = self._transport("GET", url, None, timeout)
            return status, data
        except (RaftError, OSError):
            _counter("raft_tpu_fleet_scrape_errors_total",
                     "failed worker metric/health scrapes").inc()
            return None, b""

    def fleet_metrics_text(self) -> str:
        """One scrape surface: every live worker's ``/metrics`` with a
        ``worker=`` label injected, plus the router's own registry."""
        seen_meta: set = set()
        lines: List[str] = []
        lines.extend(_relabel_metrics(
            _metrics.default_registry().to_prometheus(), "router",
            seen_meta))
        for wid, h in sorted(self.registry().items()):
            if h["state"] == "dead" or not h["ops_port"]:
                continue
            status, data = self._scrape(
                "http://%s:%d/metrics"
                % (self._handles[wid].host, h["ops_port"]))
            if status != 200:
                continue
            lines.extend(_relabel_metrics(
                data.decode("utf-8", errors="replace"), wid,
                seen_meta))
        return "\n".join(lines) + "\n"

    def fleet_health(self) -> Tuple[bool, dict]:
        """Aggregate health: ``ok`` while ANYTHING still serves (a
        partial fleet keeps taking traffic — that is the point);
        ``degraded`` is the FAULT-DOMAIN signal — a worker is
        dead/unreachable or a fleet sentinel rule is active.  A worker
        whose own ops ``/healthz`` reads 503 (an internal anomaly —
        say ``wal_depth`` under an ingest burst) is still serving:
        that surfaces as ``workers[wid]["degraded"]`` for drill-down
        but does NOT flip the fleet flag, or any write-heavy fleet
        would page "degraded" while every fault domain is intact."""
        workers: Dict[str, dict] = {}
        alive = 0
        any_bad = False
        for wid, pub in self.registry().items():
            entry = {"state": pub["state"], "ok": False}
            if pub["state"] == "dead" or not pub["ops_port"]:
                any_bad = True
                workers[wid] = entry
                continue
            status, data = self._scrape(
                "http://%s:%d/healthz"
                % (self._handles[wid].host, pub["ops_port"]))
            body = {}
            if status is not None:
                try:
                    body = json.loads(data.decode("utf-8"))
                except ValueError:
                    body = {}
            # liveness = the worker's ops plane answered at all (its
            # /healthz returns 503 while internally degraded)
            entry["ok"] = status is not None
            entry["degraded"] = bool(status != 200
                                     or body.get("degraded", False)
                                     or not body.get("ok", True))
            if not entry["ok"]:
                any_bad = True
            alive += 1 if entry["ok"] else 0
            workers[wid] = entry
        sent_degraded = (self.sentinel is not None
                         and self.sentinel.degraded())
        ok = alive > 0
        return ok, {"ok": ok,
                    "degraded": bool(any_bad or sent_degraded
                                     or not ok),
                    "mode": self.mode, "workers": workers,
                    "sentinel": ({"degraded": sent_degraded,
                                  "active": self.sentinel.active()}
                                 if self.sentinel is not None
                                 else None)}

    def fleet_trace(self, fleet_id: str) -> Tuple[int, dict]:
        """``/fleet/debug/trace/<id>``: the cross-process waterfall —
        the router's own hop spans joined with every involved worker's
        local timeline (fetched live from the worker's ``/debug/trace``
        endpoint), each worker's clock shifted by its heartbeat-
        estimated offset.  The reply carries the joined ``spans``, the
        per-hop summaries, the alignment metadata, and the waterfall
        invariant ``problems`` (empty = monotonic and gapless) —
        ``tools/torch_trace_report.py`` renders it."""
        fleet_id = str(fleet_id)
        router_events: List[dict] = []
        for t in flight.fleet_traces(fleet_id):
            router_events.extend(t.timeline())
        if not router_events:
            _counter("raft_tpu_fleet_trace_joins_total",
                     "cross-process trace joins by outcome",
                     outcome="missing").inc()
            return 404, {"error": "NotFound",
                         "message": "unknown fleet trace %r (evicted "
                                    "or never admitted)" % fleet_id}
        wids = sorted({str(e["worker"]) for e in router_events
                       if e.get("worker") is not None})
        workers: Dict[str, dict] = {}
        partial = False
        for wid in wids:
            with self._lock:
                h = self._handles.get(wid)
                offset = h.clock_offset if h is not None else 0.0
                rtt = h.clock_rtt if h is not None else 0.0
                url = (h.data_url if h is not None and h.data_port
                       else None)
            payload = None
            if url is not None:
                status, data = self._scrape(
                    "%s/debug/trace?id=%s"
                    % (url, urllib.parse.quote(fleet_id, safe="")))
                if status == 200:
                    try:
                        payload = json.loads(data.decode("utf-8"))
                    except ValueError:
                        payload = None
            if payload is None:
                partial = True  # dead/unreachable worker: router half
                payload = {}    # of the hop still renders
            workers[wid] = {"offset_s": offset, "rtt_s": rtt,
                            "payload": payload}
        joined = tracing.join(fleet_id, router_events, workers)
        joined["partial"] = partial
        joined["problems"] = tracing.validate(joined)
        _counter("raft_tpu_fleet_trace_joins_total",
                 "cross-process trace joins by outcome",
                 outcome="partial" if partial else "ok").inc()
        return 200, joined

    def fleet_snapshot(self) -> dict:
        """The ``/debug/snapshot`` payload ``tools/torch_metrics_report.py
        --url`` consumes: router registry + per-worker digests + a
        fleet-wide rollup (p99 from the router's own end-to-end timer
        — the only process that sees true client latency)."""
        digests: Dict[str, dict] = {}
        exemplars: List[dict] = []
        for ex in flight.exemplars_for("fleet").snapshot():
            exemplars.append(dict(ex, worker="router",
                                  service="fleet"))
        for wid, pub in self.registry().items():
            digest = {"state": pub["state"],
                      "generation": pub["generation"],
                      "wal_seq": pub["wal_seq"],
                      "queue_depth": pub["queue_depth"]}
            if pub["state"] != "dead" and pub["ops_port"]:
                status, data = self._scrape(
                    "http://%s:%d/debug/snapshot"
                    % (self._handles[wid].host, pub["ops_port"]))
                if status == 200:
                    try:
                        snap = json.loads(data.decode("utf-8"))
                    except ValueError:
                        snap = {}
                    digest.update(self._digest(
                        snap.get("metrics") or {}))
                    for svc, entries in sorted(
                            ((snap.get("flight") or {})
                             .get("exemplars") or {}).items()):
                        for ex in entries:
                            exemplars.append(dict(
                                ex, worker=wid, service=svc))
            digests[wid] = digest
        # fleet-wide slowest-K with per-worker labels: a p99 number on
        # the rollup links straight to the process that produced it
        exemplars.sort(key=lambda e: -float(e.get("latency_ms", 0.0)))
        del exemplars[8:]
        reg = _metrics.default_registry()
        rollup = {"workers_total": len(digests),
                  "workers_dead": sum(
                      1 for d in digests.values()
                      if d["state"] == "dead"),
                  "slo_burn_max": max(
                      [d.get("slo_burn", 0.0)
                       for d in digests.values()] or [0.0]),
                  "exemplars": exemplars}
        fam = reg.get("raft_tpu_fleet_request_seconds")
        total_reqs = 0
        if fam is not None:
            for labels, series in fam.series():
                total_reqs += int(series.count)
                key = "p99_%s_ms" % labels.get("op", "all")
                rollup[key] = round(
                    1e3 * series.quantile(0.99), 3)
                rollup["p50_%s_ms" % labels.get("op", "all")] = round(
                    1e3 * series.quantile(0.50), 3)
        uptime = (0.0 if self._started_t is None
                  else max(1e-9, self._clock() - self._started_t))
        rollup["uptime_s"] = round(uptime, 3)
        rollup["requests_total"] = total_reqs
        rollup["qps_lifetime"] = round(total_reqs / uptime, 3)
        return {"fleet": {"mode": self.mode,
                          "shard_count": self.shard_count,
                          "workers": digests, "rollup": rollup,
                          "stats": self.fleet_stats()},
                "metrics": reg.snapshot(),
                "flight": flight.flight_snapshot()}

    @staticmethod
    def _digest(metrics_snap: dict) -> dict:
        def _sum(name: str, key: str = "value") -> float:
            fam = metrics_snap.get(name) or {}
            return sum(float(s.get(key, 0) or 0)
                       for s in fam.get("series", []))

        def _max(name: str, key: str) -> float:
            fam = metrics_snap.get(name) or {}
            vals = [float(s.get(key, 0) or 0)
                    for s in fam.get("series", [])]
            return max(vals) if vals else 0.0

        return {
            "requests_total": int(_sum(
                "raft_tpu_serve_requests_total")),
            "rejected_total": int(_sum(
                "raft_tpu_serve_rejected_total")),
            "unavailable_total": int(_sum(
                "raft_tpu_serve_unavailable_total")),
            "exec_p50_ms": round(1e3 * _max(
                "raft_tpu_serve_exec_seconds", "p50"), 3),
            "exec_p95_ms": round(1e3 * _max(
                "raft_tpu_serve_exec_seconds", "p95"), 3),
            "slo_burn": _max("raft_tpu_serve_slo_burn_rate", "value"),
        }

    # ------------------------------------------------------------------ #
    # HTTP plumbing (the ops-plane handler discipline)
    # ------------------------------------------------------------------ #
    def _handle(self, handler, method: str) -> None:
        path = handler.path.split("?", 1)[0]
        endpoint = path if path in (
            "/register", "/heartbeat", "/search", "/insert",
            "/fleet/healthz", "/fleet/metrics", "/fleet/statusz",
            "/healthz", "/metrics", "/debug/snapshot") else "unknown"
        if path.startswith("/fleet/debug/trace/"):
            endpoint = "/fleet/debug/trace"
        try:
            body = {}
            if method == "POST":
                length = int(handler.headers.get("Content-Length", 0))
                raw = handler.rfile.read(length) if length else b"{}"
                body = json.loads(raw.decode("utf-8"))
            status, payload = self._route(method, path, body)
        except Exception as e:  # noqa: BLE001 — typed on the wire
            status, payload = protocol.error_response(e)
        _counter("raft_tpu_fleet_http_requests_total",
                 "router HTTP requests by endpoint and status",
                 endpoint=endpoint, code=str(status)).inc()
        if isinstance(payload, str):
            data = payload.encode("utf-8")
            ctype = "text/plain; version=0.0.4"
        else:
            data = json.dumps(payload).encode("utf-8")
            ctype = "application/json"
        try:
            handler.send_response(status)
            handler.send_header("Content-Type", ctype)
            handler.send_header("Content-Length", str(len(data)))
            handler.end_headers()
            handler.wfile.write(data)
        except (BrokenPipeError, ConnectionError, OSError):
            pass  # scraper gone; nothing to relay

    def _route(self, method: str, path: str, body: dict):
        if method == "POST":
            if path == "/register":
                return self._on_register(body)
            if path == "/heartbeat":
                return self._on_heartbeat(body)
            if path == "/search":
                return 200, self.search(
                    body.get("vectors"),
                    tenant=body.get("tenant"),
                    timeout_s=body.get("timeout_s"),
                    request_id=body.get("request_id"))
            if path == "/insert":
                return 200, self.insert(
                    body.get("ids"), body.get("vectors"),
                    timeout_s=body.get("timeout_s"),
                    request_id=body.get("request_id"))
        elif method == "GET":
            if path in ("/fleet/healthz", "/healthz"):
                ok, payload = self.fleet_health()
                return (200 if ok else 503), payload
            if path in ("/fleet/metrics", "/metrics"):
                return 200, self.fleet_metrics_text()
            if path == "/fleet/statusz":
                return 200, {
                    "mode": self.mode,
                    "shard_count": self.shard_count,
                    "workers": self.registry(),
                    "stats": self.fleet_stats(),
                    "sentinel": (None if self.sentinel is None
                                 else self.sentinel.status())}
            if path == "/debug/snapshot":
                return 200, self.fleet_snapshot()
            if path.startswith("/fleet/debug/trace/"):
                fid = urllib.parse.unquote(
                    path[len("/fleet/debug/trace/"):])
                return self.fleet_trace(fid)
        return 404, {"error": "NotFound", "message": path}
