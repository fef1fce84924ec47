"""Embedded ops plane: a pull endpoint for scrapers and the sentinel's home.

Port of ``raft_tpu/serve/opsplane.py``: a stdlib ``http.server`` on a
daemon thread, bound to localhost by default, serving snapshots of
state that other threads already keep (the metrics registry, the flight
recorder, SLO burn, the kernel cost inventory, the services' stats).

Endpoints
---------
``GET /metrics``
    Prometheus text exposition (``MetricsRegistry.to_prometheus``).
``GET /healthz``
    Cheap liveness verdict (200 ok / 503 degraded): per-service worker,
    breaker, pause and corruption flags plus the anomaly sentinel's
    degraded flag; no self-test battery and no device work.
    ``?full=1`` (session-backed planes only) runs the session's
    ``health_check()`` (the self-tests and the per-rank probes of
    :class:`raft_tpu_torch.session.Comms`) behind a TTL cache
    (``ops_healthz_ttl_s``).
``GET /statusz``
    One JSON screen: per-service ``stats()``, the sentinel's status, the
    inventory summary, the flight recorder's occupancy and black boxes,
    and ``tuning_table``: :func:`raft_tpu_torch.config.tuning_table_info`,
    None when no tuning table is installed.
``GET /debug/traces?k=N``
    The slowest-K requests with their event timelines.
``GET /debug/config``
    ``config.describe(layers=True)``: every knob with the rung that
    answered (override, configure, env, table or default), and
    ``tuning_table`` as in ``/statusz``.
``GET /debug/inventory``
    The per-(kernel, shape) cost inventory
    (:mod:`raft_tpu_torch.core.inventory`).
``GET /debug/snapshot``
    The union: metrics, the kernel libraries' build and load counts
    (``kernel_builds``: :func:`raft_tpu_torch.ops._build.stats`, where
    the JAX package reports its compile cache; there is no compile
    cache here), flight and inventory.
``POST /debug/blackbox``
    Manual black-box dump (``?reason=...``); returns the dump header.

Every handler reads host-side Python state, so a scrape never launches a
kernel, never builds one, and never blocks the serve worker loop; the
one exception is ``/healthz?full=1``, which calls the session's
``health_check`` and caches its verdict.

The roofline join of ``/statusz``'s inventory (JAX: the cost model's
flops over the ``raft_tpu_jit_<fn>_seconds`` and
``raft_tpu_serve_device_seconds{fn=}`` timers) has no measured time to
divide by here: the port has no per-kernel device timer on the serving
path (``ROADMAP.md``'s performance list).  Its columns
``exec_mean_s``, ``achieved_gflops_upper``, ``device_mean_s`` and
``achieved_gflops_device`` read None: no number is written that was not
measured.

The sentinel (:mod:`raft_tpu_torch.serve.sentinel`) is constructed and
registered here by default: serve workers poke it on their maintenance
seam, and the plane runs a fallback ticker so an idle process still
notices.  ``/healthz`` reads degraded while any rule is breached.

Lifecycle: ``OpsPlane(session)`` / ``OpsPlane(services={...})``;
``Comms.serve_ops(port=...)`` constructs one and ``destroy()`` closes it.
``port=0`` binds an ephemeral port (``plane.port`` reads it back).
"""

from __future__ import annotations

import http.server
import itertools
import json
import threading
import time
import urllib.parse
from typing import Callable, Dict, Optional

from raft_tpu_torch import config
from raft_tpu_torch.core import flight
from raft_tpu_torch.core import inventory as _inventory
from raft_tpu_torch.core import metrics as _metrics
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _build
from raft_tpu_torch.serve import sentinel as _sentinel

__all__ = ["OpsPlane"]

_plane_seq = itertools.count()


def _counter(endpoint: str, code: int):
    return _metrics.default_registry().counter(
        "raft_tpu_ops_requests_total",
        help="ops-plane HTTP requests served, by endpoint and status",
        labels=("endpoint", "code")).labels(endpoint=endpoint,
                                            code=code)


def _timer(endpoint: str):
    return _metrics.default_registry().timer(
        "raft_tpu_ops_request_seconds",
        help="ops-plane HTTP handler latency",
        labels=("endpoint",)).labels(endpoint=endpoint)


class OpsPlane:
    """Module-doc embedded ops server.

    Parameters
    ----------
    session:
        Optional owning :class:`raft_tpu_torch.session.Comms`: supplies the
        live service registry and the ``?full=1`` health battery.
    services:
        Alternative static ``{name: service}`` map (standalone tools —
        loadgen, bench — have services but no session).
    host / port:
        Bind address; ``port=0`` picks an ephemeral port (read it back
        from :attr:`port`).  Localhost by default: the ops plane is an
        infrastructure surface, not an internet one.
    healthz_ttl_s:
        Full-battery cache lifetime (None = the ``ops_healthz_ttl_s``
        knob).
    sentinel:
        ``True`` (default) constructs + registers an
        :class:`~raft_tpu_torch.serve.sentinel.AnomalySentinel` over the
        plane's services; an instance uses that instance; ``False``
        disables (``/healthz`` then reports service flags only).
    sentinel_interval_s:
        Fallback ticker period (None = the ``ops_sentinel_interval_s``
        knob); the ticker is a daemon thread that only matters when no
        serve worker is poking the sentinel.
    start:
        Bind + serve now (False = call :meth:`start` later; tests).
    """

    def __init__(self, session=None, services: Optional[Dict] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 healthz_ttl_s: Optional[float] = None,
                 sentinel=True,
                 sentinel_interval_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True):
        expects(session is None or services is None,
                "OpsPlane: pass a session or a services map, not both")
        self._session = session
        self._static_services = dict(services or {})
        self._host = host
        self._want_port = int(port)
        self._ttl = (config.get_float("ops_healthz_ttl_s")
                     if healthz_ttl_s is None else float(healthz_ttl_s))
        self._clock = clock
        self._name = "ops%d" % next(_plane_seq)
        self._lock = threading.Lock()
        self._health_fetch_lock = threading.Lock()
        self._health_cache: Optional[dict] = None
        self._health_cache_t: Optional[float] = None
        self._started_t: Optional[float] = None
        self._bound_port: Optional[int] = None
        self._server = None
        self._server_thread = None
        self._ticker = None
        self._ticker_stop = threading.Event()
        self._closed = False
        if sentinel is True:
            self.sentinel = _sentinel.AnomalySentinel(
                self._services, interval_s=sentinel_interval_s,
                clock=clock)
        elif sentinel is False or sentinel is None:
            self.sentinel = None
        else:
            self.sentinel = sentinel
        if start:
            self.start()

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "OpsPlane":
        """Bind the socket and spawn the serving + ticker threads
        (idempotent while open; raises once closed).  The sentinel is
        registered for worker-seam pokes only AFTER the bind succeeds
        — a failed bind (port in use) must not leak a permanently
        registered zombie sentinel holding the session alive."""
        expects(not self._closed, "OpsPlane %s is closed", self._name)
        if self._server is not None:
            return self
        plane = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            # the plane's logging is its metrics; stderr noise per
            # scrape would be operationally hostile
            def log_message(self, *args):  # noqa: D102
                pass

            def do_GET(self):
                plane._handle(self, "GET")

            def do_POST(self):
                plane._handle(self, "POST")

        self._server = http.server.ThreadingHTTPServer(
            (self._host, self._want_port), _Handler)
        # remember the ACTUAL bound port (port=0 means the kernel
        # picked one): fleet workers bind ephemeral and report this
        # through the registration handshake, and it must survive
        # close() so a supervisor can still log where a dead worker
        # had been listening
        self._bound_port = int(self._server.server_address[1])
        self._server.daemon_threads = True
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="raft-tpu-%s" % self._name)
        self._server_thread.start()
        self._started_t = self._clock()
        if self.sentinel is not None:
            _sentinel.register(self.sentinel)
            self._ticker_stop.clear()
            self._ticker = threading.Thread(
                target=self._tick_loop, daemon=True,
                name="raft-tpu-%s-sentinel" % self._name)
            self._ticker.start()
        return self

    @property
    def port(self) -> Optional[int]:
        """Actual bound port (None until first :meth:`start`).  With
        ``port=0`` this is the kernel-assigned ephemeral port; it
        stays readable after :meth:`close` (the registration
        handshake and post-mortem logs need it)."""
        return self._bound_port

    @property
    def url(self) -> Optional[str]:
        p = self.port
        return None if p is None else "http://%s:%d" % (self._host, p)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def close(self) -> None:
        """Stop serving and the ticker; idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._ticker_stop.set()
        if self.sentinel is not None:
            _sentinel.unregister(self.sentinel)
        srv, self._server = self._server, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        t = self._server_thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        t = self._ticker
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def __enter__(self) -> "OpsPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _tick_loop(self) -> None:
        interval = (self.sentinel._interval
                    if self.sentinel is not None else 1.0)
        while not self._ticker_stop.wait(timeout=max(0.05, interval)):
            _sentinel.poke()

    # ------------------------------------------------------------------ #
    # plumbing
    # ------------------------------------------------------------------ #
    def _services(self) -> Dict[str, object]:
        if self._session is not None:
            try:
                return dict(self._session.services)
            except Exception:  # serve-exc-ok: a torn-down session scrapes as empty
                return {}
        return dict(self._static_services)

    def _handle(self, req, method: str) -> None:
        parsed = urllib.parse.urlparse(req.path)
        qs = urllib.parse.parse_qs(parsed.query)
        endpoint = parsed.path.rstrip("/") or "/"
        routes = {
            ("GET", "/"): self._ep_index,
            ("GET", "/metrics"): self._ep_metrics,
            ("GET", "/healthz"): self._ep_healthz,
            ("GET", "/statusz"): self._ep_statusz,
            ("GET", "/debug/traces"): self._ep_traces,
            ("GET", "/debug/config"): self._ep_config,
            ("GET", "/debug/inventory"): self._ep_inventory,
            ("GET", "/debug/snapshot"): self._ep_snapshot,
            ("POST", "/debug/blackbox"): self._ep_blackbox,
        }
        fn = routes.get((method, endpoint))
        t0 = self._clock()
        if fn is None:
            known = endpoint in {p for _, p in routes}
            code, body, ctype = (405 if known else 404), json.dumps(
                {"error": "method not allowed" if known
                 else "unknown endpoint",
                 "endpoints": sorted({p for _, p in routes})}), \
                "application/json"
            if not known:
                # the metric label set must stay BOUNDED: a client
                # probing arbitrary paths (port scanner, favicon
                # fetches) must not mint one registry series per path
                endpoint = "unknown"
        else:
            try:
                code, body, ctype = fn(qs)
            except Exception as e:  # serve-exc-ok: relayed as the 500 body + status counter
                code, body, ctype = 500, json.dumps(
                    {"error": "%s: %s" % (type(e).__name__, e)}), \
                    "application/json"
        payload = body.encode("utf-8")
        try:
            req.send_response(code)
            req.send_header("Content-Type",
                            ctype + "; charset=utf-8")
            req.send_header("Content-Length", str(len(payload)))
            req.end_headers()
            if method != "HEAD":
                req.wfile.write(payload)
        except (BrokenPipeError, ConnectionError):
            pass  # scraper hung up mid-write; nothing to salvage
        _counter(endpoint, code).inc()
        _timer(endpoint).observe(max(0.0, self._clock() - t0))

    @staticmethod
    def _json(obj, code: int = 200):
        return code, json.dumps(obj, indent=1, sort_keys=True,
                                default=str), "application/json"

    # ------------------------------------------------------------------ #
    # endpoints
    # ------------------------------------------------------------------ #
    def _ep_index(self, qs):
        return self._json({
            "service": "raft_tpu_torch ops plane",
            "endpoints": ["/metrics", "/healthz", "/statusz",
                          "/debug/traces", "/debug/config",
                          "/debug/inventory", "/debug/snapshot",
                          "/debug/blackbox (POST)"],
        })

    def _ep_metrics(self, qs):
        return (200, _metrics.default_registry().to_prometheus(),
                "text/plain; version=0.0.4")

    def _cheap_service_health(self) -> Dict[str, dict]:
        """Per-service liveness flags from direct state reads — no
        ``stats()`` (which snapshots SLO trackers), no battery, no
        device work.  The same conditions session ``health_check`` fails on,
        minus the mesh/selftest half that needs devices."""
        out = {}
        for name, svc in self._services().items():
            flags = {"open": bool(getattr(svc, "is_open",
                                          lambda: True)())}
            worker = getattr(svc, "worker", None)
            if worker is not None:
                flags["worker_alive"] = (not worker.dead()
                                         if worker.started() else None)
            batcher = getattr(svc, "batcher", None)
            if batcher is not None:
                flags["paused"] = bool(batcher.paused())
                flags["queue_depth"] = int(batcher.depth())
            breaker = getattr(svc, "breaker", None)
            if breaker is not None:
                flags["breaker"] = breaker.state.name.lower()
            persist = getattr(svc, "_persist", None)
            if persist is not None:
                flags["corruption_detected"] = bool(
                    persist.corruption_detected)
            maint = getattr(worker, "last_maintenance_error", None)
            if maint:
                flags["last_maintenance_error"] = maint
            out[name] = flags
        return out

    @staticmethod
    def _service_flags_ok(flags: dict) -> bool:
        if not flags.get("open", True):
            return True   # an intentionally closed service passes
        if flags.get("worker_alive") is False:
            return False
        if flags.get("breaker") == "open":
            return False
        if flags.get("corruption_detected"):
            return False
        return True

    def _ep_healthz(self, qs):
        full = qs.get("full", ["0"])[0] not in ("", "0")
        degraded = (self.sentinel.degraded()
                    if self.sentinel is not None else False)
        out = {
            "degraded": degraded,
            "anomalies": (self.sentinel.active()
                          if self.sentinel is not None else []),
        }
        services = self._cheap_service_health()
        ok = all(self._service_flags_ok(f) for f in services.values())
        out["services"] = services
        if full and self._session is not None:
            report, age = self._full_health()
            out["full"] = report
            out["full_age_s"] = round(age, 3)
            ok = ok and bool(report.get("ok"))
        out["ok"] = ok and not degraded
        return self._json(out, 200 if out["ok"] else 503)

    def _full_health(self):
        """The session battery behind the TTL cache: scrapes within
        ``ops_healthz_ttl_s`` of each other share one run (the battery
        runs the self-tests and a probe a rank on the devices — it must
        never run per request).
        Concurrent cold-cache scrapers serialize on the fetch lock
        and all but the first re-read the cache — N simultaneous
        ``?full=1`` requests run ONE battery, not N."""

        def cached(now):
            if (self._health_cache is not None
                    and now - self._health_cache_t <= self._ttl):
                return self._health_cache, now - self._health_cache_t
            return None

        with self._lock:
            hit = cached(self._clock())
        if hit is not None:
            return hit
        with self._health_fetch_lock:
            with self._lock:
                hit = cached(self._clock())
            if hit is not None:
                return hit
            report = self._session.health_check()
            with self._lock:
                self._health_cache = report
                self._health_cache_t = self._clock()
        return report, 0.0

    def _ep_statusz(self, qs):
        services = {}
        for name, svc in self._services().items():
            try:
                services[name] = svc.stats()
            except Exception as e:  # serve-exc-ok: relayed in the response body
                services[name] = {"error": "%s: %s"
                                  % (type(e).__name__, e)}
        out = {
            "uptime_s": (None if self._started_t is None else
                         round(self._clock() - self._started_t, 3)),
            "services": services,
            "sentinel": (self.sentinel.status()
                         if self.sentinel is not None else None),
            "inventory": self._inventory_with_roofline(),
            "flight": flight.flight_snapshot(),
            "tuning_table": config.tuning_table_info(),
        }
        return self._json(out)

    @staticmethod
    def _inventory_with_roofline() -> dict:
        """The inventory summary with the JAX plane's roofline columns,
        each None: there is no measured per-kernel time to divide the
        analytic flops by (module doc)."""
        inv = _inventory.summary()
        for st in inv["per_fn"].values():
            st.update(exec_mean_s=None, achieved_gflops_upper=None, device_mean_s=None,
                      achieved_gflops_device=None)
        return inv

    def _ep_traces(self, qs):
        try:
            k = int(qs.get("k", ["5"])[0])
        except ValueError:
            return self._json({"error": "k must be an integer"}, 400)
        k = max(1, min(64, k))
        # slowest-K across THIS plane's services' exemplar reservoirs
        # (the module registry is process-global; a plane reports its
        # own world), each joined back to its ring events (a resolved
        # request's Trace object lives on its future; the ring names
        # riders per event, so the waterfall is reconstructable
        # server-side)
        mine = set(self._services())
        worst = []
        for svc, exemplars in flight.exemplars_snapshot().items():
            if mine and svc not in mine:
                continue
            for e in exemplars:
                worst.append((e["latency_ms"], svc, e["trace_id"]))
        worst.sort(reverse=True)
        events = flight.default_recorder().events()
        out = []
        for latency_ms, svc, tid in worst[:k]:
            timeline = [ev.to_dict() for ev in events
                        if ev.trace_id == tid
                        or (ev.attrs
                            and tid in ev.attrs.get("traces", ()))]
            out.append({"trace_id": tid, "service": svc,
                        "latency_ms": latency_ms,
                        "events": timeline,
                        "ring_truncated": not timeline})
        return self._json({"k": k, "traces": out})

    def _ep_config(self, qs):
        return self._json({
            "knobs": config.describe(layers=True),
            "tuning_table": config.tuning_table_info(),
        })

    def _ep_inventory(self, qs):
        return self._json({"summary": _inventory.summary(),
                           "detail": _inventory.snapshot()})

    def _ep_snapshot(self, qs):
        inv = _inventory.summary()
        inv["detail"] = _inventory.snapshot()
        return self._json({
            "metrics": _metrics.default_registry().snapshot(),
            "kernel_builds": _build.stats(),
            "flight": flight.flight_snapshot(),
            "inventory": inv,
        })

    def _ep_blackbox(self, qs):
        reason = qs.get("reason", ["manual"])[0] or "manual"
        dump = flight.default_recorder().blackbox(
            "ops_%s" % reason)
        return self._json({"reason": dump["reason"], "at": dump["at"],
                           "n_events": len(dump["events"])})
