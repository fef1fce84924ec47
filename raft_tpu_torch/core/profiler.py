"""Scoped profiler: nested timed spans kept as a call tree.

Port of ``raft_tpu/core/profiler.py`` without its JAX-compiler hooks.
The tracing module (:mod:`raft_tpu_torch.core.tracing`) puts names on a
``torch.profiler`` trace and on NVTX; this module keeps the *numbers*
in-process:

- **Spans** (:meth:`Profiler.span`): nested wall-clock scopes kept as a
  call tree (nesting per thread, merged across threads by path) and,
  with a ``layer``, mirrored into a ``raft_tpu_<layer>_<name>_seconds``
  timer of :mod:`raft_tpu_torch.core.metrics`, so snapshots carry
  per-primitive latency histograms.  A span also opens a tracing range
  of its name, so profiler scopes and trace ranges share one name space.
- **profiled**: the decorator form: a function run inside a
  ``<layer>.<name>`` span.

A span measures **host wall time**.  PyTorch returns before the card
finishes the kernels a call enqueued, so a span around a CUDA call
measures the host side (argument checks, the launches) unless the code
inside it synchronises; the card keeps running after the span closes.
Callers that want device-complete numbers synchronise inside the span
(``torch.cuda.synchronize`` or ``handle.sync_stream()``).

``Handle(profiler=)`` carries a profiler (the process default unless
given), and :func:`~raft_tpu_torch.core.handle.takes_handle` opens each
primitive's span on it.  The JAX ``profiled_jit``, ``compile_cache_stats``
and ``last_jit_fn`` instrument ``jax.jit``'s compile cache; PyTorch runs
eagerly and compiles nothing per shape, so they have no counterpart (the
kernel libraries' builds are counted by :mod:`raft_tpu_torch.ops._build`).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, Optional, Tuple

from raft_tpu_torch.core import metrics as _metrics
from raft_tpu_torch.core import tracing

__all__ = ["Profiler", "default_profiler", "profiled"]


class _SpanNode:
    __slots__ = ("name", "count", "total_s", "children")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total_s = 0.0
        self.children: Dict[str, "_SpanNode"] = {}


class _SpanScope:
    """One span activation (each ``with`` gets its own scope object, so
    the same span name is re-entrant and thread-safe)."""

    def __init__(self, prof: "Profiler", name: str, timer):
        self._prof = prof
        self._name = name
        self._timer = timer
        self._ann = None

    def __enter__(self):
        self._prev_active = getattr(_tls_active, "prof", None)
        _tls_active.prof = self._prof
        self._prof._path_stack().append(self._name)
        self._ann = tracing.annotate(self._name)
        self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        self._ann.__exit__(exc_type, exc, tb)
        stack = self._prof._path_stack()
        path = tuple(stack)
        stack.pop()
        _tls_active.prof = self._prev_active
        self._prof._record(path, dt)
        if self._timer is not None:
            self._timer.observe(dt)


# the innermost profiler with an open span on this thread: a
# ``profiled`` function called with no handle in reach attributes its
# span to its caller's profiler, so a handle-scoped tree keeps its
# children
_tls_active = threading.local()


def _current_profiler() -> "Profiler":
    return getattr(_tls_active, "prof", None) or _default_profiler


class Profiler:
    """Aggregating span profiler.

    Nesting is tracked per thread (a watchdog thread's spans do not
    graft onto the main thread's open scope); the aggregate tree merges
    all threads by span path, so ``report()`` is one tree whoever timed
    what.
    """

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None):
        self._registry = registry
        self._lock = threading.Lock()
        self._root = _SpanNode("")
        self._tls = threading.local()
        # resolved span timers, invalidated by the registry's generation:
        # spans wrap every instrumented primitive, so the name check and
        # family lookup must not run per call
        self._timer_cache = {}

    @property
    def registry(self) -> _metrics.MetricsRegistry:
        return (self._registry if self._registry is not None
                else _metrics.default_registry())

    def _path_stack(self):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, path: Tuple[str, ...], dt: float) -> None:
        with self._lock:
            node = self._root
            for name in path:
                nxt = node.children.get(name)
                if nxt is None:
                    nxt = node.children[name] = _SpanNode(name)
                node = nxt
            node.count += 1
            node.total_s += dt

    def span(self, name: str, layer: Optional[str] = None):
        """Open a nested timed scope.  With ``layer``, the span also
        feeds a ``raft_tpu_<layer>_<name>_seconds`` registry timer (a
        leading ``"<layer>."`` on the span name is not repeated in the
        metric; remaining dots become underscores).  While metrics are
        disabled the span records nothing and is its tracing range
        alone."""
        if not _metrics.is_enabled():
            return tracing.annotate(name)
        timer = None
        if layer is not None:
            reg = self.registry
            gen = reg.generation
            cached = self._timer_cache.get((name, layer))
            if cached is not None and cached[0] == gen:
                timer = cached[1]
            else:
                mname = name[len(layer) + 1:] if name.startswith(layer + ".") else name
                timer = reg.timer(
                    _metrics.metric_name(layer, mname.replace(".", "_") + "_seconds"),
                    help="span '%s' duration (host wall time)" % name)
                self._timer_cache[(name, layer)] = (gen, timer)
        return _SpanScope(self, name, timer)

    def reset(self) -> None:
        with self._lock:
            self._root = _SpanNode("")

    def tree(self) -> Dict:
        """The span tree as plain dicts (for JSON artifacts)."""

        def conv(node: _SpanNode) -> Dict:
            out = {"count": node.count, "total_s": node.total_s}
            if node.children:
                out["children"] = {n: conv(c) for n, c in sorted(node.children.items())}
            return out

        with self._lock:
            return {n: conv(c) for n, c in sorted(self._root.children.items())}

    def report(self) -> str:
        """Human-readable span tree: count, total and mean per scope,
        children indented under their parent."""
        lines = ["profiler report (wall seconds, host side unless the span synchronises)"]

        def walk(node: _SpanNode, depth: int) -> None:
            mean = node.total_s / node.count if node.count else 0.0
            lines.append("%s%-*s  n=%-6d total=%.6fs  mean=%.6fs"
                         % ("  " * depth, max(1, 40 - 2 * depth), node.name, node.count,
                            node.total_s, mean))
            for _, child in sorted(node.children.items()):
                walk(child, depth + 1)

        with self._lock:
            top = sorted(self._root.children.items())
        if not top:
            lines.append("  (no spans recorded)")
        for _, child in top:
            walk(child, 1)
        return "\n".join(lines)


_default_profiler = Profiler()


def default_profiler() -> Profiler:
    """The process-wide profiler (it reports into the metrics default
    registry; what ``Handle.profiler`` is unless overridden)."""
    return _default_profiler


def profiled(layer: str, name: Optional[str] = None):
    """Decorator: run the function inside a ``<layer>.<name>`` span
    feeding ``raft_tpu_<layer>_<name>_seconds``.  The span name is the
    function's name unless given.  A ``handle=`` keyword carrying a
    scoped profiler routes the span there (as ``takes_handle`` does);
    otherwise the innermost open profiler of the thread, or the process
    default."""

    def deco(fn):
        span_name = "%s.%s" % (layer, name or fn.__name__)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            prof = getattr(kwargs.get("handle"), "profiler", None) or _current_profiler()
            with prof.span(span_name, layer=layer):
                return fn(*args, **kwargs)

        return wrapper

    return deco
