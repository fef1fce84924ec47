"""Reduction of a ``torch.profiler`` trace (its Chrome trace JSON) to the
quantities the per-layer metrics read.

- device operations: kernels, copies and fills on the card, each with its
  launch's correlation id;
- host events: operators, ``record_function`` ranges and CUDA runtime
  calls, with their thread;
- the window: the ``portbench.window`` range the harness records around
  the measured window.

Times are in seconds on the trace's clock, which the host and device
events share.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:

    def __init__(self, events: Iterable[dict]):
        self.device: List[Tuple[str, str, float, float, Optional[int]]] = []
        self.host: List[Tuple[str, str, float, float, object]] = []
        self.launch: Dict[int, Tuple[float, object]] = {}
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev["ts"]) * 1e-6, float(ev.get("dur", 0.0)) * 1e-6
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append((cat, ev["name"], ts, dur, args.get("correlation")))
            elif cat in HOST_CATS:
                self.host.append((cat, ev["name"], ts, dur, ev.get("tid")))
                if cat in LAUNCH_CATS and "correlation" in args:
                    self.launch[args["correlation"]] = (ts, ev.get("tid"))
        self.device.sort(key=lambda e: e[2])
        spans = [(ts, ts + dur) for cat, name, ts, dur, _ in self.host
                 if cat == "user_annotation" and name == WINDOW]
        self.window = (min(s for s, _ in spans), max(e for _, e in spans)) if spans else None

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return 0.0 if self.window is None else self.window[1] - self.window[0]

    def kernels(self, pattern: str = "", cats=("kernel",)
                ) -> List[Tuple[str, float, float, Optional[int]]]:
        """Device operations of the categories ``cats`` in the window whose
        name matches ``pattern`` (a regular expression searched in the
        name): ``(name, start, dur, corr)``."""
        rx = re.compile(pattern)
        lo, hi = self.window or (float("-inf"), float("inf"))
        return [(name, ts, dur, corr) for cat, name, ts, dur, corr in self.device
                if cat in cats and lo <= ts < hi and rx.search(name)]

    def idle_pct(self) -> Optional[float]:
        """The share of the window in which no operation ran on the
        device, or None without a window or a device operation."""
        busy = self.busy_s()
        if self.window_s <= 0.0 or busy <= 0.0:
            return None
        return 100.0 * (1.0 - busy / self.window_s)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device operations' intervals, clipped to the window."""
        lo, hi = self.window or (float("-inf"), float("inf"))
        merged: List[List[float]] = []
        for _, _, ts, dur, _ in self.device:
            s, e = max(ts, lo), min(ts + dur, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def under_range(self, name: str, kernels) -> list:
        """The kernels of ``kernels`` whose launch lies inside a
        ``record_function`` range called ``name``, on the same thread."""
        ranges = defaultdict(list)
        for cat, n, ts, dur, tid in self.host:
            if cat == "user_annotation" and n == name:
                ranges[tid].append((ts, ts + dur))
        for spans in ranges.values():
            spans.sort()
        out = []
        for k in kernels:
            launch = self.launch.get(k[3])
            if launch is None:
                continue
            ts, tid = launch
            spans = ranges.get(tid, ())
            i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                out.append(k)
        return out

    def top_device_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations (by name, templates kept, arguments
        dropped) that took most time in the window: ``[name, seconds]``."""
        lo, hi = self.window or (float("-inf"), float("inf"))
        total: Dict[str, float] = defaultdict(float)
        for _, name, ts, dur, _ in self.device:
            if lo <= ts < hi:
                total[short_name(name)] += dur
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time in the window, by what the host was
        doing at the middle of each gap (the shortest host event that
        covers it, on any thread), summed: ``[what, seconds]``, longest
        first."""
        if self.window is None:
            return []
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy_intervals():
            edges.extend((s, e))
        edges.append(hi)
        host = sorted(((ts, ts + dur, name) for cat, name, ts, dur, _ in self.host
                       if name != WINDOW), key=lambda h: h[0])
        starts = [h[0] for h in host]
        total: Dict[str, float] = defaultdict(float)
        for i in range(0, len(edges), 2):
            s, e = edges[i], edges[i + 1]
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            j = bisect.bisect_right(starts, mid)
            best = None
            for h in host[max(0, j - 2000):j]:
                if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                    best = h
            total["host: " + short_name(best[2]) if best else "host: no traced op"] += e - s
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def short_name(name: str) -> str:
    """A kernel's or operator's name without its argument list."""
    name = name.replace("(anonymous namespace)", "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i].strip()
    return name.strip()


# K1, K3 and K4 are instances of one template, knn_tile_kernel<N, NR, kMode,
# kBF16> (raft_tpu_torch/ops/csrc/knn_tile.cuh); its third argument is the
# mode: 0 K1 (index splits), 1 K6, 2 K3 (IVF work items), 3 K4.  The
# demangled and the mangled spellings are both matched.
TILE_KERNEL = (r"knn_tile_kernel(?:<\s*\d+,\s*\d+,\s*(?:\(\w+::\w+\))?{mode}\s*,"
               r"|ILi\d+ELi\d+ELi{mode}E)")
# K2, raft_tpu_torch/ops/csrc/select_tile.cu
SELECT_KERNEL = r"\b(?:select_rows|wide_bound|wide_filter|wide_select)\b"


def tile_kernel(mode: int) -> str:
    return TILE_KERNEL.format(mode=mode)
