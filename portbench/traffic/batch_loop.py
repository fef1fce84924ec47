"""Closed loop of back-to-back batches.

The traffic file gives ``batch`` (queries a call), ``pool_batches`` (how
many distinct batches are made from the seed and cycled through the
window, so that the reference's cost is bounded by the pool),
``in_flight`` (how many calls the host may have dispatched ahead of the
card) and ``sample_batches`` (how many answers besides the last of each
pool batch are kept for the check, taken at seeded points of the window).

The host dispatches calls without waiting for them; before dispatching
one it waits only for the call ``in_flight`` places back, so the card
always has work queued.  The window runs until the host clock passes its
length; the card is then synchronized and the window's wall time taken.
``queries_per_s`` is every query dispatched in the window over that time.
The notes give the longest the host waited on the card before a
dispatch, and the longest one dispatch took, to tell a stall of the card
from one of the host.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from portbench.frozen import datagen


def prepare(ctx) -> dict:
    t = ctx.traffic
    pool = [datagen.make_queries(int(t["batch"]), ctx.centers, ctx.config["data"],
                                 ctx.seeds["queries"] + i)
            for i in range(int(t["pool_batches"]))]
    for q in pool:                      # the cell's one shape, warmed
        ctx.system.call(q, ctx.k)
    ctx.sync()
    return {"ctx": ctx, "pool": pool}


def window(state: dict, seconds: float) -> dict:
    ctx, pool = state["ctx"], state["pool"]
    rng = np.random.default_rng(ctx.seeds["sample"])
    marks = sorted(rng.uniform(0.0, seconds, int(ctx.traffic["sample_batches"])).tolist())
    depth = int(ctx.traffic["in_flight"])
    cuda = ctx.device.type == "cuda"
    inflight = collections.deque()
    last, kept = {}, []
    calls = [0] * len(pool)
    keep_next = False
    i = 0
    longest_wait = longest_dispatch = 0.0
    t0 = time.monotonic()
    while True:
        now = time.monotonic() - t0
        if now >= seconds:
            break
        while marks and now >= marks[0]:
            marks.pop(0)
            keep_next = True
        slot = i % len(pool)
        t_wait = time.monotonic()
        if cuda and len(inflight) >= depth:
            inflight.popleft().synchronize()
        t_call = time.monotonic()
        d, ids = ctx.system.call(pool[slot], ctx.k)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
        t_done = time.monotonic()
        longest_wait = max(longest_wait, t_call - t_wait)
        longest_dispatch = max(longest_dispatch, t_done - t_call)
        last[slot] = (d, ids)
        if keep_next:
            kept.append((slot, d, ids))
            keep_next = False
        calls[slot] += 1
        i += 1
    ctx.sync()
    wall = time.monotonic() - t0
    checks = [{"key": slot, "q": pool[slot], "rows": None, "d": d, "i": ids}
              for slot, (d, ids) in sorted(last.items())]
    checks += [{"key": slot, "q": pool[slot], "rows": None, "d": d, "i": ids}
               for slot, d, ids in kept]
    return {"e2e": {"queries_per_s": i * pool[0].shape[0] / wall},
            "attempted": i, "failed": 0, "missing": 0, "checks": checks,
            "work": {"pool": pool, "calls": calls},
            "notes": {"calls": i, "window_s": wall, "longest_wait_s": longest_wait,
                      "longest_dispatch_s": longest_dispatch}}


def close(state: dict) -> None:
    state.clear()
