"""The fused tile kernel's phase counters, read after a traced window.

``raft_tpu_torch.core.tracing.kernel_phases()`` makes the program launch
the phase-timed instance of ``knn_tile_kernel`` (K1 is mode 0, K3 mode
2), which counts ``%clock64`` cycles by role and phase inside the kernel.
The ``k1.mma_*_pct`` and ``k3.mma_*_pct`` readers share one measurement a
run, kept on the reader context: after the window (whose kernels, and so
``k1_roofline`` and ``k3_roofline``, are the default instance's), each
pool batch is called once inside the collector, which builds and warms
the timed library, then once more inside a second collector, whose
counts are the ones read.

A reader returns None where its kernel did not run in the window, and
where the program has no phase counters (it predates them).  Where the
kernel ran and the timed calls counted none of it, it raises.
"""

from __future__ import annotations

import time

from portbench.trace import tile_kernel

KERNELS = {0: "K1", 2: "K3"}
# the cost of timing (timed device time over untimed) up to which the
# shares are read as the default kernel's
COST_LIMIT = 1.03


def _measure(ctx):
    try:
        from raft_tpu_torch.core.tracing import kernel_phases
    except ImportError:
        return None
    pool = ctx.work["pool"]
    marks = [time.monotonic()]
    tables = []
    for _ in range(2):
        with kernel_phases() as table:
            for q in pool:
                ctx.system.call(q, ctx.k)
        tables.append(table)
        marks.append(time.monotonic())
    return {"table": tables[1], "first_round_s": marks[1] - marks[0],
            "second_round_s": marks[2] - marks[1], "calls": len(pool),
            "sms": _sms(pool[0])}


def _sms(t):
    import torch
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def measured(ctx):
    """The run's one measurement (made at the first reader's call)."""
    if not hasattr(ctx, "kernel_phases"):
        ctx.kernel_phases = _measure(ctx)
    return ctx.kernel_phases


def combine(entries):
    """One table of the instances' summed cycles: ``(cycles, shares)``."""
    cycles = {}
    for e in entries:
        for role, counts in e["cycles"].items():
            mine = cycles.setdefault(role, dict.fromkeys(counts, 0))
            for name, n in counts.items():
                mine[name] += n
    shares = {role: {name: 100.0 * n / c["total"] if c["total"] else 0.0
                     for name, n in c.items() if name != "total"}
              for role, c in cycles.items()}
    return cycles, shares


def read(ctx, mode: int, phase: str):
    """The share of the multiplying warpgroup's cycles that kernel
    ``mode`` spends in ``phase``, with the whole phase table and the
    cost of timing in its notes."""
    kernels = ctx.trace.kernels(tile_kernel(mode))
    if not kernels:
        return None
    got = measured(ctx)
    if got is None:
        return None
    entries = {name: e for name, e in got["table"].items() if e["kernel"] == KERNELS[mode]}
    if not entries:
        raise RuntimeError("%s ran in the window, but its timed calls counted nothing"
                           % KERNELS[mode])
    cycles, shares = combine(entries.values())
    launches = sum(e["calls"] for e in entries.values())
    blocks = sum(e["blocks"] for e in entries.values())
    timed_s = sum(e["seconds"] for e in entries.values())
    untimed_per_call = sum(k[2] for k in kernels) / sum(ctx.work["calls"])
    timed_per_call = timed_s / got["calls"]
    cost = timed_per_call / untimed_per_call
    return {"value": shares["mma"][phase], "instances": sorted(entries), "shares": shares,
            "shares_of": ("the timed instance: timing cost more than 3%" if cost > COST_LIMIT
                          else "the kernel: timing cost 3% or less"),
            "cycles": cycles, "launches": launches, "blocks_per_launch": blocks / launches,
            "sms": got["sms"], "timed_kernel_s": timed_s, "timed_calls": got["calls"],
            "timed_kernel_s_per_call": timed_per_call,
            "untimed_kernel_s_per_call": untimed_per_call,
            "cost_ratio": cost,
            "first_round_s": got["first_round_s"], "second_round_s": got["second_round_s"],
            "timed_build_s": got["first_round_s"] - got["second_round_s"]}
