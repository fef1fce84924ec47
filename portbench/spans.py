"""Device time under a program's ``record_function`` range, as a share of
the device's busy time in a traced window."""

from __future__ import annotations

from portbench.trace import DEVICE_CATS


def seconds(trace, name: str) -> float:
    """Device seconds of the operations (kernels, copies, fills) launched
    inside the range ``name``."""
    return sum(k[2] for k in trace.under_range(name, trace.kernels(cats=DEVICE_CATS)))


def busy_pct(trace, name: str):
    """:func:`seconds` over the busy time, in percent; None without a
    trace, or where nothing ran under the range."""
    if trace is None:
        return None
    busy, under = trace.busy_s(), seconds(trace, name)
    if busy <= 0.0 or under <= 0.0:
        return None
    return 100.0 * under / busy
