"""Cells cut to a size a CPU test run holds: the committed cells' files
with their sizes made small."""

from __future__ import annotations

import copy

from portbench import harness

SIZES = {"rows": 3000, "dim": 16, "nlist": 24, "nprobe": 4, "train_rows": None}
DATA = {"n_blobs": 8}
TRAFFIC = {"batch": 200}


def _small(s: dict) -> dict:
    for key, value in SIZES.items():
        if key in s["config"]:
            s["config"][key] = value
    s["config"]["data"].update(DATA)
    for key, value in TRAFFIC.items():
        if key in s["traffic"]:
            s["traffic"][key] = value
    return s


def spec(name: str) -> dict:
    """The committed cell ``name`` at a tiny size (its limits unchanged)."""
    return _small(copy.deepcopy(harness.cell_spec(name)))
