#!/usr/bin/env python3
"""The sweep of raft_tpu_torch's candidate registry: time, check, persist.

The port's arm of ``tools/autotune.py``.  The implementation choices are
the small discrete registry of :mod:`raft_tpu_torch.core.tuning`, so an
exhaustive timed sweep per (backend, op, shape class, dtype) cell settles
every knob with measurements.  For each cell the driver:

1. asks the registry for the candidates legal to sweep here
   (``purpose="sweep"``: a kernel on a CPU tensor, ``kernel_bf16`` and the
   ``cumsum`` SpMV are left out, with their reasons recorded);
2. holds each candidate's answer to the default's at the cell before any
   timing: bitwise where both select exactly (K2 and the stable sort both
   break ties to the smaller column; the merge topologies; the SpMV
   routes of one code), else distances within the cell's tolerance and
   id sets equal but for ties at the k-th distance.  A candidate that
   fails is recorded and never persisted;
3. times each candidate, best of N after a warm call, by CUDA events on
   the card (the host clock on the CPU), with the tuning table suspended,
   and records whether ``_build.stats()`` moved inside the timed loop (the
   port's "zero post-warmup compiles": a kernel library built or loaded
   there would be timed);
4. persists the winner to a versioned JSON table keyed by the backend
   fingerprint (:func:`raft_tpu_torch.core.tuning.backend_fingerprint`),
   which :func:`raft_tpu_torch.config.tuned` consults between the
   environment and the default.  Each entry carries the JAX table's
   fields, the parity outcome, and the card's name and power limit.

Conservatism: a winner other than the default is persisted only when it
beats the default by ``--min-margin`` (1.05x); below that the default is
kept, so the table cannot lose to noise.

The cells are the JAX catalogue's, by name, where the port has the knob
(``k100``, ``k10``, ``fused20k``, ``blkn20k``, ``ivf32k``, ``spmv200k``,
``mnmg16k``), a 1-NN cell for the registry-only
``fused_nn_impl`` (``nn20k``), K6 at two classes between ``blkn20k``
and the main path (``blkn100k``, ``blkn300k``: 100,000 and 300,000 x
128, k 100, 1024 queries), and the main path's class of each tuned
knob: ``select_1M`` (n 100,000, k 100, 1024 rows), ``bfknn_1M`` (1M x
128, k 100, 1024 queries: ``BASELINE.md`` config #3), ``twophase_1M``
(K6 at that shape), ``ivf_search_1M`` (the 1M mixture in 1024 lists,
nprobe 32, k 100) and ``kmeans_assign_1M`` (1M x 128 against 1024
centroids).  ``select_1M`` and ``k100`` share a shape class; the later
cell's entry answers it and the other is kept under ``superseded``.

Rollup: where every swept cell of a knob has the same winner, a ``"*"``
entry carries it to the classes nobody swept; where the winners
disagree, no ``"*"`` entry is written and those classes take the
default, since no measurement says which winner holds between the
swept points.

The tool measures the card: with no ``--device`` it asks for CUDA and
exits with a message where there is none.  ``--device cpu`` runs the
plain routes on the CPU, a rehearsal of the tool (the kernels are not
swept there).

Usage
-----
  python3 tools/torch_autotune.py                  # full sweep on the card
  python3 tools/torch_autotune.py --smoke          # one small cell per knob
  python3 tools/torch_autotune.py --smoke --device cpu --out /tmp/t.json
  python3 tools/torch_autotune.py --op select_k    # filter by op or knob
  python3 tools/torch_autotune.py --cell 1M        # filter by cell-name substring
  python3 tools/torch_autotune.py --dry-run        # plan only, no timing
  python3 tools/torch_autotune.py --ab             # also re-time tuned vs default

The table goes to ``raft_tpu_torch/tuning/<fingerprint_slug>.json`` unless
``--out`` names a file; ``RAFT_TPU_TUNING_TABLE=auto`` loads it on a card
with the same fingerprint.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

ITERS_FULL = 5
ITERS_SMOKE = 2
MIN_MARGIN = 1.05
MNMG_WORLD = 8          # rank slots of the merge cells, on one device
# the route an unset knob takes where its kernel is illegal, and the knobs
# whose unset dispatch takes the kernel only on CUDA
_PLAIN = {"select_impl": "sort", "fused_knn_impl": "scan", "ivf_scan_impl": "scan",
          "fused_nn_impl": "scan"}
_CUDA_AUTO = ("fused_knn_impl", "ivf_scan_impl", "fused_nn_impl")
# how a candidate's answer is held to the default's
_EXACT = ("select_impl", "spmv_impl", "mnmg_merge")


# --------------------------------------------------------------------- #
# the cell catalogue: (op, knob, cell, dims, extra).  dims use the names
# of the registry spec's class dims; extra holds workload-only sizes
# --------------------------------------------------------------------- #
def catalog(smoke: bool):
    if smoke:
        return [
            ("select_k", "select_impl", "k16_smoke", {"n": 4096, "k": 16}, {"nq": 32}),
            ("fused_l2_knn", "fused_knn_impl", "fused2k_smoke", {"n": 2048, "k": 8},
             {"nq": 32, "d": 16}),
            ("fused_knn_twophase", "knn_block_n", "blkn2k_smoke",
             {"n": 2048, "k": 8, "d": 16}, {"nq": 32}),
            ("ivf_flat_search", "ivf_scan_impl", "ivf1k_smoke", {"n": 1024, "k": 8, "d": 16},
             {"nlist": 8, "nprobe": 4, "nq": 16}),
            ("csr_spmv", "spmv_impl", "spmv4k_smoke", {"rows": 4096, "nnz": 32768}, {}),
            ("mnmg_knn", "mnmg_merge", "mnmg1k_smoke", {"n": 1024, "k": 8},
             {"nq": 16, "d": 16}),
            ("fused_l2_nn", "fused_nn_impl", "nn2k_smoke", {"n": 64, "k": 1},
             {"nq": 2048, "d": 16}),
        ]
    return [
        ("select_k", "select_impl", "k100", {"n": 131072, "k": 100}, {"nq": 256}),
        ("select_k", "select_impl", "k10", {"n": 131072, "k": 10}, {"nq": 256}),
        ("select_k", "select_impl", "select_1M", {"n": 100000, "k": 100}, {"nq": 1024}),
        ("fused_l2_knn", "fused_knn_impl", "fused20k", {"n": 20000, "k": 32},
         {"nq": 128, "d": 64}),
        ("fused_l2_knn", "fused_knn_impl", "bfknn_1M", {"n": 1000000, "k": 100},
         {"nq": 1024, "d": 128}),
        ("fused_knn_twophase", "knn_block_n", "blkn20k", {"n": 20000, "k": 32, "d": 64},
         {"nq": 128}),
        ("fused_knn_twophase", "knn_block_n", "blkn100k",
         {"n": 100000, "k": 100, "d": 128}, {"nq": 1024}),
        ("fused_knn_twophase", "knn_block_n", "blkn300k",
         {"n": 300000, "k": 100, "d": 128}, {"nq": 1024}),
        ("fused_knn_twophase", "knn_block_n", "twophase_1M",
         {"n": 1000000, "k": 100, "d": 128}, {"nq": 1024}),
        ("ivf_flat_search", "ivf_scan_impl", "ivf32k", {"n": 32768, "k": 10, "d": 64},
         {"nlist": 64, "nprobe": 8, "nq": 128}),
        ("ivf_flat_search", "ivf_scan_impl", "ivf_search_1M",
         {"n": 1000000, "k": 100, "d": 128},
         {"nlist": 1024, "nprobe": 32, "nq": 1024, "train_rows": 131072, "blobs": 256}),
        ("csr_spmv", "spmv_impl", "spmv200k", {"rows": 200000, "nnz": 2000000}, {}),
        ("mnmg_knn", "mnmg_merge", "mnmg16k", {"n": 16384, "k": 100}, {"nq": 512, "d": 32}),
        ("fused_l2_nn", "fused_nn_impl", "nn20k", {"n": 20000, "k": 1}, {"nq": 128, "d": 64}),
        ("fused_l2_nn", "fused_nn_impl", "kmeans_assign_1M", {"n": 1024, "k": 1},
         {"nq": 1000000, "d": 128}),
    ]


# --------------------------------------------------------------------- #
# cells: data made once, make(candidate) -> a zero-argument step whose
# output is the answer held to the default's
# --------------------------------------------------------------------- #
class Cell:
    """One cell's workload: ``make(cand)``, the class ``dims`` its consumer
    keys on, the distance tolerance, and the data for 1-NN tie checks."""

    def __init__(self, make, dims, atol=0.0, nn_data=None):
        self.make, self.dims, self.atol, self.nn_data = make, dims, atol, nn_data


def _rand(shape, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=dev)


def _l2_atol(a, b):
    """Tolerance of expanded-form squared L2 in float32: the rounding of
    |a|^2 + |b|^2 at the largest norms (``chip_smoke.py``'s)."""
    return 2e-6 * ((a * a).sum(-1).max() + (b * b).sum(-1).max()).item()


def _build_select_k(dims, extra, dev):
    from raft_tpu_torch.spatial.select_k import select_k

    keys = _rand((extra["nq"], dims["n"]), dev, 0)
    return Cell(lambda cand: lambda: select_k(keys, dims["k"], impl=cand, device=dev), dims)


def _build_fused_l2_knn(dims, extra, dev):
    from raft_tpu_torch.spatial.fused_l2_knn import fused_l2_knn

    x = _rand((dims["n"], extra["d"]), dev, 0)
    q = _rand((extra["nq"], extra["d"]), dev, 1)
    return Cell(lambda cand: lambda: fused_l2_knn(x, q, dims["k"], impl=cand, device=dev),
                dims, _l2_atol(q, x))


def _build_twophase(dims, extra, dev):
    from raft_tpu_torch.ops.knn_tile import fused_knn_twophase

    x = _rand((dims["n"], dims["d"]), dev, 0)
    q = _rand((extra["nq"], dims["d"]), dev, 1)
    return Cell(lambda cand: lambda: fused_knn_twophase(x, q, dims["k"], block_n=int(cand)),
                dims, _l2_atol(q, x))


def _build_ivf_flat_search(dims, extra, dev):
    from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat_build, ivf_flat_search

    d = dims["d"]
    if "blobs" in extra:
        # the main path's Gaussian mixture (chip_smoke.py: 256 blobs, spread 0.35)
        gen = torch.Generator(device=dev).manual_seed(0)
        centers = torch.randn(extra["blobs"], d, device=dev, generator=gen) * 4.0
        blob = torch.randint(0, extra["blobs"], (dims["n"] + extra["nq"],), device=dev,
                             generator=gen)
        mix = centers[blob] + torch.randn(blob.numel(), d, device=dev, generator=gen) * 0.35
        x, q = mix[:dims["n"]], mix[dims["n"]:]
    else:
        x, q = _rand((dims["n"], d), dev, 0), _rand((extra["nq"], d), dev, 1)
    index = ivf_flat_build(x, IVFFlatParams(nlist=extra["nlist"], nprobe=extra["nprobe"]),
                           train_rows=extra.get("train_rows"), device=dev)
    # the consumer's class: the slot store's rows, not the data's
    cls = dict(dims, n=int(index.slot_ids.numel()))
    return Cell(lambda cand: lambda: ivf_flat_search(index, q, dims["k"], scan_impl=cand,
                                                     device=dev), cls, _l2_atol(q, x))


def _build_csr_spmv(dims, extra, dev):
    from raft_tpu_torch.sparse.formats import CSR
    from raft_tpu_torch.sparse.linalg import csr_spmv

    rows = dims["rows"]
    per_row = max(1, dims["nnz"] // rows)
    rng = np.random.RandomState(0)
    indptr = np.arange(rows + 1, dtype=np.int32) * per_row
    indices = rng.randint(0, rows, size=rows * per_row).astype(np.int32)
    data = rng.random_sample(rows * per_row).astype(np.float32)
    csr = CSR(torch.from_numpy(indptr).to(dev), torch.from_numpy(indices).to(dev),
              torch.from_numpy(data).to(dev), (rows, rows), device=dev)
    x = torch.from_numpy(rng.random_sample(rows).astype(np.float32)).to(dev)
    return Cell(lambda cand: lambda: csr_spmv(csr, x, impl=cand, device=dev), dims)


def _build_mnmg_knn(dims, extra, dev):
    from raft_tpu_torch.comms.mesh import Mesh
    from raft_tpu_torch.spatial.mnmg_knn import mnmg_knn, shard_knn_index

    x = _rand((dims["n"], extra["d"]), dev, 0)
    q = _rand((extra["nq"], extra["d"]), dev, 1)
    mesh = Mesh([dev] * MNMG_WORLD, ("ranks",))
    sharded, n = shard_knn_index(x, mesh, "ranks")
    return Cell(lambda cand: lambda: mnmg_knn(sharded, q, dims["k"], merge=cand, n_rows=n,
                                              mesh=mesh, axis="ranks"),
                dict(dims, devices=MNMG_WORLD))


def _build_fused_l2_nn(dims, extra, dev):
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn

    x = _rand((extra["nq"], extra["d"]), dev, 0)
    y = _rand((dims["n"], extra["d"]), dev, 1)
    return Cell(lambda cand: lambda: fused_l2_nn(x, y, impl=cand, device=dev), dims,
                _l2_atol(x, y), nn_data=(x, y))


BUILDERS = {
    "select_k": _build_select_k,
    "fused_l2_knn": _build_fused_l2_knn,
    "fused_knn_twophase": _build_twophase,
    "ivf_flat_search": _build_ivf_flat_search,
    "csr_spmv": _build_csr_spmv,
    "mnmg_knn": _build_mnmg_knn,
    "fused_l2_nn": _build_fused_l2_nn,
}


# --------------------------------------------------------------------- #
# the answers held to the default's
# --------------------------------------------------------------------- #
def _knn_agree(got, ref, atol):
    """None when the two (distances, ids) agree: distances within ``atol``
    and each row's ids equal as a set but for ties at the k-th distance
    (within ``atol``); else why not."""
    gd, gi = (t.cpu() for t in got)
    rd, ri = (t.cpu() for t in ref)
    if gd.shape != rd.shape:
        return "shapes %s and %s" % (tuple(gd.shape), tuple(rd.shape))
    live = ri >= 0
    if not torch.equal(gi >= 0, live):
        return "deficit slots differ"
    err = (gd[live] - rd[live]).abs().max().item() if live.any() else 0.0
    if err > atol:
        return "distance error %g > %g" % (err, atol)
    for row in torch.nonzero((torch.sort(gi, 1).values != torch.sort(ri, 1).values)
                             .any(1)).flatten().tolist():
        kth = rd[row][live[row]][-1].item()
        extra = set(gi[row].tolist()) - set(ri[row].tolist())
        for col, idx in enumerate(gi[row].tolist()):
            if idx in extra and abs(gd[row, col].item() - kth) > atol:
                return "row %d: id %d is no tie at the k-th distance" % (row, idx)
    return None


def _nn_agree(got, ref, atol, x, y):
    err = (got[0] - ref[0]).abs().max().item()
    if err > atol:
        return "value error %g > %g" % (err, atol)
    bad = got[1] != ref[1]
    if bad.any():
        alt = ((x[bad] - y[got[1][bad].long()]) ** 2).sum(dim=1)
        if ((alt - ref[0][bad]).abs() > atol).any():
            return "an id is no tie at the minimum"
    return None


def parity(knob, cell, got, ref):
    """``("exact" | "tolerance", None)`` when ``got`` agrees with the
    default's ``ref`` by the knob's rule, else ``(rule, why)``."""
    if knob in _EXACT:
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        same = all(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, ref))
        return "exact", None if same else "answers differ bit for bit"
    if cell.nn_data is not None:
        return "tolerance", _nn_agree(got, ref, cell.atol, *cell.nn_data)
    return "tolerance", _knn_agree(got, ref, cell.atol)


# --------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------- #
def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(step, dev):
    """Seconds of one call: CUDA events on the card, the host clock on
    the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    step()
    return time.perf_counter() - t0


def _moved(before, after):
    return sum(after[k] - before[k] for k in before)


def time_candidate(step, *, iters, dev):
    """``(best_seconds, build_moves)``: a warm call, then ``iters`` timed
    calls with the table suspended (a nested knob times at its default,
    so that a re-sweep never measures under an older table), and the
    kernel libraries built or loaded during the timed calls (module
    doc)."""
    from raft_tpu_torch import config
    from raft_tpu_torch.ops import _build

    with config.suspend_tuning():
        step()
        _sync(dev)
        s0 = _build.stats()
        best = min(_timed(step, dev) for _ in range(iters))
        return best, _moved(s0, _build.stats())


def _time_ab(step_a, step_b, *, iters, dev):
    """Interleaved best-of-N of two arms (a load spike lands on both);
    ``(best_a, best_b, build_moves)``."""
    from raft_tpu_torch import config
    from raft_tpu_torch.ops import _build

    with config.suspend_tuning():
        step_a()
        step_b()
        _sync(dev)
        s0 = _build.stats()
        best_a = best_b = float("inf")
        for _ in range(iters):
            best_a = min(best_a, _timed(step_a, dev))
            best_b = min(best_b, _timed(step_b, dev))
        return best_a, best_b, _moved(s0, _build.stats())


# --------------------------------------------------------------------- #
# the sweep
# --------------------------------------------------------------------- #
def card_line(dev):
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[dev.index or 0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def effective_default(knob, dims, dev):
    """What an unset knob runs at the cell: the config default, else the
    consumer's own dispatch (the kernel where it is legal, on CUDA for
    the knobs that need it, else the plain route)."""
    from raft_tpu_torch import config
    from raft_tpu_torch.core import tuning

    default = config.knob_default(knob) if tuning.spec(knob).config_knob else None
    if default is not None:
        return default
    auto = tuning.spec(knob).auto_default
    legal = dict(tuning.legal_candidates(knob, dtype="float32", device=dev.type, **dims))
    if legal.get(auto, "") is None and (knob not in _CUDA_AUTO or dev.type == "cuda"):
        return auto
    return _PLAIN[knob]


def sweep_cell(op, knob, cell_name, dims, extra, *, iters, dev, min_margin=MIN_MARGIN,
               card="cpu"):
    """Check and time every sweep-legal candidate of one cell; the table
    entry, or None when no candidate is legal to sweep here."""
    from raft_tpu_torch.core import tuning

    cell = BUILDERS[op](dims, extra, dev)
    cands = tuning.legal_candidates(knob, purpose="sweep", dtype="float32", device=dev.type,
                                    **cell.dims)
    legal = [c for c, why in cands if why is None]
    skipped = {c: why for c, why in cands if why is not None}
    if not legal:
        return None
    default = effective_default(knob, cell.dims, dev)
    ref = cell.make(default)()
    outcome, timings, moves = {}, {}, {}
    for cand in legal:
        rule, why = parity(knob, cell, cell.make(cand)(), ref) if cand != default \
            else ("exact", None)
        outcome[cand] = rule if why is None else "FAILED (%s): %s" % (rule, why)
        if why is not None:
            continue
        timings[cand], moves[cand] = time_candidate(cell.make(cand), iters=iters, dev=dev)
    del ref
    if not timings:
        return None
    ranked = sorted(timings, key=timings.get)
    winner = ranked[0]
    margin = timings[ranked[1]] / timings[winner] if len(ranked) > 1 else 1.0
    vs_default = timings[default] / timings[winner] if default in timings else None
    reverted_from = None
    if default in timings and winner != default and vs_default < min_margin:
        # inside the noise band: keep the default; the margin is then the
        # best other candidate over it (below 1: that one was faster)
        reverted_from, winner, vs_default = winner, default, 1.0
        margin = min(t for c, t in timings.items() if c != winner) / timings[winner]
    name, _, limit = card.partition(", ")
    return {
        "op": op, "knob": knob, "cell": cell_name,
        "shape_class": tuning.shape_class(cell.dims), "dtype": "float32",
        "dims": cell.dims, "extra": extra, "winner": winner, "default": default,
        "margin": round(margin, 4), "reverted_from": reverted_from,
        "vs_default": None if vs_default is None else round(vs_default, 4),
        "timings_s": {c: round(t, 7) for c, t in timings.items()},
        "post_warmup_compiles": moves, "parity": outcome, "skipped": skipped,
        "iters": iters, "card": name, "power_limit": limit or None,
    }


def run_sweep(*, smoke=False, op_filter=None, cell_filter=None, iters=None,
              min_margin=MIN_MARGIN, device="cuda", log=print):
    """Run the sweep; returns the table document (not written)."""
    from raft_tpu_torch.core import tuning
    from raft_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    card = card_line(dev)
    cells = [c for c in catalog(smoke)
             if (not op_filter or op_filter in (c[0], c[1]))
             and (not cell_filter or cell_filter in c[2])]
    iters = iters or (ITERS_SMOKE if smoke else ITERS_FULL)
    entries = {}
    superseded = []
    for op, knob, cell_name, dims, extra in cells:
        log("sweep %s/%s cell=%s dims=%s ..." % (op, knob, cell_name, dims))
        e = sweep_cell(op, knob, cell_name, dims, extra, iters=iters, dev=dev,
                       min_margin=min_margin, card=card)
        if e is None:
            log("  no sweep-legal candidate on this backend; skipped")
            continue
        log("  winner=%s margin=%.3fx vs_default=%s timings=%s parity=%s" % (
            e["winner"], e["margin"], e["vs_default"],
            {c: "%.3f ms" % (t * 1e3) for c, t in e["timings_s"].items()}, e["parity"]))
        moved = {c: n for c, n in e["post_warmup_compiles"].items() if n}
        if moved:
            log("  WARNING kernel builds/loads inside the timed loop: %s" % moved)
        key = (op, knob, e["shape_class"], e["dtype"])
        if key in entries:
            superseded.append(entries[key])
        entries[key] = e
    entries = list(entries.values())
    # per-(op, knob) rollup (module doc): the winner that every swept cell
    # agrees on answers the classes nobody swept through the lookup's "*"
    groups = {}
    for e in entries:
        groups.setdefault((e["op"], e["knob"]), []).append(e)
    for (op, knob), group in sorted(groups.items()):
        winners = sorted({e["winner"] for e in group})
        if len(winners) > 1:
            log("  no rollup for %s/%s: the swept winners disagree (%s)"
                % (op, knob, ", ".join(winners)))
            continue
        entries.append({"op": op, "knob": knob, "cell": "rollup", "shape_class": "*",
                        "dtype": "*", "winner": winners[0],
                        "margin": min(e["margin"] for e in group),
                        "rollup_of": [e["cell"] for e in group]})
    return {"version": 1, "fingerprint": tuning.backend_fingerprint(),
            "created_unix": int(time.time()), "generated_by": "tools/torch_autotune.py",
            "card": card, "torch": torch.__version__, "smoke": smoke,
            "min_margin": min_margin, "entries": entries, "superseded": superseded}


def diff_tables(old, new, log=print):
    """Winner changes of ``new`` against the incumbent ``old``; returns
    the count."""
    def key(e):
        return (e["op"], e["knob"], e["shape_class"], e["dtype"])

    old_ix = {key(e): e for e in old.get("entries", [])}
    changes = 0
    for e in new["entries"]:
        inc = old_ix.pop(key(e), None)
        if inc is None:
            log("  NEW   %s/%s [%s] -> %s" % (e["op"], e["knob"], e["shape_class"],
                                             e["winner"]))
            changes += 1
        elif inc["winner"] != e["winner"]:
            log("  FLIP  %s/%s [%s]: %s -> %s" % (e["op"], e["knob"], e["shape_class"],
                                                 inc["winner"], e["winner"]))
            changes += 1
    for k in old_ix:
        log("  GONE  %s/%s [%s]" % (k[0], k[1], k[2]))
        changes += 1
    if not changes:
        log("  no winner changes against the incumbent")
    return changes


def tuned_vs_default(table, *, iters=5, device="cuda", cells=None, log=print):
    """Re-time the winner against the default for every swept cell of
    ``table`` (or the named ``cells``), interleaved; a winner that is the
    default reports 1.0 untimed.  Returns per-cell ratios (default time
    over tuned time), their range, and the builds or loads inside the
    timed loops."""
    from raft_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    out = {"cells": [], "min_ratio": None, "max_ratio": None, "post_warmup_compiles": 0}
    for e in table["entries"]:
        if e.get("shape_class") == "*" or "dims" not in e:
            continue
        if cells is not None and e["cell"] not in cells:
            continue
        default = e.get("default") or effective_default(e["knob"], e["dims"], dev)
        r = {"op": e["op"], "knob": e["knob"], "cell": e["cell"], "winner": e["winner"],
             "default": default}
        if e["winner"] == default:
            r["ratio"], r["note"] = 1.0, "winner is the default"
        else:
            cell = BUILDERS[e["op"]](e["dims"], e.get("extra", {}), dev)
            tw, td, moved = _time_ab(cell.make(e["winner"]), cell.make(default), iters=iters,
                                     dev=dev)
            r.update(ratio=round(td / tw, 4), tuned_s=round(tw, 7), default_s=round(td, 7))
            out["post_warmup_compiles"] += moved
        out["cells"].append(r)
        log("  %s/%s [%s]: default/tuned %.3fx" % (e["op"], e["knob"], e["cell"], r["ratio"]))
    ratios = [c["ratio"] for c in out["cells"]]
    if ratios:
        out["min_ratio"], out["max_ratio"] = min(ratios), max(ratios)
    return out


def default_out_path(table):
    from raft_tpu_torch.core import tuning

    return os.path.join(REPO, "raft_tpu_torch", "tuning",
                        tuning.fingerprint_slug(table["fingerprint"]) + ".json")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--op", help="filter: op or knob name")
    p.add_argument("--cell", help="filter: cell-name substring")
    p.add_argument("--smoke", action="store_true", help="one small cell per knob")
    p.add_argument("--dry-run", action="store_true",
                   help="plan only: cells and their sweep-legal candidates")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--min-margin", type=float, default=MIN_MARGIN)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: the card is what is measured) or cpu (a "
                        "rehearsal of the tool on the plain routes)")
    p.add_argument("--ab", action="store_true",
                   help="re-time each swept winner against the default, into the table")
    p.add_argument("--out", help="output path (default: raft_tpu_torch/tuning/<slug>.json)")
    args = p.parse_args(argv)
    if args.device.split(":")[0] == "cuda" and not torch.cuda.is_available():
        print("torch_autotune: no CUDA device here (torch.cuda.is_available() is False); "
              "the sweep measures the card. Pass --device cpu to rehearse the tool on the "
              "plain routes.", file=sys.stderr)
        return 2

    if args.dry_run:
        from raft_tpu_torch.core import tuning

        dev = args.device
        for op, knob, cell_name, dims, _ in catalog(args.smoke):
            if (args.op and args.op not in (op, knob)) or (args.cell and args.cell
                                                            not in cell_name):
                continue
            print("%s/%s cell=%s class=%s" % (op, knob, cell_name, tuning.shape_class(dims)))
            for c, why in tuning.legal_candidates(knob, purpose="sweep", dtype="float32",
                                                  device=dev, **dims):
                print("    %-12s %s" % (c, "SWEEP" if why is None else "skip: " + why))
        return 0

    table = run_sweep(smoke=args.smoke, op_filter=args.op, cell_filter=args.cell,
                      iters=args.iters, min_margin=args.min_margin, device=args.device)
    if args.ab:
        print("tuned vs default:")
        table["tuned_vs_default"] = tuned_vs_default(table, iters=args.iters or ITERS_FULL,
                                                     device=args.device)
    out = args.out or default_out_path(table)
    if os.path.exists(out):
        print("diff against the incumbent %s:" % out)
        try:
            with open(out, encoding="utf-8") as f:
                diff_tables(json.load(f), table)
        except (OSError, ValueError) as e:
            print("  incumbent unreadable (%s); overwriting" % e)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote %d entries -> %s" % (len(table["entries"]), out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
