#!/usr/bin/env python3
"""Is the k-means update of raft_tpu_torch reproducible on the card?

    python3 tools/torch_kmeans_repro.py [--builds 3]

Builds the IVF-Flat index of ``chip_smoke.py``'s ``ivf_build_1M`` path
(1M x 128 rows of a Gaussian mixture drawn on the card from seed 0, 1024
lists, k-means on 131,072 sampled rows, seed 0) several times with each
of two forms of the k-means update, and says whether the builds of one
form agree bit for bit (centroids and lists):

- ``segment``: the module's ``_update``, each cluster summed in row order
  (a stable sort by label and ``torch.segment_reduce``);
- ``atomic``: the same update with one ``index_add_`` for the sums and
  one for the counts, which on the card adds with atomics.

Then times one update of each form at the training shape (median of 20
by CUDA events).  Prints the card (``nvidia-smi``) and one JSON line.
Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from raft_tpu_torch import DistanceType, IVFFlatParams, ivf_flat_build  # noqa: E402

# the module (its package exports the function kmeans under the same name)
km = importlib.import_module("raft_tpu_torch.spectral.kmeans")

N, DIM, NLIST, TRAIN_ROWS, N_BLOBS, SPREAD = 1_000_000, 128, 1024, 131_072, 256, 0.35


def atomic_update(X, C, labels):
    """The update with index_add_ (atomics on the card)."""
    k = C.shape[0]
    idx = labels.long()
    sums = torch.zeros_like(C).index_add_(0, idx, X)
    counts = torch.zeros(k, dtype=X.dtype, device=X.device).index_add_(
        0, idx, torch.ones_like(X[:, 0]))
    return torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], C)


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--builds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    centers = torch.randn(N_BLOBS, DIM, device=dev, generator=gen) * 4.0
    blob = torch.randint(0, N_BLOBS, (N,), device=dev, generator=gen)
    X = centers[blob] + torch.randn(N, DIM, device=dev, generator=gen) * SPREAD

    def build():
        ix = ivf_flat_build(X, IVFFlatParams(nlist=NLIST), DistanceType.L2SqrtExpanded,
                            seed=0, train_rows=TRAIN_ROWS, device=dev)
        torch.cuda.synchronize()
        return ix

    def same(a, b):
        return all(torch.equal(getattr(a, f).reshape(-1).view(torch.int32),
                               getattr(b, f).reshape(-1).view(torch.int32))
                   for f in ("centroids", "slot_ids", "slot_vecs", "list_sizes"))

    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  check=True).stdout.strip()}
    segment = km._update
    for name, update in (("atomic", atomic_update), ("segment", segment)):
        km._update = update
        builds = [build() for _ in range(args.builds)]
        out[name] = {"builds": args.builds,
                     "all_equal": all(same(builds[0], b) for b in builds[1:]),
                     "centroids_max_diff": max(
                         (b.centroids - builds[0].centroids).abs().max().item()
                         for b in builds[1:])}
        del builds
    km._update = segment

    # one update at the training shape, on random labels
    xs = X[torch.randperm(N, device=dev, generator=gen)[:TRAIN_ROWS]]
    C = xs[:NLIST].clone()
    labels = torch.randint(0, NLIST, (TRAIN_ROWS,), device=dev, generator=gen).to(torch.int32)
    out["update_ms"] = {"atomic": time_ms(lambda: atomic_update(xs, C, labels)),
                        "segment": time_ms(lambda: segment(xs, C, labels)),
                        "shape": "%d x %d rows into %d clusters" % (TRAIN_ROWS, DIM, NLIST)}
    print(out["card"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
