#!/usr/bin/env python3
"""The chunk budget of raft_tpu_torch's IVF-PQ search, on the card, at the
shape of the benchmark's ``sift1m_ivfpq`` configuration.

    python3 tools/torch_ivfpq_sweep.py [--budgets 2,4,8] [--calls 3] [--seed 7]

Builds that configuration's index (the 1M x 128 mixture of
``portbench/frozen/datagen.py`` from its ``index_seed``, nlist 1024,
pq_dim 64 x 8 bits, refine 2, build seed 1234) with ``ivf_pq_build``'s
stage times, then, for each budget in GiB (``spatial/ann.py``'s
``PQ_BUDGET_BYTES`` set for the measurement), searches 10,000 queries
of the mixture at nprobe 50, k 100 and reports: the chunks, scan steps
and table bytes of one call (the program's counters), the device memory
the call took above the index and the queries (``max_memory_allocated``
against the budget), the call's time by CUDA events (median of
``--calls`` after a warm-up), and whether its answers are bit for bit
those of the first budget.  Then 300 of the queries cut into 1, 3 and 7
chunks, compared bit for bit.  Prints the card and one JSON line each;
needs a CUDA card and imports nothing of JAX.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.frozen import datagen  # noqa: E402
from raft_tpu_torch.core import tracing  # noqa: E402
from raft_tpu_torch.distance.distance_type import DistanceType  # noqa: E402
from raft_tpu_torch.spatial import ann  # noqa: E402

CONFIG = "portbench/configs/sift1m_ivfpq.json"


def _counts():
    return [tracing.get_counter(name) for name in ann.PQ_COUNTERS]


def _search(index, q, k, nprobe, budget):
    ann.PQ_BUDGET_BYTES = budget
    return ann.ivf_pq_search(index, q, k, nprobe, device="cuda")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--budgets", default="2,4,8", help="GiB, comma-separated")
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ivfpq_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print("card:", card, flush=True)
    conf = harness.load_json(ROOT / CONFIG)
    dev = torch.device("cuda")
    x, centers = datagen.make_index(conf["rows"], conf["dim"], conf["data"],
                                    conf["data"]["index_seed"], dev)
    stages = {}
    params = ann.IVFPQParams(nlist=conf["nlist"], nprobe=conf["nprobe"], M=conf["pq_dim"],
                             n_bits=conf["pq_bits"], refine_ratio=conf["refine_ratio"])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    index = ann.ivf_pq_build(x, params, DistanceType[conf["metric"]], seed=conf["build_seed"],
                             train_rows=conf["train_rows"], device=dev, stages=stages)
    ev[1].record()
    torch.cuda.synchronize()
    print(json.dumps({"build_s": ev[0].elapsed_time(ev[1]) * 1e-3, "stages_ms": stages,
                      "cap": int(index.slot_ids.shape[1]),
                      "slots": int(index.slot_ids.shape[0])}), flush=True)
    q = datagen.make_queries(conf["queries"], centers, conf["data"], args.seed)
    k, nprobe = conf["k"], conf["nprobe"]
    first = None
    for gib in [float(b) for b in args.budgets.split(",")]:
        budget = int(gib * (1 << 30))
        _search(index, q, k, nprobe, budget)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = _counts()
        out = _search(index, q, k, nprobe, budget)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        counts = [a - b for a, b in zip(_counts(), before)]
        times = []
        for _ in range(args.calls):
            ev[0].record()
            _search(index, q, k, nprobe, budget)
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        if first is None:
            first = out
        print(json.dumps({"budget_gib": gib, "chunks": counts[0], "steps": counts[1],
                          "table_bytes": counts[2], "peak_above_index": peak,
                          "within_budget": peak <= budget, "ms": statistics.median(times),
                          "ms_all": times, "queries_per_s": 1e3 * q.shape[0] / min(times),
                          "bitwise_as_first": all(torch.equal(a, b)
                                                  for a, b in zip(out, first))}), flush=True)
        del out
    sub = q[:300]
    cap = int(index.slot_ids.shape[1])
    per = ann.pq_query_bytes(nprobe, index.codebooks.shape[0], index.codebooks.shape[1], cap,
                             k * conf["refine_ratio"], conf["dim"], True)
    own = sub.shape[0] * (4 * nprobe + 8 * k)
    outs = {}
    for n in (1, 3, 7):
        before = _counts()
        outs[n] = _search(index, sub, k, nprobe, own + per * -(-sub.shape[0] // n))
        outs[n] = [t.clone() for t in outs[n]]
        outs[n].append(_counts()[0] - before[0])
    print(json.dumps({"chunkings": {n: o[2] for n, o in outs.items()},
                      "bitwise": all(torch.equal(outs[1][i], outs[n][i])
                                     for n in (3, 7) for i in (0, 1))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
