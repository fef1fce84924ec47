"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the per-layer metrics of a traced run.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name:

- ``BENCHMARK.json`` (at the root of the checkout) names the cell's
  configuration and traffic, and which metrics the cell reports;
- ``configs/<config>.json``: sizes, the system under test
  (``systems/<system>.py``), its plain reference
  (``reference/<reference>.py``) and the data's parameters;
- ``traffic/<traffic>.json``: the mix's parameters and the generator
  that reads them (``traffic/<generator>.py``);
- ``workloads/<cell>.json``: the cell's ``why`` and the limit of each
  number the check compares;
- ``metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from portbench.frozen import datagen
from portbench.reference.common import merge_numbers
from portbench.trace import WINDOW, Trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def process_start() -> float:
    """This process's start on the ``time.monotonic`` clock (to the
    kernel's tick), from ``/proc``; now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, bench: dict = None) -> dict:
    """The cell's configuration, traffic, limits and metric names."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit("no workload %r in BENCHMARK.json" % name)
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    cell = load_json(HERE / "workloads" / (name + ".json"))
    if (cell["config"], cell["traffic"]) != (work["config"], work["traffic"]):
        raise SystemExit("workloads/%s.json disagrees with BENCHMARK.json" % name)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"name": name, "chips": int(work["chips"]),
            "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(HERE / "traffic" / (work["traffic"] + ".json")),
            "limits": cell["limits"],
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def derive_seeds(seed: int) -> dict:
    """Independent seeds below 2**31 for each use, from one whole number."""
    words = np.random.SeedSequence(int(seed)).generate_state(6) >> np.uint32(1)
    return dict(zip(("data", "queries", "build", "traffic", "sample", "reference"),
                    map(int, words)))


def _reader(metric: str):
    path = HERE / "metrics" / (metric + ".py")
    spec = importlib.util.spec_from_file_location("portbench.metrics." + metric, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# what nvidia-smi reads of the card once the window has closed
CARD_FIELDS = ("power.limit", "power.draw", "clocks.sm", "clocks.max.sm", "temperature.gpu",
               "clocks_throttle_reasons.active")


def card_state() -> dict:
    """The card's power limit and draw, clocks, temperature and throttle
    reasons, as nvidia-smi reads them (``"not read"`` where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--id=%d" % torch.cuda.current_device(),
                              "--query-gpu=" + ",".join(CARD_FIELDS),
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        values = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
        if out.returncode == 0 and len(values) == len(CARD_FIELDS):
            return dict(zip(CARD_FIELDS, values))
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return dict.fromkeys(CARD_FIELDS, "not read")


def setup(spec: dict, seed: int, device="cuda"):
    """The cell's system under test on its data: the kernel libraries it
    runs built (only those), the index rows made from the seed, and the
    system set up on them.  Returns the context the traffic generators
    take; its ``phases`` holds the seconds of each step, the card
    synchronized at its end."""
    dev = torch.device(device)
    config, traffic = spec["config"], spec["traffic"]
    seeds = derive_seeds(seed)
    phases, mark = {}, [time.monotonic()]

    def phase(name):
        _sync(dev)
        now = time.monotonic()
        phases[name] = now - mark[0]
        mark[0] = now

    system_mod = importlib.import_module("portbench.systems." + config["system"])
    if dev.type == "cuda":
        from raft_tpu_torch.ops import _build
        _build.build(system_mod.KERNELS)
    phase("kernels")
    # a configuration may fix its index rows and its build (one base set
    # for every seed); the seed then draws the queries and the traffic
    x, centers = datagen.make_index(int(config["rows"]), int(config["dim"]), config["data"],
                                    config["data"].get("index_seed", seeds["data"]), dev)
    phase("data")
    system = system_mod.System(config, x, config.get("build_seed", seeds["build"]), dev)
    phase("system")
    return types.SimpleNamespace(system=system, x=x, centers=centers, config=config,
                                 traffic=traffic, seeds=seeds, device=dev, phases=phases,
                                 k=int(traffic.get("k", config["k"])), sync=lambda: _sync(dev))


def settle() -> None:
    """Collect, then freeze what set-up made and imported, so that the
    window's garbage collections trace only the objects the window makes
    (``gc.freeze``, as a latency-minded host process does after start)."""
    gc.collect()
    gc.freeze()


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float = None, control: str = None) -> dict:
    """Run the cell once and return its result (module doc).  With
    ``control`` (one of the reference's ``CONTROLS``) every answer the
    check judges, and for an index its build, is replaced by the
    reference's control before it is judged."""
    t_start = time.monotonic() if t_start is None else t_start
    started = time.monotonic() - t_start
    ctx = setup(spec, seed, device)
    dev, config, traffic, system = ctx.device, ctx.config, ctx.traffic, ctx.system
    gen = importlib.import_module("portbench.traffic." + traffic["generator"])
    t_warm = time.monotonic()
    state = gen.prepare(ctx)
    _sync(dev)
    settle()
    setup_s = time.monotonic() - t_start
    phases = dict(start=started, **ctx.phases, warm=time.monotonic() - t_warm)

    from raft_tpu_torch.core import inventory
    before = inventory.snapshot()
    tr = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                res = gen.window(state, seconds)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            tr = Trace.load(path)
        del prof
    else:
        res = gen.window(state, seconds)
    launches = _launch_deltas(before, inventory.snapshot())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    card = card_state() if dev.type == "cuda" else {}
    gen.close(state)

    t_ref = time.monotonic()
    numbers = judge(ctx, res, control)
    ref_s = time.monotonic() - t_ref

    e2e = dict(res["e2e"], setup_s=setup_s)
    if numbers.get("graded"):
        e2e["recall_at_100"] = numbers["hits"] / numbers["graded"]
    limits = spec["limits"]
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = bool(res["checks"]) and all(c["value"] <= c["limit"] for c in compared.values())

    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"]}
    notes = dict(res["notes"], reference_s=ref_s, card=card, setup_phases=phases,
                 checked={k: v for k, v in numbers.items() if k not in limits})
    if trace:
        mctx = types.SimpleNamespace(trace=tr, launches=launches, work=res["work"],
                                     system=system, config=config, traffic=traffic, k=ctx.k)
        metrics = {}
        for m in spec["per_layer"]:
            # None: nothing to read (the layer did not run in the window);
            # a reader that finds its layer but cannot count it raises
            got = _reader(m["name"])(mctx)
            if got is None:
                print("portbench: %s found nothing to read" % m["name"], file=sys.stderr)
                continue
            got = got if isinstance(got, dict) else {"value": got}
            metrics[m["name"]] = {"value": float(got["value"]), "unit": m["unit"]}
            if len(got) > 1:
                notes[m["name"]] = {k: v for k, v in got.items() if k != "value"}
        out["metrics"] = metrics
    else:
        missing = [m["name"] for m in spec["end_to_end"] if m["name"] not in e2e]
        if missing:
            raise RuntimeError("the run measured no %s" % ", ".join(missing))
        out["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                          for m in spec["end_to_end"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": spec["chips"], "memory_peak_bytes": int(peak),
                   "power_limit": card.get("power.limit", "none")}
    if trace:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    out["device"] = device_info
    out["notes"] = notes
    out["compared"] = compared
    return out


def judge(ctx, res: dict, control: str = None) -> dict:
    """Every number the check compares: the configuration's reference
    works out each judged answer again (each distinct block of queries
    once) and grades the program's answer, or the control's."""
    ref_mod = importlib.import_module("portbench.reference." + ctx.config["reference"])
    if control is not None and control not in ref_mod.Reference.CONTROLS:
        raise ValueError("no control %r for %s" % (control, ctx.config["reference"]))
    ref = ref_mod.Reference(ctx.config, ctx.x, ctx.system.judged_state(),
                            ctx.seeds["reference"], control)
    numbers = dict(ref.index_numbers())
    cache = {}
    for chk in res["checks"]:
        if chk["key"] not in cache:
            cache[chk["key"]] = ref.expect(chk["q"], ctx.k)
        exp, q = cache[chk["key"]], chk["q"]
        if chk["rows"] is not None:
            exp = {k: v[chk["rows"]] for k, v in exp.items()}
            q = q[chk["rows"]]
        got = ref.control(q, ctx.k) if control else (chk["d"], chk["i"])
        merge_numbers(numbers, ref.grade(q, *got, exp))
    numbers["missing"] = res["missing"]
    return numbers


def _launch_deltas(before: dict, after: dict) -> dict:
    """Kernel launches by shape between two inventory snapshots:
    ``{kernel: {shape key repr: launches}}``."""
    out = {}
    for fn, keys in after.items():
        for key, entry in keys.items():
            n = entry["launches"] - before.get(fn, {}).get(key, {}).get("launches", 0)
            if n:
                out.setdefault(fn, {})[key] = n
    return out


def report(result: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    for name, c in result["compared"].items():
        print("compared %s %r limit %r %s" % (name, c["value"], c["limit"],
                                               "ok" if c["value"] <= c["limit"] else "FAILED"),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
