"""Candidate registry: every implementation choice of the port in one place.

Port of ``raft_tpu/core/tuning.py``.  Each choice registers its

    (op, knob, candidates, legality(value, ctx))

here, and the consumers resolve and validate through :func:`resolve` and
:func:`check` instead of carrying tuples of their own.  The registry is
also the search space of the sweep (``tools/torch_autotune.py``): it
times every candidate that is legal for a cell on the card and writes the
winners to the tuning table that :func:`raft_tpu_torch.config.tuned`
consults between the environment and the default.

The knob names are the JAX package's; the candidates are the port's own
implementations under the port's names (``"kernel"`` for a hand-written
Hopper kernel where JAX says ``"pallas"``, ``"scan"`` or ``"sort"`` for
the plain torch route where JAX says ``"xla"`` or ``"topk"``).  A JAX
value given to the port is refused in the one message shape of
:func:`check`, with the port's legal set; it is never mapped.

Vocabulary
----------
cell
    One (backend, op, shape class, dtype) point of the tuning space.
shape class
    :func:`shape_class`: the dims of a call site, each rounded to its
    nearest power of two, the same string as the JAX package's for the
    same dims.
legality
    ``legality(value, ctx) -> Optional[str]``: None when the candidate is
    legal for the cell ``ctx`` describes (dims, ``dtype``, ``device``,
    ``purpose``), else a reason.  ``purpose`` is ``"use"`` (a consumer's
    call: only correctness limits apply) or ``"sweep"`` (the sweep also
    drops candidates that are not worth timing here: a ``kernel*``
    candidate on a CPU tensor runs its plain version, a test vehicle).
no-sweep candidate
    Settable, never timed: a time-only comparison would trade something
    away (``kernel_bf16`` rounds the multiplicands; ``approx95`` drops
    top-k keys by design; ``cumsum``'s error grows with the running
    sum).
registry-only knob
    ``config_knob=False``: validated here and never read from config,
    environment or table (``fused_nn_impl``, ``mnmg_group_size``), so
    that no process-wide setting reaches them.

Knobs of the JAX registry with no counterpart here, since the port has
no second value to choose: ``tile_merge`` and ``knn_tile_merge`` pick
between selection networks of the TPU's 128-lane vector unit
(``spatial/tiled_knn.py`` and ``ops/knn_tile.py`` module docs: a warp's
shuffle network is the one selection core); ``knn_block_q`` and
``nn_block_n`` are tile shapes that K1 and K4 compile in
(``csrc/knn_tile.cuh`` ``kBN`` and ``block_q(d)``), so no runtime value
exists to tune; ``pq_adc``'s other candidate, the one-hot ADC, was
removed from the port (the gather is its one ADC, ``spatial/ann.py``);
and ``merge_select_impl``, K6's merge, is an argument of
``fused_knn_twophase`` alone (``"topk"``, the exact select, or
``"approx95"``; ``ops/knn_tile.py``), which no setting reaches.  ``knn_block_n`` stays: K6's JAX tile width is a
launch argument, and membership in its ladder is its whole legality (the
kernel's shared memory does not depend on it).

Error contract: every validation failure raises
:class:`~raft_tpu_torch.core.error.LogicError` in ONE message shape
(:func:`check`): the site, the knob, the value, the legal set and the
reason.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import LogicError

__all__ = [
    "register", "spec", "specs", "candidates", "check", "resolve",
    "legal_candidates", "shape_class", "backend_fingerprint",
    "fingerprint_slug",
]

# ctx -> None (legal) | reason string (illegal for this cell)
Legality = Callable[[str, Mapping], Optional[str]]


class KnobSpec:
    """One registered choice (module doc for the field meanings).

    ``config_knob``: True when the knob resolves through
    :mod:`raft_tpu_torch.config` (override, configure, env, table,
    default); False for the registry-only knobs, whose ``default`` is
    pinned here.  ``auto_default`` is what an unset knob runs (the
    consumer's own dispatch), the sweep's baseline where the config
    default is None.  ``dims`` are the ctx dims that define the shape
    class (the consumers and the sweep key cells on exactly these).
    """

    __slots__ = ("op", "knob", "candidates", "arg_only", "no_sweep",
                 "legality", "config_knob", "default", "auto_default",
                 "dims", "doc")

    def __init__(self, op, knob, candidates, *, arg_only=(),
                 no_sweep=None, legality=None, config_knob=True,
                 default=None, auto_default=None, dims=(), doc=""):
        self.op = op
        self.knob = knob
        self.candidates = tuple(candidates) if candidates else None
        self.arg_only = tuple(arg_only)
        self.no_sweep = dict(no_sweep or {})
        self.legality = legality
        self.config_knob = config_knob
        self.default = default
        self.auto_default = auto_default
        self.dims = tuple(dims)
        self.doc = doc

    def illegal_reason(self, value, ctx: Mapping) -> Optional[str]:
        """Why ``value`` is illegal for the cell ``ctx`` (None: legal).
        Membership (the arg-only rule and the JAX names included) first,
        then the spec's own legality predicate."""
        if self.candidates is not None:
            allowed = self.candidates + (
                self.arg_only if ctx.get("explicit") else ())
            if value not in allowed:
                if value in self.arg_only:
                    return ("argument-only (an attribution probe must "
                            "never be reachable from config/env/table)")
                if value in _JAX_NAMES.get(self.knob, ()):
                    return ("a candidate of the JAX package, not ported: "
                            "the port's own implementations are listed")
                return "unknown impl (not a registered candidate)"
        if ctx.get("purpose") == "sweep" and value in self.no_sweep:
            return self.no_sweep[value]
        if self.legality is not None:
            return self.legality(value, ctx)
        return None


_SPECS: Dict[str, KnobSpec] = {}

# the JAX registry's candidates of each ported knob that the port does not
# run under that name (refused, never mapped: module doc)
_JAX_NAMES: Dict[str, Tuple[str, ...]] = {
    "select_impl": ("topk", "approx", "chunked", "pallas"),
    "fused_knn_impl": ("xla", "pallas", "xla_fused"),
    "fused_nn_impl": ("xla", "pallas"),
    "ivf_scan_impl": ("xla", "pallas", "pallas_bf16"),
}


def register(op: str, knob: str, candidates, **kw) -> KnobSpec:
    """Register one choice (module doc); a second registration of a knob
    replaces the first.  Every knob is registered once, below, at
    import."""
    s = KnobSpec(op, knob, candidates, **kw)
    _SPECS[knob] = s
    return s


def spec(knob: str) -> KnobSpec:
    if knob not in _SPECS:
        raise LogicError(
            "raft_tpu_torch.core.tuning: unknown knob %r (registered: %s)"
            % (knob, ", ".join(sorted(_SPECS))))
    return _SPECS[knob]


def specs() -> Tuple[KnobSpec, ...]:
    """Every registered spec: the sweep's search space."""
    return tuple(_SPECS[k] for k in sorted(_SPECS))


def candidates(knob: str) -> Tuple[str, ...]:
    """The settable candidates of ``knob`` (the one source: consumer
    modules re-export this instead of a tuple of their own)."""
    c = spec(knob).candidates
    return c if c is not None else ()


def _fmt_legal(s: KnobSpec, explicit: bool) -> str:
    if s.candidates is None:
        return "free-form"
    return ", ".join(s.candidates + (s.arg_only if explicit else ()))


def check(knob: str, value, *, site: Optional[str] = None,
          explicit: bool = False, purpose: str = "use",
          dtype=None, **dims):
    """Validate ``value`` for ``knob`` at the cell that ``dims``,
    ``dtype`` and the other context describe; returns the value or raises
    :class:`LogicError` in the shared message shape (module doc)."""
    s = spec(knob)
    ctx = _ctx(explicit=explicit, purpose=purpose, dtype=dtype, **dims)
    reason = s.illegal_reason(value, ctx)
    if reason is not None:
        raise LogicError(
            "%s: %s=%r is illegal for this cell (legal: %s) — %s"
            % (site or s.op, knob, value, _fmt_legal(s, explicit), reason))
    return value


def legal_candidates(knob: str, *, purpose: str = "use", dtype=None,
                     **dims):
    """(candidate, reason) pairs, reason None where the candidate is
    legal for this cell: the sweep's view of a cell."""
    s = spec(knob)
    ctx = _ctx(explicit=False, purpose=purpose, dtype=dtype, **dims)
    return tuple((c, s.illegal_reason(c, ctx)) for c in (s.candidates or ()))


def resolve(knob: str, explicit=None, *, site: Optional[str] = None,
            dtype=None, **dims):
    """THE consumer entry point: the explicit argument, else the config
    ladder (override, configure, env, tuning table, default) for config
    knobs, else the spec's pinned default; always validated.

    A table answer that is illegal for the real cell (swept at a coarser
    class) is counted ``discarded`` and resolution takes the built-in
    default: the table is advisory, never a new way for a call that
    worked to fail.  Returns None only for knobs whose default is unset
    (the consumer's own dispatch decides, ``auto_default``).
    """
    s = spec(knob)
    site = site or s.op
    if explicit is not None:
        return check(knob, explicit, site=site, explicit=True,
                     dtype=dtype, **dims)
    if not s.config_knob:
        if s.default is None:
            return None
        return check(knob, s.default, site=site, dtype=dtype, **dims)
    from raft_tpu_torch import config

    value, layer = config.tuned(knob, op=s.op, dtype=_dtype_str(dtype),
                                dims=_class_dims(s, dims))
    if value is None:
        return None
    if layer == "table":
        ctx = _ctx(explicit=False, purpose="use", dtype=dtype, **dims)
        if s.illegal_reason(value, ctx) is not None:
            # the lookup counted a hit; the discard makes the effective
            # coverage (hits - discarded) readable
            config._count_table("discarded", knob)
            value = config.knob_default(knob)
            if value is None:
                return None
    return check(knob, value, site=site, dtype=dtype, **dims)


def _ctx(**kw) -> Mapping:
    d = {k: v for k, v in kw.items() if v is not None}
    d.setdefault("explicit", False)
    d.setdefault("purpose", "use")
    return d


def _dtype_str(dtype) -> Optional[str]:
    """``"float32"`` for torch.float32, numpy's float32 or the string."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    try:
        return np.dtype(dtype).name
    except TypeError:
        return getattr(dtype, "name", None) or str(dtype)


def _class_dims(s: KnobSpec, dims: Mapping) -> Dict[str, int]:
    """A consumer's dims cut to the spec's class dims, so that the lookup
    key and the sweep key cannot drift apart on extra context."""
    return {k: int(v) for k, v in dims.items()
            if k in s.dims and v is not None}


# --------------------------------------------------------------------- #
# shape classes and the backend fingerprint (the table's key space)
# --------------------------------------------------------------------- #
def shape_class(dims: Mapping) -> str:
    """Canonical shape-class string: each dim rounded to the nearest power
    of two (in log space), ``k=v`` sorted by name; no dims give ``"*"``.
    A sweep at (n=131072, k=128) and a call at (n=100000, k=100) share a
    class."""
    items = []
    for name in sorted(dims):
        v = dims[name]
        if v is None:
            continue
        v = int(v)
        b = 0 if v <= 0 else 1 << max(0, round(math.log2(v)))
        items.append("%s=%d" % (name, b))
    return ",".join(items) if items else "*"


def backend_fingerprint() -> Dict[str, object]:
    """(platform, device kind, device count) of this process's backend,
    the venue a tuning table is valid for: the card's name and count
    where CUDA is available, else ``("cpu", "cpu", 1)``."""
    if torch.cuda.is_available():
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(0),
                "device_count": torch.cuda.device_count()}
    return {"platform": "cpu", "device_kind": "cpu", "device_count": 1}


def fingerprint_slug(fp: Mapping) -> str:
    """Filesystem-safe name of a fingerprint (the checked-in tables under
    ``raft_tpu_torch/tuning/`` are named by it)."""
    kind = re.sub(r"[^A-Za-z0-9]+", "-", str(fp["device_kind"])).strip("-")
    return "%s_%s_d%d" % (fp["platform"], kind.lower(), int(fp["device_count"]))


# --------------------------------------------------------------------- #
# helpers of the legality predicates
# --------------------------------------------------------------------- #
def _on_card(ctx: Mapping) -> bool:
    """Whether the cell runs on the card: the ``device`` type the caller
    gave, else whether this process has CUDA."""
    dev = ctx.get("device")
    if dev is None:
        return torch.cuda.is_available()
    return str(dev).split(":")[0] == "cuda"


def _off_card_sweep(ctx: Mapping) -> Optional[str]:
    """Sweep-only rejection of the kernels off the card: a CPU tensor
    runs a kernel's plain version, a test vehicle, so timing it against
    the plain route would only measure the plain version twice."""
    if ctx.get("purpose") != "sweep" or _on_card(ctx):
        return None
    return ("a kernel runs its plain version on a CPU tensor, a test "
            "vehicle, not a sweep candidate there")


def _k_cap(ctx: Mapping, what: str) -> Optional[str]:
    from raft_tpu_torch.ops.select_tile import MAX_K

    if ctx.get("k") is not None and int(ctx["k"]) > MAX_K:
        return "%s caps k at %d; got k=%d" % (what, MAX_K, int(ctx["k"]))
    return None


def _legal_select_impl(value, ctx):
    if value == "approx95":
        dt = _dtype_str(ctx.get("dtype"))
        if dt is not None and not dt.startswith(("float", "bfloat")):
            return "the approximate select takes float keys, as in JAX; got %s" % dt
        return None
    if value != "kernel":
        return None
    why = _k_cap(ctx, "K2 (the select kernel)")
    if why:
        return why
    dt = _dtype_str(ctx.get("dtype"))
    if dt is not None and dt not in ("float32", "float16", "bfloat16"):
        return ("K2 takes float32, float16 or bfloat16 keys; %s keys take "
                "the stable sort" % dt)
    return _off_card_sweep(ctx)


# input types K1, K4 and K6 take (the narrower two through a float32 copy,
# as the JAX pad_with_norms casts), and the precisions they have an
# instance for: 3xTF32 at "highest", the bfloat16 single pass at "default"
_KERNEL_INPUTS = ("float32", "float16", "bfloat16")
_KERNEL_PRECISIONS = ("highest", "default")


def _legal_fused_knn(value, ctx):
    if value != "kernel":
        return None
    why = _k_cap(ctx, "K1 (the fused kNN kernel)")
    if why:
        return why + " — use impl='scan' or reduce k"
    dt = _dtype_str(ctx.get("dtype"))
    if dt is not None and dt not in _KERNEL_INPUTS:
        return "K1 takes float32, float16 or bfloat16 inputs; got %s" % dt
    if ctx.get("precision", "highest") not in _KERNEL_PRECISIONS:
        return ("K1 has instances for precision='highest' (3xTF32) and "
                "'default' (bfloat16 operands); got precision=%r" % ctx["precision"])
    return _off_card_sweep(ctx)


def _legal_fused_nn(value, ctx):
    if value != "kernel":
        return None
    dt = _dtype_str(ctx.get("dtype"))
    if (ctx.get("masked") or (dt is not None and dt not in _KERNEL_INPUTS)
            or ctx.get("precision", "highest") not in _KERNEL_PRECISIONS):
        return ("K4 serves the plain float32 min-reduce only (no mask, no "
                "float64; precision 'highest' or 'default'); use impl='scan'")
    return _off_card_sweep(ctx)


_L2_FAMILY = ("l2", "l2sqrt")


def _legal_ivf_scan(value, ctx):
    if value not in ("kernel", "kernel_bf16"):
        return None
    why = _k_cap(ctx, "K3 (the IVF scan kernel)")
    if why:
        return why + " — use scan_impl='scan'"
    metric = ctx.get("metric")
    if metric is not None and str(metric) not in _L2_FAMILY:
        return "K3 implements the expanded L2 family only; got metric=%r" % (metric,)
    dt = _dtype_str(ctx.get("dtype"))
    if dt is not None and dt != "float32":
        return "K3 takes float32 queries and store; got %s" % dt
    return _off_card_sweep(ctx)


def _legal_group_size(value, ctx):
    try:
        g = int(value)
    except (TypeError, ValueError):
        return "not an integer"
    size = ctx.get("axis_size")
    if size is not None and not (1 <= g <= int(size) and int(size) % g == 0):
        return ("group_size=%d must divide the merge axis size %d "
                "(balanced two-level decomposition)" % (g, int(size)))
    return None


# --------------------------------------------------------------------- #
# the registry: every implementation choice of the port, one block
# --------------------------------------------------------------------- #
register(
    "select_k", "select_impl", ("kernel", "sort", "approx95"),
    legality=_legal_select_impl,
    auto_default="kernel",
    no_sweep={"approx95": ("deliberately approximate (recall target 0.95) — "
                           "a time-only sweep must not trade exactness for "
                           "speed silently")},
    dims=("n", "k"),
    doc="per-row top-k (spatial/select_k.py): kernel = K2, sort = a "
        "stable torch.sort, approx95 = the TPU's approximate top-k (bins "
        "folded, then K2); unset = K2 where legal, else the sort")

register(
    "fused_l2_knn", "fused_knn_impl", ("kernel", "scan"),
    legality=_legal_fused_knn,
    auto_default="kernel",
    dims=("n", "k"),
    doc="fused L2 kNN (spatial/fused_l2_knn.py): kernel = K1, scan = "
        "the tile scan; unset = K1 on CUDA where legal, else the scan")

register(
    "fused_knn_twophase", "knn_block_n", ("256", "512", "1024", "2048", "4096"),
    dims=("n", "k", "d"),
    doc="K6's index-tile rows, the JAX tile width (ops/knn_tile.py): "
        "an integer ladder")

register(
    "ivf_flat_search", "ivf_scan_impl", ("kernel", "kernel_bf16", "scan"),
    legality=_legal_ivf_scan,
    auto_default="kernel",
    no_sweep={"kernel_bf16": ("rounds the multiplicands to bfloat16 — a "
                              "time-only sweep must not trade float32 "
                              "exactness silently")},
    dims=("n", "k", "d"),
    doc="IVF-Flat probe scan (spatial/ann.py): kernel = K3, kernel_bf16 "
        "= K3 on bfloat16 multiplicands, scan = the step scan; unset = "
        "K3 on CUDA where legal, else the scan")

register(
    "csr_spmv", "spmv_impl", ("segment", "cumsum", "sortscan"),
    no_sweep={"cumsum": ("differences a global running prefix — a row's "
                         "error scales with |cs| at its position "
                         "(sparse/linalg.py caveat); a time-only sweep "
                         "must not pick it")},
    dims=("rows", "nnz"),
    doc="CSR SpMV formulation (sparse/linalg.py)")

register(
    "mnmg_knn", "mnmg_merge", ("allgather", "ring", "hierarchical"),
    dims=("devices", "n", "k"),
    doc="cross-shard top-k merge topology (spatial/mnmg_knn.py and the "
        "sharded services)")

register(
    "fused_l2_nn", "fused_nn_impl", ("kernel", "scan"),
    legality=_legal_fused_nn,
    config_knob=False, default=None, auto_default="kernel",
    dims=("n", "k"),
    doc="fused 1-NN (distance/fused_l2_nn.py), argument-only as in the "
        "JAX package; unset = K4 on CUDA where legal, else the scan")

register(
    "mnmg_knn", "mnmg_group_size", None,
    legality=_legal_group_size,
    config_knob=False, default=None,
    dims=("devices",),
    doc="the hierarchical merge's group size (free-form int; must "
        "divide the merge axis size)")
