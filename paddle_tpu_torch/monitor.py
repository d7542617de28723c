"""Runtime telemetry plane: metrics, step logs, spans, compile reports,
the live /metrics endpoint, and the collective stall watchdog.

The port's copy of the JAX package's ``monitor`` module: the same
registry, schemas, metric names, routes and text. What reads the device
reads the card: ``device_memory`` reads the CUDA caching allocator's
statistics (``torch.cuda.memory_stats``) of every visible CUDA device,
``is_oom_error`` also knows ``torch.OutOfMemoryError`` and CUDA's
allocation-failure text, and the OOM report's largest live buffers are
the allocator's largest live blocks. Those reads are host-side
allocator state and make no CUDA call, so a route or a watchdog thread
may read them while another thread captures a CUDA graph. The step's
``device`` phase is the delta to the step stream's synchronize on a
sampled step. ``/lint`` and ``/profile`` read planes the port has not
yet (analysis.py, roofline.py): they answer HTTP 501 naming the module.

The reference framework shipped a real observability stack (RecordEvent
host spans + CUPTI DeviceTracer + tools/timeline.py chrome traces); this
module is its runtime-metrics half, grown past the reference: one
process-wide plane with three pillars.

1. **Metrics registry** — ``counter()``/``gauge()``/``histogram()`` return
   process-wide named instruments with optional labels. Every mutation
   checks one module-level boolean first, so with telemetry off (the
   default) a call costs a flag check and allocates nothing — hot paths
   (``Executor.run``) stay instrumented permanently. ``snapshot()``
   returns plain dicts; ``dump_metrics()`` exports Prometheus text or
   JSON.

2. **Structured step logs** — ``log_step(record)`` appends one JSONL
   record per executor step to the ``step_log_path`` flag's file. The
   schema is versioned (``STEP_LOG_SCHEMA_VERSION``) and documented
   field-by-field in ``STEP_LOG_FIELDS`` (also README "Observability").

3. **Span unification** — ``span(name)`` wraps
   ``profiler.record_event`` so host spans from the executor, trainer
   epoch/step events, fleet barrier waits, ring-attention rotations and
   pipeline schedules all land in ONE chrome-trace timeline under
   consistent dotted names; with telemetry on, every span additionally
   feeds the ``pt_span_seconds`` histogram (interval measured with
   ``time.perf_counter`` — wall clock is only ever used for
   human-readable timestamps).

The compile & memory observability plane:

4. **Compile reports** — ``record_compile_report`` stores one versioned
   JSON document per fresh executor compile (XLA flops / bytes accessed /
   device-memory breakdown, op-lowering histogram; schema in
   ``COMPILE_REPORT_FIELDS``), written under the ``compile_report_dir``
   flag and mirrored into ``pt_compile_*`` gauges.
   ``estimate_memory(program, feed_shapes)`` is the static pre-flight
   twin: a shape-table estimate that can warn BEFORE a compile that
   would blow the ``device_memory_budget_bytes`` flag.

5. **Live endpoint** — ``serve(port)`` (or the ``metrics_port`` flag)
   runs a stdlib ``http.server`` background thread on localhost with
   ``/metrics`` (Prometheus text), ``/healthz``, ``/steps`` (the bounded
   step ring buffer) and ``/compile`` (latest compile reports). Zero
   dependencies beyond the standard library.

6. **Stall watchdog** — ``stall_guard(name)`` arms a timer around
   blocking collectives (fleet barriers/rendezvous, ring-attention and
   pipeline dispatch); past the ``stall_timeout_ms`` deadline it
   increments ``pt_stall_total``, records a structured stall record
   carrying the active span stack + last step record, and (gated on
   ``stall_dump_dir``) dumps the flight recorder to disk.

The time-attribution plane:

7. **Step phases + boundedness verdict** — executors split every step
   into ``feed`` (host->device staging), ``dispatch`` (Python + tracing
   overhead), ``device`` (delta to the step stream's synchronize) and
   ``fetch`` (device->host + decode); ``record_step_phases`` feeds the
   ``pt_step_phase_seconds`` histograms and a rolling window whose
   verdict (``input_bound`` / ``dispatch_bound`` / ``device_bound``)
   names the bottleneck. Input-pipeline consumer waits (reader queues,
   data_feeder batch assembly) accumulate via ``note_input_wait`` and
   weigh into the verdict, so a starved step is attributed to the input
   pipeline, not the device.

8. **Trace-event timeline** — every host span (via the
   ``profiler.record_event`` hook), step phase, compile and stall
   record becomes one Chrome-trace/Perfetto event in a bounded
   in-memory ring; ``export_trace()`` writes
   ``trace-<host>-<pid>.json`` under the ``trace_dir`` flag (also at
   process exit), the ``/trace`` route serves it live, and
   ``merge_traces()`` combines fleet-worker files onto per-rank tracks
   with clock-offset alignment.

The fleet observability plane:

9. **Fleet digests + cluster view** — the schema constants for the
   cross-rank metric digests workers publish into fleet KV
   (``FLEET_DIGEST_FIELDS``; assembly/aggregation lives in
   fleet_monitor.py), the ``/fleet`` cluster-view route and the merged
   ``/metrics?fleet=1`` Prometheus exposition, plus a ``/`` JSON index
   of every route.

10. **Device-memory watermarks + OOM forensics** —
    ``sample_device_memory`` reads guarded ``Device.memory_stats()``
    into ``pt_device_bytes_in_use/peak{device=}`` gauges every
    ``device_memory_every_n_steps`` executor steps (CPU / backends
    without the API degrade silently); ``maybe_record_oom`` turns a
    RESOURCE_EXHAUSTED failure during compile or run into a forensics
    report (compile-report peak bytes vs the budget flag, largest live
    buffers, recent step records) dumped under ``stall_dump_dir``.

Everything is off by default behind typed flags (flags.py); flipping
``telemetry`` at runtime takes effect immediately via a flag watcher,
and every disabled instrument call costs one module-level boolean check.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import io
import json
import os
import queue
import sys
import threading
import time
import warnings
from typing import Any, Dict, Iterable, List, Optional, Tuple

from paddle_tpu_torch import flags as _flags
from paddle_tpu_torch import profiler as _profiler

# ---------------------------------------------------------------------------
# enable/disable plumbing
# ---------------------------------------------------------------------------

# THE fast-path flag: every instrument mutation reads this one module-level
# boolean and returns before touching any other state when it is False.
_enabled = False

_LOCK = threading.Lock()

# The step-log writer gets its OWN lock: log_step does disk I/O (write +
# flush per record) and must never stall metric mutations under _LOCK.
_STEP_LOG_LOCK = threading.Lock()

# step-log writer state (lazily opened; keyed by path so a flag change
# mid-process rotates to the new file)
_step_log_file: Optional[io.TextIOBase] = None
_step_log_path: str = ""
_step_seq = 0


def enabled() -> bool:
    """Whether telemetry is on (cached value of the ``telemetry`` flag)."""
    return _enabled


def _sync_from_flags(_value=None):
    global _enabled
    _enabled = bool(_flags.get_flag("telemetry"))


def enable(step_log_path: Optional[str] = None,
           metrics_dump_path: Optional[str] = None):
    """Convenience: flip the ``telemetry`` flag (and optionally the log /
    dump path flags) on. Equivalent to ``flags.set_flags({...})``."""
    new = {"telemetry": True}
    if step_log_path is not None:
        new["step_log_path"] = step_log_path
    if metrics_dump_path is not None:
        new["metrics_dump_path"] = metrics_dump_path
    _flags.set_flags(new)


def disable():
    _flags.set_flags({"telemetry": False})


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

# label values are keyed by a sorted (k, v) tuple; () is the unlabelled cell
_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, Any]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# Label-cardinality cap: a mis-labelled hot-path metric (step index or a
# raw barrier name in a label) would otherwise grow one cell per distinct
# value forever — registry memory AND the Prometheus payload. Past
# MAX_LABEL_SETS distinct label-sets, new ones collapse into one
# overflow="true" cell; the first drop warns and every drop counts into
# pt_metric_label_overflow_total{metric=...}.
MAX_LABEL_SETS = 64
_OVERFLOW_KEY: _LabelKey = (("overflow", "true"),)


def _capped_key(metric, key: _LabelKey):
    """(effective key, dropped, first-drop) — caller holds _LOCK."""
    cells = metric._cells
    if key in cells or key == _OVERFLOW_KEY or len(cells) < MAX_LABEL_SETS:
        return key, False, False
    first = not metric._overflowed
    metric._overflowed = True
    return _OVERFLOW_KEY, True, first


def _note_overflow(name: str, first: bool):
    """Post-mutation bookkeeping, outside _LOCK (the overflow counter's
    own inc takes it)."""
    if first:
        warnings.warn(
            f"metric '{name}' exceeded {MAX_LABEL_SETS} distinct "
            f"label-sets; further label-sets collapse into "
            f'overflow="true"', RuntimeWarning)
    _overflow_total().inc(labels={"metric": name})


_overflow_counter: Optional["Counter"] = None


def _overflow_total() -> "Counter":
    global _overflow_counter
    if _overflow_counter is None:
        _overflow_counter = counter(
            "pt_metric_label_overflow_total",
            "metric mutations dropped into the overflow label bucket "
            "after MAX_LABEL_SETS distinct label-sets, by metric")
    return _overflow_counter


class Counter:
    """Monotonic counter. ``inc`` is a no-op (one flag check, zero
    allocations) while telemetry is off."""

    kind = "counter"
    __slots__ = ("name", "doc", "_cells", "_overflowed")

    def __init__(self, name: str, doc: str):
        self.name = name
        self.doc = doc
        self._cells: Dict[_LabelKey, float] = {}
        self._overflowed = False

    def inc(self, n: float = 1, labels: Optional[Dict[str, Any]] = None):
        if not _enabled:
            return
        key = _label_key(labels)
        with _LOCK:
            key, dropped, first = _capped_key(self, key)
            self._cells[key] = self._cells.get(key, 0.0) + n
        if dropped:
            _note_overflow(self.name, first)

    def value(self, labels: Optional[Dict[str, Any]] = None) -> float:
        return self._cells.get(_label_key(labels), 0.0)


class Gauge:
    """Last-value instrument (``set``) with an ``add`` for +/- deltas."""

    kind = "gauge"
    __slots__ = ("name", "doc", "_cells", "_overflowed")

    def __init__(self, name: str, doc: str):
        self.name = name
        self.doc = doc
        self._cells: Dict[_LabelKey, float] = {}
        self._overflowed = False

    def set(self, v: float, labels: Optional[Dict[str, Any]] = None):
        if not _enabled:
            return
        key = _label_key(labels)
        with _LOCK:
            key, dropped, first = _capped_key(self, key)
            self._cells[key] = float(v)
        if dropped:
            _note_overflow(self.name, first)

    def add(self, n: float = 1, labels: Optional[Dict[str, Any]] = None):
        if not _enabled:
            return
        key = _label_key(labels)
        with _LOCK:
            key, dropped, first = _capped_key(self, key)
            self._cells[key] = self._cells.get(key, 0.0) + n
        if dropped:
            _note_overflow(self.name, first)

    def replace(self, values: Iterable[Tuple[Optional[Dict[str, Any]],
                                             float]]):
        """Atomically swap EVERY cell for ``values`` ([(labels, value),
        ...]) — for gauges that mirror one bounded snapshot at a time
        (e.g. the roofline plane's top-K op seconds, whose per-compile
        HLO label values would otherwise accrete stale cells forever).
        A concurrent scrape sees either the old set or the new one,
        never a partial mix. The MAX_LABEL_SETS cap applies here too:
        values past it are dropped (first-listed win — callers pass
        rank order), metered into pt_metric_label_overflow_total and
        warned once, same as every other mutator. No-op while
        telemetry is off."""
        if not _enabled:
            return
        cells: Dict[_LabelKey, float] = {}
        dropped = 0
        for labels, v in values:
            key = _label_key(labels)
            if len(cells) >= MAX_LABEL_SETS and key not in cells:
                dropped += 1
                continue
            cells[key] = float(v)
        with _LOCK:
            first = dropped > 0 and not self._overflowed
            self._cells = cells
            # sticky, like _capped_key's lifetime-once contract: a
            # small replace must not re-arm the once-only warning
            self._overflowed = self._overflowed or dropped > 0
        if dropped:
            if first:
                warnings.warn(
                    f"metric '{self.name}' replace() exceeded "
                    f"{MAX_LABEL_SETS} label-sets; {dropped} values "
                    f"dropped", RuntimeWarning)
            _overflow_total().inc(dropped, labels={"metric": self.name})

    def value(self, labels: Optional[Dict[str, Any]] = None) -> float:
        return self._cells.get(_label_key(labels), 0.0)


# default buckets: tuned for step/compile/barrier latencies in seconds
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound; +Inf is implicit)."""

    kind = "histogram"
    __slots__ = ("name", "doc", "buckets", "_cells", "_overflowed")

    def __init__(self, name: str, doc: str,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.name = name
        self.doc = doc
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # cell: [counts per bucket..., +inf count, sum]
        self._cells: Dict[_LabelKey, list] = {}
        self._overflowed = False

    def observe(self, v: float, labels: Optional[Dict[str, Any]] = None):
        if not _enabled:
            return
        v = float(v)
        key = _label_key(labels)
        with _LOCK:
            key, dropped, first = _capped_key(self, key)
            cell = self._cells.get(key)
            if cell is None:
                cell = [0] * (len(self.buckets) + 1) + [0.0]
                self._cells[key] = cell
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    cell[i] += 1
                    break
            else:
                cell[len(self.buckets)] += 1
            cell[-1] += v
        if dropped:
            _note_overflow(self.name, first)

    def count(self, labels: Optional[Dict[str, Any]] = None) -> int:
        cell = self._cells.get(_label_key(labels))
        return int(sum(cell[:-1])) if cell else 0

    def sum(self, labels: Optional[Dict[str, Any]] = None) -> float:
        cell = self._cells.get(_label_key(labels))
        return float(cell[-1]) if cell else 0.0

    def quantile(self, q: float,
                 labels: Optional[Dict[str, Any]] = None) -> Optional[float]:
        """Bucket-interpolated quantile estimate (None when empty)."""
        cell = self._cells.get(_label_key(labels))
        if not cell:
            return None
        return _hist_quantile(self.buckets, cell, q)


# quantile summaries exported alongside the raw buckets so the p50/p95/p99
# of barrier waits or compile times are readable without a Prometheus
# server doing histogram_quantile() for you
QUANTILE_LABELS = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


def _hist_quantile(bounds, cell, q: float) -> Optional[float]:
    """Linear interpolation inside the target bucket (the same estimate
    Prometheus's histogram_quantile makes). Observations in the +Inf
    bucket clamp to the top finite bound."""
    total = sum(cell[:-1])
    if total == 0:
        return None
    target = q * total
    acc = 0.0
    lo = 0.0
    for i, ub in enumerate(bounds):
        c = cell[i]
        if c and acc + c >= target:
            return lo + (ub - lo) * ((target - acc) / c)
        acc += c
        lo = ub
    return bounds[-1] if bounds else 0.0


_REGISTRY: Dict[str, Any] = {}


def _get_or_create(cls, name: str, doc: str, **kwargs):
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric '{name}' already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m
        m = cls(name, doc, **kwargs)
        _REGISTRY[name] = m
        return m


def counter(name: str, doc: str = "") -> Counter:
    return _get_or_create(Counter, name, doc)


def gauge(name: str, doc: str = "") -> Gauge:
    return _get_or_create(Gauge, name, doc)


def histogram(name: str, doc: str = "",
              buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
    h = _get_or_create(Histogram, name, doc, buckets=buckets)
    want = tuple(sorted(float(b) for b in buckets))
    if h.buckets != want:
        # silently returning the existing instrument would bucket the
        # caller's observations against bounds it never asked for
        raise ValueError(
            f"histogram '{name}' already registered with buckets "
            f"{h.buckets}, requested {want}")
    return h


def reset():
    """Zero every registered metric and close the step-log writer (test
    isolation). Metric OBJECTS survive — instrumented modules hold
    references to them, so dropping the registry would orphan live
    instruments into invisible counters."""
    global _step_log_file, _step_log_path, _step_seq, _step_log_warned
    global _stall_seq
    with _LOCK:
        for m in _REGISTRY.values():
            m._cells.clear()
            m._overflowed = False
    with _STEP_LOG_LOCK:
        _step_log_warned = False
        if _step_log_file is not None:
            try:
                _step_log_file.close()
            except OSError:
                pass
        _step_log_file = None
        _step_log_path = ""
        _step_seq = 0
        _STEP_RING.clear()
    with _COMPILE_LOCK:
        _COMPILE_REPORTS.clear()
    _STALLS.clear()
    _stall_seq = 0
    global _oom_seq
    _OOM_RECORDS.clear()
    _oom_seq = 0
    with _TRACE_LOCK:
        _TRACE_RING.clear()
        _DYN_TRACKS.clear()
    global _input_wait_s, _last_bound
    with _BOUND_LOCK:
        _input_wait_s = 0.0
        _bound_window.clear()
        _last_bound = None
    import sys

    # numerics and the fleet plane ride the same test-isolation hook;
    # lazy so importing monitor alone never pulls either in
    numerics = sys.modules.get("paddle_tpu_torch.numerics")
    if numerics is not None:
        numerics.reset()
    fm = sys.modules.get("paddle_tpu_torch.fleet_monitor")
    if fm is not None:
        fm.reset()
    rl = sys.modules.get("paddle_tpu_torch.roofline")
    if rl is not None:
        rl.reset()
    st = sys.modules.get("paddle_tpu_torch.serving_trace")
    if st is not None:
        st.reset()


def snapshot() -> Dict[str, Any]:
    """Plain-dict view of every registered metric.

    ``{name: {"kind", "doc", "values": [{"labels": {...}, ...}]}}`` —
    counters/gauges carry ``value``; histograms carry ``count``, ``sum``
    and cumulative ``buckets`` ``[[upper_bound, count], ...]`` ending in
    the +Inf bucket.
    """
    out: Dict[str, Any] = {}
    with _LOCK:
        for name, m in sorted(_REGISTRY.items()):
            values = []
            for key, cell in sorted(m._cells.items()):
                labels = {k: v for k, v in key}
                if m.kind == "histogram":
                    cum, acc = [], 0
                    for ub, c in zip(m.buckets, cell):
                        acc += c
                        cum.append([ub, acc])
                    acc += cell[len(m.buckets)]
                    cum.append(["+Inf", acc])
                    val = {"labels": labels, "count": acc,
                           "sum": cell[-1], "buckets": cum}
                    for qname, q in QUANTILE_LABELS:
                        val[qname] = _hist_quantile(m.buckets, cell, q)
                    values.append(val)
                else:
                    values.append({"labels": labels, "value": cell})
            out[name] = {"kind": m.kind, "doc": m.doc, "values": values}
    return out


# --- exporters ---

def _prom_labels(labels: Dict[str, str], extra: Optional[tuple] = None) -> str:
    items = list(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\")
                     .replace('"', '\\"').replace("\n", "\\n"))
        for k, v in items
    )
    return "{%s}" % body


def to_prometheus(snap: Optional[Dict[str, Any]] = None) -> str:
    """Prometheus text exposition format (# HELP / # TYPE / samples)."""
    snap = snapshot() if snap is None else snap
    lines = []
    for name, m in snap.items():
        if m["doc"]:
            lines.append(f"# HELP {name} {m['doc']}")
        lines.append(f"# TYPE {name} {m['kind']}")
        for cell in m["values"]:
            labels = cell["labels"]
            if m["kind"] == "histogram":
                for ub, c in cell["buckets"]:
                    lines.append(
                        f"{name}_bucket"
                        f"{_prom_labels(labels, ('le', ub))} {c}")
                lines.append(
                    f"{name}_sum{_prom_labels(labels)} {cell['sum']}")
                lines.append(
                    f"{name}_count{_prom_labels(labels)} {cell['count']}")
                for qname, _q in QUANTILE_LABELS:
                    if cell.get(qname) is not None:
                        lines.append(
                            f"{name}_{qname}"
                            f"{_prom_labels(labels)} {cell[qname]}")
            else:
                lines.append(
                    f"{name}{_prom_labels(labels)} {cell['value']}")
    return "\n".join(lines) + ("\n" if lines else "")


def to_json(snap: Optional[Dict[str, Any]] = None) -> str:
    return json.dumps(snapshot() if snap is None else snap,
                      sort_keys=True, indent=1)


def dump_metrics(path: Optional[str] = None, fmt: str = "prometheus") -> str:
    """Export all metrics; returns the text, writes it to ``path`` (or the
    ``metrics_dump_path`` flag when set) too. ``fmt``: 'prometheus' or
    'json'."""
    if fmt in ("prometheus", "prom", "text"):
        text = to_prometheus()
    elif fmt == "json":
        text = to_json()
    else:
        raise ValueError(f"unknown metrics format '{fmt}'")
    path = path or _flags.get_flag("metrics_dump_path")
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def _dump_at_exit():
    if _enabled and _flags.get_flag("metrics_dump_path"):
        try:
            dump_metrics()
        except OSError:
            pass


atexit.register(_dump_at_exit)


# ---------------------------------------------------------------------------
# structured step logs
# ---------------------------------------------------------------------------

STEP_LOG_SCHEMA_VERSION = 1

# field name -> (accepted types, required, doc). The contract tests and
# README both derive from this table; bump STEP_LOG_SCHEMA_VERSION on any
# incompatible change.
STEP_LOG_FIELDS: Dict[str, tuple] = {
    "v": ((int,), True, "schema version (STEP_LOG_SCHEMA_VERSION)"),
    "ts": ((float, int), True,
           "wall-clock unix timestamp (human-readable anchor only; all "
           "durations are perf_counter intervals)"),
    "seq": ((int,), True, "process-wide record sequence number"),
    "kind": ((str,), True, "'step' (Executor.run) or 'window' (run_steps)"),
    "step": ((int,), True, "executor step index (first step of a window)"),
    "steps": ((int,), False, "window length (kind == 'window' only)"),
    "wall_ms": ((float, int), True,
                "host wall time of the run call, perf_counter-based"),
    "compile_ms": ((float, int, type(None)), True,
                   "XLA lower+jit wrap time (disk-cache deserialize "
                   "time on a 'disk' outcome); null on an in-memory hit"),
    "cache": ((str,), True,
              "compile-cache outcome: 'hit' (in-memory), 'disk' "
              "(executable resolved from the persistent level-2 cache) "
              "or 'miss' (fresh compile)"),
    "evictions": ((int,), True,
                  "cache entries evicted by this step's insert"),
    "feed_bytes": ((int,), True, "total bytes across feed arrays"),
    "fetch_bytes": ((int,), True, "total bytes across fetch arrays"),
    "nan_check": ((str, type(None)), True,
                  "'ok'/'fail' when check_nan_inf ran, else null"),
    "nan_step": ((int,), False,
                 "GLOBAL index of the first non-finite step inside a "
                 "compiled window (only on a window nan_check fail)"),
    "numerics": ((dict,), False,
                 "sampled numerics-bundle summary (numerics.py): "
                 "instrumented var count, non-finite var count, "
                 "first_bad {op, op_type, var} or null, aux gauges"),
    "phases": ((dict,), False,
               "per-phase time attribution in ms: feed (host->device "
               "staging), dispatch (Python + tracing overhead), device "
               "(delta to block_until_ready), fetch (device->host + "
               "decode); windows carry whole-window totals"),
    "bound": ((str,), False,
              "boundedness verdict over the trailing step window: "
              "'input_bound', 'dispatch_bound' or 'device_bound'"),
    "sampled": ((bool,), False,
                "whether the step-phase plane sampled this step "
                "(step_phases_every_n): false = the step dispatched "
                "fully async, so wall_ms excludes device time and the "
                "record carries no phases; absent while the phase "
                "plane is off entirely"),
    "strategy": ((str, type(None)), True,
                 "SPMD strategy id (mesh axes) or null for plain runs"),
}


def _validate_fields(rec, fields: Dict[str, tuple], version: int,
                     kind: str):
    """Shared field-table validator behind every validate_* entry point
    (step records, compile reports, fleet digests, OOM reports): dict
    shape, required fields, per-field types, unknown-field rejection,
    schema-version match."""
    if not isinstance(rec, dict):
        raise ValueError(f"{kind} must be a dict, got {type(rec)}")
    for field, (types, required, _doc) in fields.items():
        if field not in rec:
            if required:
                raise ValueError(f"{kind} missing field '{field}'")
            continue
        if not isinstance(rec[field], types):
            raise ValueError(
                f"{kind} field '{field}' has type "
                f"{type(rec[field]).__name__}, expected one of "
                f"{[t.__name__ for t in types]}")
    unknown = set(rec) - set(fields)
    if unknown:
        raise ValueError(f"{kind} has unknown fields {sorted(unknown)}")
    if rec["v"] != version:
        raise ValueError(f"{kind} schema v{rec['v']} != v{version}")


def validate_step_record(rec: Dict[str, Any]):
    """Raise ValueError unless ``rec`` conforms to STEP_LOG_FIELDS."""
    _validate_fields(rec, STEP_LOG_FIELDS, STEP_LOG_SCHEMA_VERSION,
                     "step record")


def step_log_active() -> bool:
    """True when telemetry is on AND a step_log_path is configured."""
    return _enabled and bool(_flags.get_flag("step_log_path"))


def step_records_active() -> bool:
    """True when executors should assemble per-step records: with
    telemetry on every record feeds the in-memory ring buffer (the
    /steps endpoint + flight recorder), whether or not a step_log_path
    routes them to disk too."""
    return _enabled


# Bounded flight-recorder ring of the last N step records. Fed by every
# log_step call; served by /steps and dumped by the stall watchdog. The
# deque bound is the memory contract — a week-long job holds the same
# 256 records as a smoke test.
STEP_RING_CAPACITY = 256
_STEP_RING: collections.deque = collections.deque(maxlen=STEP_RING_CAPACITY)


def recent_steps(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """Last ``n`` (default: all buffered) step records, oldest first."""
    with _STEP_LOG_LOCK:
        recs = list(_STEP_RING)
    if n is None:
        return recs
    n = int(n)
    return recs[-n:] if n > 0 else []


_step_log_warned = False


def log_step(record: Dict[str, Any]):
    """Record one step: fills ``v``, ``ts`` and ``seq``, appends to the
    bounded ring buffer, and — when ``step_log_path`` is configured —
    appends a JSONL line (flushed per record so a live tail sees every
    one). No-op when telemetry is off. An unwritable path warns once and
    drops the DISK copy only — callers invoke this from ``finally``
    blocks, and a telemetry failure must never mask the step's real
    result (or the exception being recorded)."""
    global _step_log_file, _step_log_path, _step_seq, _step_log_warned
    if not _enabled:
        return
    path = _flags.get_flag("step_log_path")
    with _STEP_LOG_LOCK:
        record = dict(record)
        record.setdefault("v", STEP_LOG_SCHEMA_VERSION)
        record.setdefault("ts", time.time())  # human-readable anchor
        record["seq"] = _step_seq
        _step_seq += 1
        _STEP_RING.append(record)
        if not path:
            return
        try:
            if _step_log_file is None or path != _step_log_path:
                if _step_log_file is not None:
                    try:
                        _step_log_file.close()
                    except OSError:
                        pass
                _step_log_file = None
                _step_log_file = open(path, "a")
                _step_log_path = path
                _step_log_warned = False
            # default=str: a numpy scalar (or anything else json chokes
            # on) degrades to its string form instead of raising
            _step_log_file.write(
                json.dumps(record, sort_keys=True, default=str) + "\n")
            _step_log_file.flush()
        except Exception as e:  # never-raise contract: callers log from
            # finally blocks and the step's real exception must win
            if not _step_log_warned:
                _step_log_warned = True
                warnings.warn(
                    f"step log write to {path!r} failed; records are "
                    f"being dropped: {e!r}", RuntimeWarning)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

_span_seconds: Optional[Histogram] = None

# Per-thread stack of active span names (telemetry-on spans only): the
# stall watchdog snapshots it at arm time so a stall record says WHERE
# the thread was ("trainer.step" > "executor.run_step"), not just that
# it stalled.
_TLS = threading.local()


def span_stack() -> Tuple[str, ...]:
    """Names of this thread's active telemetry spans, outermost first."""
    return tuple(getattr(_TLS, "spans", ()))


def span(name: str):
    """RAII span with one timeline: always emits a host chrome-trace span
    through ``profiler.record_event`` (a no-op unless the profiler is
    on); with telemetry on, additionally times the body with
    ``perf_counter`` into the ``pt_span_seconds`` histogram labelled by
    span name. When telemetry is off this returns the record_event
    context manager directly — byte-identical behavior and allocation
    profile to calling the profiler yourself."""
    if not _enabled:
        return _profiler.record_event(name)
    return _timed_span(name)


@contextlib.contextmanager
def _timed_span(name: str):
    global _span_seconds
    if _span_seconds is None:
        _span_seconds = histogram(
            "pt_span_seconds", "host span durations by span name")
    stack = getattr(_TLS, "spans", None)
    if stack is None:
        stack = _TLS.spans = []
    stack.append(name)
    t0 = time.perf_counter()
    with _profiler.record_event(name):
        try:
            yield
        finally:
            _span_seconds.observe(time.perf_counter() - t0,
                                  labels={"span": name})
            stack.pop()


# ---------------------------------------------------------------------------
# compile reports
# ---------------------------------------------------------------------------

COMPILE_REPORT_SCHEMA_VERSION = 1

# field name -> (accepted types, required, doc). Cost/memory numbers are
# null (with source == "estimate") when the jax/backend version exposes
# no cost_analysis()/memory_analysis(); bump the version on any
# incompatible change. The doc-coverage test and README both derive from
# this table.
COMPILE_REPORT_FIELDS: Dict[str, tuple] = {
    "v": ((int,), True,
          "schema version (COMPILE_REPORT_SCHEMA_VERSION)"),
    "ts": ((float, int), True, "wall-clock unix timestamp of the compile"),
    "program": ((str,), True, "program id ('program<uid>')"),
    "program_uid": ((int,), True, "Program._uid of the compiled program"),
    "cache_key": ((str,), True,
                  "hash of the executor cache key (program version + "
                  "feed signature + fetch list)"),
    "kind": ((str,), True, "'step' (run) or 'window' (run_steps)"),
    "backend": ((str,), True, "jax backend the program compiled for"),
    "source": ((str,), True,
               "'xla' when cost/memory numbers come from the compiled "
               "executable; 'estimate' when the analysis APIs were "
               "unavailable and only op-count estimates are present"),
    "compile_ms": ((float, int, type(None)), True,
                   "executor-side build time (trace + jit wrap)"),
    "analysis_ms": ((float, int, type(None)), True,
                    "AOT lower+compile time of the analysis twin — the "
                    "closest measure of true XLA compile cost; null "
                    "when source == 'estimate'"),
    "flops": ((float, int, type(None)), True,
              "XLA cost-analysis flop count; null when unavailable"),
    "bytes_accessed": ((float, int, type(None)), True,
                       "XLA cost-analysis bytes accessed (HBM traffic "
                       "estimate); null when unavailable"),
    "peak_bytes": ((int, type(None)), True,
                   "argument + output + temp - aliased bytes: the "
                   "device-memory high-water estimate; null when "
                   "unavailable"),
    "argument_bytes": ((int, type(None)), True,
                       "device bytes of the program's arguments"),
    "output_bytes": ((int, type(None)), True,
                     "device bytes of the program's outputs"),
    "temp_bytes": ((int, type(None)), True,
                   "XLA temp-buffer bytes (workspace/scratch)"),
    "alias_bytes": ((int, type(None)), True,
                    "argument bytes aliased into outputs (donation)"),
    "generated_code_bytes": ((int, type(None)), True,
                             "compiled executable code size"),
    "n_ops": ((int,), True, "Program-IR ops lowered into this XLA "
                            "program"),
    "op_histogram": ((dict,), True,
                     "op type -> count over the lowered block (the "
                     "op-lowering histogram)"),
    "strategy": ((str, type(None)), True,
                 "SPMD strategy id (mesh axes) or null"),
    "window_steps": ((int, type(None)), False,
                     "steps compiled into a 'window' report's program "
                     "(its flops/bytes cover the WHOLE window; the "
                     "roofline plane divides by this); absent on "
                     "'step' reports"),
}


def validate_compile_report(rec: Dict[str, Any]):
    """Raise ValueError unless ``rec`` conforms to COMPILE_REPORT_FIELDS."""
    _validate_fields(rec, COMPILE_REPORT_FIELDS,
                     COMPILE_REPORT_SCHEMA_VERSION, "compile report")
    if rec["source"] not in ("xla", "estimate"):
        raise ValueError(
            f"compile report source {rec['source']!r} not in "
            f"('xla', 'estimate')")


_COMPILE_LOCK = threading.Lock()
# program id -> latest report; insertion-ordered so eviction drops the
# program that compiled longest ago
_COMPILE_REPORTS: Dict[str, Dict[str, Any]] = {}
MAX_COMPILE_REPORTS = 32

_M_COMPILE_REPORTS = None
_M_COMPILE_FLOPS = None
_M_COMPILE_PEAK = None
_M_COMPILE_SECONDS = None


def _compile_instruments():
    global _M_COMPILE_REPORTS, _M_COMPILE_FLOPS, _M_COMPILE_PEAK
    global _M_COMPILE_SECONDS
    if _M_COMPILE_REPORTS is None:
        _M_COMPILE_REPORTS = counter(
            "pt_compile_reports_total", "compile reports recorded")
        _M_COMPILE_FLOPS = gauge(
            "pt_compile_flops",
            "XLA cost-analysis flops of the latest compile, by program")
        _M_COMPILE_PEAK = gauge(
            "pt_compile_peak_bytes",
            "device-memory high-water estimate of the latest compile, "
            "by program")
        _M_COMPILE_SECONDS = histogram(
            "pt_compile_seconds",
            "XLA compile time per fresh executor compile")


def compile_reports_active() -> bool:
    """Executors consult this per cache miss: reports are generated when
    telemetry is on AND someone can see them (a compile_report_dir is
    configured or the live endpoint is up). Each report costs one extra
    AOT lower+compile, so it is never on by accident."""
    return _enabled and (bool(_flags.get_flag("compile_report_dir"))
                         or _server is not None)


def record_compile_report(report: Dict[str, Any]):
    """Store a compile report: ring-buffered in memory (the /compile
    endpoint), mirrored into pt_compile_* instruments, and written as
    ``<program>-<cache_key>.json`` under the ``compile_report_dir`` flag
    when set. Never raises — telemetry must not fail a step."""
    try:
        report = dict(report)
        report.setdefault("v", COMPILE_REPORT_SCHEMA_VERSION)
        report.setdefault("ts", time.time())
        _compile_instruments()
        prog = report.get("program", "?")
        with _COMPILE_LOCK:
            _COMPILE_REPORTS.pop(prog, None)
            _COMPILE_REPORTS[prog] = report
            while len(_COMPILE_REPORTS) > MAX_COMPILE_REPORTS:
                _COMPILE_REPORTS.pop(next(iter(_COMPILE_REPORTS)))
        _M_COMPILE_REPORTS.inc()
        if report.get("flops") is not None:
            _M_COMPILE_FLOPS.set(report["flops"],
                                 labels={"program": prog})
        if report.get("peak_bytes") is not None:
            _M_COMPILE_PEAK.set(report["peak_bytes"],
                                labels={"program": prog})
        ms = report.get("analysis_ms") or report.get("compile_ms")
        if ms is not None:
            _M_COMPILE_SECONDS.observe(ms / 1e3)
        out_dir = _flags.get_flag("compile_report_dir")
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            fname = f"{prog}-{report.get('cache_key', 'nokey')}.json"
            with open(os.path.join(out_dir, fname), "w") as f:
                json.dump(report, f, sort_keys=True, indent=1,
                          default=str)
    except Exception as e:
        warnings.warn(f"compile report dropped: {e!r}", RuntimeWarning)


def compile_reports() -> Dict[str, Dict[str, Any]]:
    """Latest compile report per program (insertion order = compile
    order, oldest first)."""
    with _COMPILE_LOCK:
        return {k: dict(v) for k, v in _COMPILE_REPORTS.items()}


# ---------------------------------------------------------------------------
# pre-flight memory estimate
# ---------------------------------------------------------------------------

def _var_nbytes(shape, dtype, batch: int) -> int:
    n = 1
    for d in shape:
        n *= batch if int(d) < 0 else max(int(d), 1)
    # np.dtype('bfloat16') raises without ml_dtypes registered; its width
    # is what matters here
    itemsize = 2 if str(dtype) == "bfloat16" else __import__(
        "numpy").dtype(dtype).itemsize
    return n * itemsize


def estimate_memory(program, feed_shapes: Optional[Dict[str, Any]] = None,
                    budget_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Static pre-flight device-memory estimate for ``program``: sums
    declared var shapes in block 0 (``-1`` batch dims resolved from
    ``feed_shapes``' leading dim, else 1) into parameter / feed /
    activation byte totals. A LOWER BOUND — XLA temps, donation aliasing
    and fusion are unknowable before the compile — but params +
    activations catch the common will-it-OOM case before paying a
    multi-minute compile for an OOM.

    Returns ``{param_bytes, feed_bytes, activation_bytes, total_bytes,
    budget_bytes, fits}`` (``fits`` is None when no budget applies, from
    the ``device_memory_budget_bytes`` flag unless passed here)."""
    feed_shapes = feed_shapes or {}
    if budget_bytes is None:
        budget_bytes = _flags.get_flag("device_memory_budget_bytes")
    batch = 1
    for shp in feed_shapes.values():
        if len(shp) and int(shp[0]) > 0:
            batch = int(shp[0])
            break
    param = feed = act = 0
    block = program.blocks[0]
    for name, var in block.vars.items():
        if var.shape is None or var.dtype is None:
            continue
        if name in feed_shapes:
            nb = _var_nbytes(feed_shapes[name], var.dtype, batch)
            feed += nb
        else:
            nb = _var_nbytes(var.shape, var.dtype, batch)
            if var.persistable:
                param += nb
            else:
                act += nb
    total = param + feed + act
    return {
        "param_bytes": param,
        "feed_bytes": feed,
        "activation_bytes": act,
        "total_bytes": total,
        "budget_bytes": int(budget_bytes),
        "fits": None if not budget_bytes else total <= budget_bytes,
    }


# cached hot value of the device_memory_budget_bytes flag so the
# executor's pre-compile check is one int compare when no budget is set
_mem_budget = 0


def memory_budget_bytes() -> int:
    return _mem_budget


def _sync_mem_budget(value):
    global _mem_budget
    _mem_budget = int(value)


def check_memory_budget(program, feed_shapes: Optional[Dict] = None):
    """Pre-compile budget gate: estimate and warn when over. Returns the
    estimate (or None when no budget is configured). Never raises."""
    if _mem_budget <= 0:
        return None
    try:
        est = estimate_memory(program, feed_shapes,
                              budget_bytes=_mem_budget)
    except Exception as e:
        warnings.warn(f"memory pre-flight failed: {e!r}", RuntimeWarning)
        return None
    if est["fits"] is False:
        warnings.warn(
            f"program{program._uid}: static memory estimate "
            f"{est['total_bytes']:,} B (params {est['param_bytes']:,} + "
            f"feeds {est['feed_bytes']:,} + activations "
            f"{est['activation_bytes']:,}) exceeds the "
            f"device_memory_budget_bytes flag ({_mem_budget:,} B) — "
            f"this compile is likely to OOM at run time",
            RuntimeWarning)
    return est


# ---------------------------------------------------------------------------
# live endpoint (/metrics /healthz /steps /compile)
# ---------------------------------------------------------------------------

_server = None
_server_thread: Optional[threading.Thread] = None
_server_started_ts = 0.0

# Route table served by "/" (the JSON index) — one source for the docs
# and the handler, so a new route cannot silently miss the index.
ROUTES: Dict[str, str] = {
    "/": "this JSON index of available routes",
    "/metrics": "Prometheus text exposition of the metrics registry "
                "(?fleet=1: merged cross-rank exposition, rank= labels)",
    "/healthz": "JSON liveness: status, telemetry state, uptime",
    "/steps": "JSON ring buffer of recent step records (?n= trims)",
    "/compile": "JSON latest compile report per program",
    "/numerics": "JSON numerics plane: NaN/Inf provenance + tensor stats",
    "/lint": "JSON static-verifier plane: latest lint record per program "
             "(501 in the port until analysis.py is ported)",
    "/trace": "Chrome-trace JSON timeline (Perfetto-loadable)",
    "/fleet": "JSON cluster view: per-rank digests, heartbeat ages, "
              "stragglers, OOM reports + the serving-fleet router "
              "section (per-replica state, queue depth, generation "
              "tag, last-heartbeat age) when a ServingFleet is live",
    "/profile": "JSON roofline plane: latest device profile per "
                "program (top ops, verdict, measured MFU) (501 in the "
                "port until roofline.py is ported)",
    "/serve": "JSON serving plane: per-engine slot/queue stats, token "
              "throughput, TTFT + per-token latency quantiles",
    "/requests": "JSON request plane: in-flight serving requests + the "
                 "recently-terminated ring (per-phase latency "
                 "breakdowns, deadline attribution, SLO accounting)",
}


# Routes whose plane the port has not yet: route -> the module it reads.
# They answer 501 and name it (ROADMAP lists the item that ports each).
UNPORTED_ROUTES: Dict[str, str] = {
    "/lint": "analysis.py",
    "/profile": "roofline.py",
}


def serve(port: Optional[int] = None, host: str = "127.0.0.1") -> int:
    """Start the observability HTTP server on a background daemon thread
    (idempotent; returns the bound port). ``port=0`` binds an ephemeral
    port — the test / multi-worker-per-host pattern. Routes:

    - ``/``         JSON index of every route (this table)
    - ``/metrics``  Prometheus text exposition of the registry;
      ``?fleet=1`` serves the merged cross-rank exposition instead
      (every rank's digest samples labelled ``rank=`` — fleet_monitor)
    - ``/healthz``  JSON liveness (status, telemetry state, uptime)
    - ``/steps``    JSON ring buffer of recent step records (``?n=``)
    - ``/compile``  JSON latest compile report per program
    - ``/numerics`` JSON numerics plane: NaN/Inf provenance records +
      latest decoded tensor stats per program (numerics.py)
    - ``/lint``     JSON static-verifier plane: latest lint record per
      program (mode, severity counts, findings — analysis.py)
    - ``/trace``    Chrome-trace JSON of the timeline ring (load it in
      Perfetto / chrome://tracing directly)
    - ``/fleet``    JSON cluster view: one row per rank (digest + phase
      breakdown + heartbeat age + dead flag) plus straggler records and
      OOM reports (fleet_monitor.py)
    - ``/profile``  JSON roofline plane: latest device profile per
      program — top ops by device seconds, roofline verdict, measured
      MFU (roofline.py)

    Binds localhost by default: metrics can carry program names — scrape
    through a sidecar or port-forward, don't expose it."""
    global _server, _server_thread, _server_started_ts
    if _server is not None:
        return _server.server_address[1]
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if port is None:
        port = _flags.get_flag("metrics_port")

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            path, _, query = self.path.partition("?")
            missing = UNPORTED_ROUTES.get(path)
            if missing is not None:
                self.send_error(501, f"{path} reads {missing}, which "
                                f"paddle_tpu_torch does not have yet")
                return
            try:
                if path in ("", "/"):
                    # JSON index: the zero-knowledge entry point — every
                    # route with a one-line description (previously 404)
                    body = json.dumps(
                        {"routes": ROUTES}, sort_keys=True).encode()
                    ctype = "application/json"
                elif path == "/metrics":
                    if "fleet=1" in query.split("&"):
                        # merged cross-rank exposition from the latest
                        # aggregated digests (lazy import:
                        # fleet_monitor.py imports monitor.py)
                        from paddle_tpu_torch import fleet_monitor as _fm

                        body = _fm.to_prometheus_fleet().encode()
                    else:
                        body = to_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/healthz":
                    # serving-engine lifecycle rows (serving/draining/
                    # closed) WITHOUT importing the serving plane into
                    # processes that never used it: a replica being
                    # rotated out must be visible to its health probe
                    # before its queue is torn down
                    srv = sys.modules.get("paddle_tpu_torch.serving")
                    body = json.dumps({
                        "status": "ok",
                        "telemetry": _enabled,
                        "uptime_s": time.time() - _server_started_ts,
                        "steps_buffered": len(_STEP_RING),
                        "stalls": len(_STALLS),
                        "engines": (srv.engine_states()
                                    if srv is not None else {}),
                    }).encode()
                    ctype = "application/json"
                elif path == "/steps":
                    n = None
                    for part in query.split("&"):
                        if part.startswith("n="):
                            n = int(part[2:])
                    body = json.dumps(recent_steps(n),
                                      default=str).encode()
                    ctype = "application/json"
                elif path == "/compile":
                    body = json.dumps(compile_reports(), sort_keys=True,
                                      default=str).encode()
                    ctype = "application/json"
                elif path == "/numerics":
                    # lazy import: numerics.py imports monitor.py
                    from paddle_tpu_torch import numerics as _numerics

                    body = json.dumps(_numerics.summary(), sort_keys=True,
                                      default=str).encode()
                    ctype = "application/json"
                elif path == "/trace":
                    body = json.dumps(trace_snapshot(),
                                      default=str).encode()
                    ctype = "application/json"
                elif path == "/fleet":
                    # lazy import: fleet_monitor.py imports monitor.py
                    from paddle_tpu_torch import fleet_monitor as _fm

                    view = _fm.cluster_view()
                    # serving-fleet rollup only when that plane is
                    # loaded (lazy — fleet_serving imports monitor)
                    fs = sys.modules.get("paddle_tpu_torch.fleet_serving")
                    if fs is not None:
                        sfleet = fs.fleet_view()
                        if sfleet is not None:
                            view = dict(view)
                            view["serving_fleet"] = sfleet
                    body = json.dumps(view, sort_keys=True,
                                      default=str).encode()
                    ctype = "application/json"
                elif path == "/serve":
                    # lazy import: serving.py imports monitor.py
                    from paddle_tpu_torch import serving as _serving

                    body = json.dumps(_serving.summary(),
                                      sort_keys=True,
                                      default=str).encode()
                    ctype = "application/json"
                elif path == "/requests":
                    # lazy import: serving_trace.py imports monitor.py
                    # (it reads the serving plane via sys.modules, so a
                    # process that never served answers an empty view)
                    from paddle_tpu_torch import serving_trace as _strace

                    body = json.dumps(_strace.requests_view(),
                                      sort_keys=True,
                                      default=str).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
            except Exception as e:  # surface as 500, never kill the thread
                self.send_error(500, str(e))
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapes every few seconds —
            pass                       # stderr noise helps nobody

    _server = ThreadingHTTPServer((host, int(port)), _Handler)
    _server.daemon_threads = True
    _server_started_ts = time.time()
    _server_thread = threading.Thread(
        target=_server.serve_forever, name="pt-monitor-http", daemon=True)
    _server_thread.start()
    _sync_trace_on()  # a live /trace route makes the timeline visible
    return _server.server_address[1]


def server_address() -> Optional[Tuple[str, int]]:
    return None if _server is None else tuple(_server.server_address[:2])


def stop_server():
    global _server, _server_thread
    srv, _server = _server, None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if _server_thread is not None:
        _server_thread.join(timeout=5)
        _server_thread = None
    _sync_trace_on()


def _maybe_autostart_server(_value=None):
    """Flag watcher: bring the server up once `telemetry` is on and
    `metrics_port` is nonzero, whichever flips last."""
    port = _flags.get_flag("metrics_port")
    if _enabled and port > 0 and _server is None:
        try:
            serve(port)
        except OSError as e:
            warnings.warn(
                f"metrics server failed to bind port {port}: {e!r}",
                RuntimeWarning)


# ---------------------------------------------------------------------------
# stall watchdog
# ---------------------------------------------------------------------------

STALL_RECORD_SCHEMA_VERSION = 1

_STALLS: collections.deque = collections.deque(maxlen=32)
_stall_seq = 0
# each guard's watchdog is its own timer thread: concurrent stalls (one
# peer death stalls several sites at once) must not share a seq or
# overwrite each other's flight-recorder dump
_STALL_LOCK = threading.Lock()

_M_STALLS = None


def _stall_counter():
    global _M_STALLS
    if _M_STALLS is None:
        _M_STALLS = counter(
            "pt_stall_total",
            "guarded collective sections that exceeded their watchdog "
            "deadline, by site")
    return _M_STALLS


# cached hot value of stall_timeout_ms (same pattern as `telemetry`)
_stall_ms = 0


def _sync_stall_ms(value):
    global _stall_ms
    _stall_ms = int(value)


_NULL_CTX = contextlib.nullcontext()


def stall_guard(name: str, deadline_ms: Optional[float] = None):
    """Watchdog context for a blocking collective (barrier, rendezvous,
    multi-host dispatch). If the body outlives the deadline (the
    ``stall_timeout_ms`` flag unless given here), a timer thread fires
    ONCE: ``pt_stall_total{site=name}`` increments, a structured stall
    record (site, deadline, the arming thread's active span stack, the
    last step record) is buffered + warned, and — when the
    ``stall_dump_dir`` flag is set — the flight recorder (stall record,
    step ring buffer, full metrics snapshot) is dumped to disk. The body
    is never interrupted: a watchdog that kills a slow-but-alive
    collective would convert stragglers into crashes.

    Disabled (telemetry off, or no deadline anywhere) this returns a
    shared nullcontext — one boolean/int check, zero allocations."""
    if not _enabled:
        return _NULL_CTX
    ms = _stall_ms if deadline_ms is None else deadline_ms
    if ms <= 0:
        return _NULL_CTX
    return _StallGuard(name, float(ms))


class _StallGuard:
    __slots__ = ("name", "ms", "_timer")

    def __init__(self, name: str, ms: float):
        self.name = name
        self.ms = ms

    def __enter__(self):
        self._timer = threading.Timer(
            self.ms / 1e3, _record_stall,
            args=(self.name, self.ms, threading.current_thread().name,
                  span_stack()))
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        self._timer.cancel()
        return False


def _record_stall(site: str, deadline_ms: float, thread_name: str,
                  spans: Tuple[str, ...]):
    """Runs on the watchdog timer thread. Never raises."""
    global _stall_seq
    try:
        last_steps = recent_steps(1)
        with _STALL_LOCK:
            seq = _stall_seq
            _stall_seq += 1
        rec = {
            "v": STALL_RECORD_SCHEMA_VERSION,
            "ts": time.time(),
            "seq": seq,
            "site": site,
            "deadline_ms": deadline_ms,
            "thread": thread_name,
            "span_stack": list(spans),
            "last_step": last_steps[0] if last_steps else None,
        }
        _STALLS.append(rec)
        _stall_counter().inc(labels={"site": site})
        trace_event(f"stall:{site}", "stall", time.perf_counter(),
                    args={"deadline_ms": deadline_ms, "thread": thread_name,
                          "span_stack": list(spans)})
        warnings.warn(
            f"stall watchdog: {site!r} exceeded {deadline_ms:.0f} ms "
            f"(thread {thread_name}, spans {list(spans)}); the section "
            f"is still blocked", RuntimeWarning)
        dump_dir = _flags.get_flag("stall_dump_dir")
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)
            path = os.path.join(
                dump_dir, f"stall-{rec['seq']}-{int(rec['ts'])}.json")
            dump = {
                "stall": rec,
                "steps": recent_steps(),
                "metrics": snapshot(),
                "compile_reports": compile_reports(),
                "oom_reports": oom_records(),
            }
            # a multi-host stall is often a straggler: attach the fleet
            # plane's latest cluster view + straggler records when the
            # plane is loaded (lazy — fleet_monitor imports monitor)
            import sys as _sys
            fm = _sys.modules.get("paddle_tpu_torch.fleet_monitor")
            if fm is not None:
                dump["fleet"] = fm.summary()
            with open(path, "w") as f:
                json.dump(dump, f, sort_keys=True, indent=1, default=str)
    except Exception as e:
        try:
            warnings.warn(f"stall record dropped: {e!r}", RuntimeWarning)
        except Exception:
            pass


def stalls() -> List[Dict[str, Any]]:
    """Buffered stall records, oldest first."""
    return [dict(r) for r in _STALLS]


# ---------------------------------------------------------------------------
# fleet digest schema (assembly/aggregation: fleet_monitor.py)
# ---------------------------------------------------------------------------

FLEET_DIGEST_SCHEMA_VERSION = 1

# field name -> (accepted types, required, doc). One digest per worker,
# published into fleet KV under fleet/metrics/g<gen>/<rank> and
# aggregated by rank 0 into the /fleet cluster view. Compact on
# purpose: counters/gauges carry values, histograms only sum/count —
# full buckets stay on each worker's own /metrics. Bump the version on
# any incompatible change.
FLEET_DIGEST_FIELDS: Dict[str, tuple] = {
    "v": ((int,), True, "schema version (FLEET_DIGEST_SCHEMA_VERSION)"),
    "ts": ((float, int), True,
           "wall-clock unix timestamp of the publish (heartbeat-age "
           "anchor: the aggregator marks a rank dead when now - ts "
           "exceeds the staleness window)"),
    "seq": ((int,), True, "per-process publish sequence number"),
    "rank": ((int,), True, "fleet worker index of the publisher"),
    "world": ((int,), True, "fleet worker count at publish time"),
    "gen": ((int,), True, "elastic-resize generation (fleet PT_GEN)"),
    "host": ((str,), True, "publisher hostname (short form)"),
    "pid": ((int,), True, "publisher process id"),
    "counters": ((dict,), True,
                 "counter name -> [{labels, value}] cells"),
    "gauges": ((dict,), True, "gauge name -> [{labels, value}] cells"),
    "hists": ((dict,), True,
              "histogram name -> [{labels, sum, count}] cells (no "
              "buckets — the digest stays KV-sized)"),
    "last_step": ((dict, type(None)), True,
                  "the publisher's most recent step record "
                  "(STEP_LOG_FIELDS schema, phases + verdict included) "
                  "or null before the first step"),
    "bound": ((dict, type(None)), True,
              "latest boundedness verdict ({verdict, shares, steps}) "
              "or null"),
    "step_wall_ms": ((float, int, type(None)), True,
                     "median wall_ms over the trailing step-record "
                     "window — median, so one compile-inflated warmup "
                     "step cannot skew the straggler detector's "
                     "per-rank signal"),
    "phases_ms": ((dict, type(None)), True,
                  "median per-phase ms over the trailing window (phase "
                  "-> ms) or null when no attributed steps landed yet"),
    "steps": ((int,), True,
              "pt_executor_steps_total at publish time (bounds straggler "
              "detection latency in steps)"),
    "roofline": ((dict, type(None)), False,
                 "per-program roofline rollup from the device-profile "
                 "plane: program -> {measured_mfu, verdict, source} "
                 "(roofline.digest_section); absent before the first "
                 "profile — optional, schema stays v1"),
    "serving": ((dict, type(None)), False,
                "per-replica serving rollup from the request plane: "
                "engine rows (state, queue depth, active slots, token "
                "EWMA) + TTFT/token latency quantiles + SLO counts "
                "(serving_trace.digest_section); absent on ranks that "
                "never served — optional, schema stays v1"),
}


def validate_fleet_digest(rec: Dict[str, Any]):
    """Raise ValueError unless ``rec`` conforms to FLEET_DIGEST_FIELDS."""
    _validate_fields(rec, FLEET_DIGEST_FIELDS,
                     FLEET_DIGEST_SCHEMA_VERSION, "fleet digest")


# Straggler records ({v, ts, rank, phase, step_wall_ms, median_wall_ms,
# factor, steps, world, deltas_ms}) are produced by fleet_monitor's
# cross-rank skew detector; the version lives here with the other
# telemetry schemas (the stall-record precedent: version constant, doc
# in the producing module).
STRAGGLER_RECORD_SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# device-memory watermarks
# ---------------------------------------------------------------------------

_M_DEV_IN_USE = None
_M_DEV_PEAK = None


def _devmem_instruments():
    global _M_DEV_IN_USE, _M_DEV_PEAK
    if _M_DEV_IN_USE is None:
        _M_DEV_IN_USE = gauge(
            "pt_device_bytes_in_use",
            "device memory in use at the last sampled step, by device "
            "(guarded Device.memory_stats(); absent on backends without "
            "the API)")
        _M_DEV_PEAK = gauge(
            "pt_device_bytes_peak",
            "device-memory high-water mark reported at the last sampled "
            "step, by device (guarded Device.memory_stats())")


# cached hot value of device_memory_every_n_steps (0 = off); sampling
# additionally needs telemetry on
_devmem_every = 0


def _sync_devmem_every(value):
    global _devmem_every
    _devmem_every = int(value)


def devmem_active() -> bool:
    """Whether executors should sample device-memory watermarks."""
    return _enabled and _devmem_every > 0


def device_memory() -> Dict[str, Dict[str, int]]:
    """Guarded read of every visible CUDA device's caching-allocator
    statistics: ``{"cuda:N": {bytes_in_use, peak_bytes}}``, empty on the
    CPU and before CUDA is initialized. Host-side allocator state: it
    makes no CUDA call (safe beside another thread's graph capture).
    Never raises."""
    out: Dict[str, Dict[str, int]] = {}
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return out
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            cell: Dict[str, int] = {}
            in_use = stats.get("allocated_bytes.all.current")
            peak = stats.get("allocated_bytes.all.peak")
            if in_use is not None:
                cell["bytes_in_use"] = int(in_use)
            if peak is not None:
                cell["peak_bytes"] = int(peak)
            if cell:
                out[f"cuda:{i}"] = cell
    except Exception:
        pass  # watermarks are strictly best-effort
    return out


def sample_device_memory(step: int, steps: int = 1):
    """Sample device-memory watermarks into the
    ``pt_device_bytes_in_use/peak{device=}`` gauges when the
    ``device_memory_every_n_steps`` period has a sample point inside
    ``[step, step + steps)`` (the trace_step_sampled convention, so
    run_steps windows sample whenever any inner step would). No-op —
    one int check — while telemetry is off or the period is 0; degrades
    silently on backends without ``Device.memory_stats()``."""
    if not _enabled or _devmem_every <= 0:
        return
    if _devmem_every > 1 and (-step) % _devmem_every >= steps:
        return
    _devmem_instruments()
    for dev, cell in device_memory().items():
        if "bytes_in_use" in cell:
            _M_DEV_IN_USE.set(cell["bytes_in_use"], labels={"device": dev})
        if "peak_bytes" in cell:
            _M_DEV_PEAK.set(cell["peak_bytes"], labels={"device": dev})


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

OOM_REPORT_SCHEMA_VERSION = 1

# field name -> (accepted types, required, doc); the report an operator
# reads AFTER a device OOM killed the step — what was the high-water
# estimate, what was the budget, what was live, what were the last steps.
OOM_REPORT_FIELDS: Dict[str, tuple] = {
    "v": ((int,), True, "schema version (OOM_REPORT_SCHEMA_VERSION)"),
    "ts": ((float, int), True, "wall-clock unix timestamp of the OOM"),
    "seq": ((int,), True, "process-wide OOM report sequence number"),
    "phase": ((str,), True,
              "'compile' (OOM while building the executable) or 'run' "
              "(OOM while executing a step)"),
    "program": ((str, type(None)), True,
                "program id ('program<uid>') or null"),
    "error": ((str,), True, "the failure message (truncated)"),
    "budget_bytes": ((int,), True,
                     "the device_memory_budget_bytes flag at OOM time "
                     "(0 = no budget configured)"),
    "compile_peak_bytes": ((int, type(None)), True,
                           "peak-bytes estimate from the program's "
                           "latest compile report, or null when no "
                           "report exists"),
    "device_memory": ((dict,), True,
                      "per-device {bytes_in_use, peak_bytes} watermarks "
                      "at OOM time (empty when the API is absent)"),
    "largest_buffers": ((list,), True,
                        "largest live device buffers, descending: "
                        "[{nbytes, shape, dtype}] (best-effort: the "
                        "CUDA caching allocator's largest live blocks, "
                        "shape [nbytes] and dtype 'uint8')"),
    "last_steps": ((list,), True,
                   "trailing step records from the flight recorder"),
}

_OOM_RECORDS: collections.deque = collections.deque(maxlen=8)
_oom_seq = 0

_M_OOM = None


def _oom_counter():
    global _M_OOM
    if _M_OOM is None:
        _M_OOM = counter(
            "pt_oom_events_total",
            "RESOURCE_EXHAUSTED failures captured by the OOM forensics "
            "hook, by phase (compile/run/fetch/prefetch/serve)")
    return _M_OOM


# CUDA's allocation-failure texts (the caching allocator's "CUDA out of
# memory", the runtime's cudaErrorMemoryAllocation): the JAX package's
# "Out of memory" match is case-sensitive and would miss the first
_CUDA_OOM_TEXTS = ("CUDA out of memory", "out of memory",
                   "cudaErrorMemoryAllocation")


def is_oom_error(exc) -> bool:
    """Whether ``exc`` is a device out-of-memory failure: a
    ``torch.OutOfMemoryError``, CUDA's allocation-failure text, or the
    JAX package's ``RESOURCE_EXHAUSTED`` / ``Out of memory`` text that
    fault plans raise."""
    oom_type = getattr(sys.modules.get("torch"), "OutOfMemoryError", None)
    if oom_type is not None and isinstance(exc, oom_type):
        return True
    msg = f"{type(exc).__name__}: {exc}"
    return ("RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg
            or any(t in msg for t in _CUDA_OOM_TEXTS))


def _largest_live_buffers(n: int = 10) -> List[Dict[str, Any]]:
    """The CUDA caching allocator's largest live (allocated) blocks,
    descending; empty on the CPU. Reads the allocator's snapshot, which
    is host-side state."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return []
        blocks = []
        for seg in torch.cuda.memory_snapshot():
            for blk in seg.get("blocks", ()):
                if blk.get("state") == "active_allocated":
                    nb = int(blk.get("size", 0))
                    blocks.append({"nbytes": nb, "shape": (nb,),
                                   "dtype": "uint8",
                                   "device": f"cuda:{seg.get('device', 0)}"})
        blocks.sort(key=lambda c: -c["nbytes"])
        return blocks[:n]
    except Exception:
        return []


def maybe_record_oom(exc, program=None, phase: str = "run"):
    """OOM forensics hook: when telemetry is on and ``exc`` is a device
    OOM, assemble a report (compile-report peak vs the memory-budget
    flag, largest live buffers, device watermarks, trailing step
    records), buffer it, count ``pt_oom_events_total{phase=}`` and —
    when ``stall_dump_dir`` is set — dump it as
    ``oom-<seq>-<ts>.json``. Never raises and never swallows: callers
    re-raise the original failure."""
    global _oom_seq
    if not _enabled or not is_oom_error(exc):
        return
    try:
        prog = None if program is None else f"program{program._uid}"
        report = None
        if prog is not None:
            report = compile_reports().get(prog)
        with _LOCK:
            seq = _oom_seq
            _oom_seq += 1
        rec = {
            "v": OOM_REPORT_SCHEMA_VERSION,
            "ts": time.time(),
            "seq": seq,
            "phase": str(phase),
            "program": prog,
            "error": f"{type(exc).__name__}: {exc}"[:2000],
            "budget_bytes": int(_mem_budget),
            "compile_peak_bytes": (None if report is None
                                   else report.get("peak_bytes")),
            "device_memory": device_memory(),
            "largest_buffers": _largest_live_buffers(),
            "last_steps": recent_steps(8),
        }
        _OOM_RECORDS.append(rec)
        _oom_counter().inc(labels={"phase": str(phase)})
        warnings.warn(
            f"device OOM during {phase} of {prog or 'a program'}: "
            f"compile-report peak "
            f"{rec['compile_peak_bytes'] or 'unknown'} B vs budget "
            f"{_mem_budget or 'unset'} B — forensics report buffered"
            + (f" and dumped under "
               f"{_flags.get_flag('stall_dump_dir')!r}"
               if _flags.get_flag("stall_dump_dir") else ""),
            RuntimeWarning)
        dump_dir = _flags.get_flag("stall_dump_dir")
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)
            path = os.path.join(
                dump_dir, f"oom-{seq}-{int(rec['ts'])}.json")
            with open(path, "w") as f:
                json.dump(rec, f, sort_keys=True, indent=1, default=str)
    except Exception as e:
        try:
            warnings.warn(f"OOM report dropped: {e!r}", RuntimeWarning)
        except Exception:
            pass


def oom_records() -> List[Dict[str, Any]]:
    """Buffered OOM forensics reports, oldest first."""
    return [dict(r) for r in _OOM_RECORDS]


def validate_oom_report(rec: Dict[str, Any]):
    """Raise ValueError unless ``rec`` conforms to OOM_REPORT_FIELDS."""
    _validate_fields(rec, OOM_REPORT_FIELDS,
                     OOM_REPORT_SCHEMA_VERSION, "OOM report")


# ---------------------------------------------------------------------------
# time attribution: step phases + boundedness verdict
# ---------------------------------------------------------------------------

# Phase names, in execution order. The executor measures each with
# perf_counter pairs; the semantics are documented in STEP_LOG_FIELDS
# ('phases') and README "Step-time attribution & traces".
STEP_PHASES = ("feed", "dispatch", "device", "fetch")

BOUND_VERDICTS = ("input_bound", "dispatch_bound", "device_bound")

# Rolling verdict window: per-step (input, dispatch, device) scores of
# the last N steps. Small on purpose — the verdict should track the
# CURRENT bottleneck, not average a warmup compile into steady state.
BOUND_WINDOW = 16

_M_STEP_PHASE = None
_M_STEP_BOUND = None
_M_READER_DEPTH = None
_M_READER_WAIT = None
_M_FEED_BUILD = None
_M_PREFETCH_DEPTH = None
_M_FETCH_OVERLAP = None


def _phase_instruments():
    global _M_STEP_PHASE, _M_STEP_BOUND, _M_READER_DEPTH, _M_READER_WAIT
    global _M_FEED_BUILD, _M_PREFETCH_DEPTH, _M_FETCH_OVERLAP
    if _M_STEP_PHASE is None:
        _M_STEP_PHASE = histogram(
            "pt_step_phase_seconds",
            "per-step executor time attribution, by phase (feed = "
            "host->device staging, dispatch = Python + tracing "
            "overhead, device = delta to block_until_ready, fetch = "
            "device->host + decode)")
        _M_STEP_BOUND = counter(
            "pt_step_bound_total",
            "steps attributed to each boundedness verdict over the "
            "trailing window (input_bound / dispatch_bound / "
            "device_bound)")
        _M_READER_DEPTH = gauge(
            "pt_reader_queue_depth",
            "input-pipeline queue depth after the latest put/get, by "
            "site (buffered, xmap_in, xmap_out, multiprocess, "
            "device_loader)")
        _M_READER_WAIT = histogram(
            "pt_reader_wait_seconds",
            "time blocked on input-pipeline queues, by site and role "
            "(producer = queue full, downstream slow; consumer = queue "
            "empty, input-bound)")
        _M_FEED_BUILD = histogram(
            "pt_feed_build_seconds",
            "DataFeeder.feed batch-assembly time (host input prep on "
            "the critical path)")
        _M_PREFETCH_DEPTH = gauge(
            "pt_prefetch_depth",
            "configured device-feed prefetch depth of the most recently "
            "started DeviceLoader iteration")
        _M_FETCH_OVERLAP = histogram(
            "pt_fetch_overlap_seconds",
            "async-fetch overlap window: time between a step's deferred "
            "device->host fetch being issued and its materialization")


# cached hot gate for the executor's phase marks: telemetry on AND the
# step_phases flag (default True). Separate from `telemetry` because the
# device phase needs a per-step block_until_ready — honest attribution
# costs the async-dispatch overlap, and metrics-only users can opt out.
_phases_on = False
# cached step_phases_every_n: the sampling period bounding how often a
# step pays that sync — unsampled steps dispatch fully async
_phases_every = 16


def phases_active() -> bool:
    """Whether executors should measure per-step phases (telemetry on
    and the ``step_phases`` flag set)."""
    return _phases_on


def phases_sampled(step: int, steps: int = 1) -> bool:
    """Whether the phase plane samples ``[step, step + steps)``: phases
    active AND the ``step_phases_every_n`` period has a sample point
    inside the interval (same no-aliasing window rule as
    ``trace_step_sampled``). Only sampled steps pay the per-step
    ``block_until_ready``; unsampled steps dispatch fully async and log
    ``sampled: false`` records without phases."""
    if not _phases_on:
        return False
    if _phases_every <= 1:
        return True
    return (-step) % _phases_every < steps


def _sync_phases_on(_value=None):
    global _phases_on, _input_wait_s
    was = _phases_on
    _phases_on = _enabled and bool(_flags.get_flag("step_phases"))
    if _phases_on and not was:
        # waits accumulated while nobody was draining (phases off, or a
        # failed-step run) must not dump into the first attributed
        # step's input score and pin the verdict to input_bound
        with _BOUND_LOCK:
            _input_wait_s = 0.0


def _sync_phases_every(value):
    global _phases_every
    _phases_every = int(value)


# input-wait accumulator: reader consumer waits + feed-build time since
# the last executor step, drained into that step's verdict scores
_BOUND_LOCK = threading.Lock()
_input_wait_s = 0.0
_bound_window: collections.deque = collections.deque(maxlen=BOUND_WINDOW)
_last_bound: Optional[Dict[str, Any]] = None


def note_input_wait(seconds: float):
    """Accumulate input-pipeline time (a consumer wait on a reader
    queue, or batch-assembly time) toward the NEXT step's boundedness
    verdict. Gated on ``phases_active()`` — with nobody draining the
    accumulator (phases off), accumulation would only grow a stale
    backlog."""
    global _input_wait_s
    if not _phases_on:
        return
    with _BOUND_LOCK:
        _input_wait_s += seconds


def discard_input_wait():
    """Drop input waits accumulated since the last drain. Executors
    call this after an UNSAMPLED step (``step_phases_every_n``): the
    next sampled step must score only ITS OWN input time — draining a
    whole sampling period's backlog into one step would inflate the
    input share by the period length."""
    global _input_wait_s
    if not _phases_on:
        return
    with _BOUND_LOCK:
        _input_wait_s = 0.0


def reader_wait(site: str, role: str, seconds: float):
    """Record one blocked queue operation from the input pipeline
    (``role``: 'producer' = put blocked on a full queue, 'consumer' =
    get blocked on an empty one). Consumer waits additionally count
    toward the boundedness verdict — a step that waited on its reader
    is input-bound no matter how busy the device was afterwards."""
    if not _enabled:
        return
    _M_READER_WAIT.observe(seconds, labels={"site": site, "role": role})
    if role == "consumer":
        note_input_wait(seconds)


def reader_depth(site: str, depth: int):
    """Gauge the queue depth observed after a put/get at ``site``."""
    if not _enabled:
        return
    _M_READER_DEPTH.set(depth, labels={"site": site})


def feed_build(seconds: float, critical_path: bool = True):
    """Record one DataFeeder.feed batch assembly (host input prep);
    counts toward the boundedness verdict's input score unless
    ``critical_path=False`` (a prefetch worker building batches off the
    step loop — overlapped assembly time must not fake an input_bound
    verdict; the consumer's queue wait is the honest signal there)."""
    if not _enabled:
        return
    _M_FEED_BUILD.observe(seconds)
    if critical_path:
        note_input_wait(seconds)


def prefetch_depth(depth: int):
    """Gauge the configured depth of a starting DeviceLoader iteration."""
    if not _enabled:
        return
    _M_PREFETCH_DEPTH.set(depth)


def fetch_overlap(seconds: float):
    """Record one async-fetch overlap window: issue -> materialization
    of a step's deferred device->host fetch."""
    if not _enabled:
        return
    _M_FETCH_OVERLAP.observe(seconds)


def timed_put(q, item, site: str):
    """``q.put(item)`` with producer-wait + depth telemetry for queue
    ``site`` (a plain put while telemetry is off) — the one shared
    instrumentation point for every reader-pipeline queue
    (``timed_put_stoppable`` is its stop-aware twin)."""
    if not _enabled:
        q.put(item)
        return
    t0 = time.perf_counter()
    q.put(item)
    reader_wait(site, "producer", time.perf_counter() - t0)
    reader_depth(site, q.qsize())


def timed_put_stoppable(q, item, stop, site: str,
                        poll_s: float = 0.1) -> bool:
    """``q.put(item)`` that gives up when ``stop`` is set; returns
    whether the item was enqueued. The stop-aware variant of
    ``timed_put`` (same producer-wait + depth telemetry, one
    instrumentation point) for prefetch workers whose consumer may
    abandon them — ``poll_s`` bounds how long a blocked put takes to
    observe the stop request."""
    t0 = time.perf_counter() if _enabled else 0.0
    while not stop.is_set():
        try:
            q.put(item, timeout=poll_s)
        except queue.Full:
            continue
        if t0:
            reader_wait(site, "producer", time.perf_counter() - t0)
            reader_depth(site, q.qsize())
        return True
    return False


def timed_get(q, site: str):
    """``q.get()`` with consumer-wait + depth telemetry for queue
    ``site`` (consumer waits weigh into the boundedness verdict)."""
    if not _enabled:
        return q.get()
    t0 = time.perf_counter()
    item = q.get()
    reader_wait(site, "consumer", time.perf_counter() - t0)
    reader_depth(site, q.qsize())
    return item


def record_step_phases(feed_s: float, dispatch_s: float, device_s: float,
                       fetch_s: float, scored: bool = True
                       ) -> Optional[str]:
    """Record one step's phase breakdown: observes the
    ``pt_step_phase_seconds`` histograms, drains the input-wait
    accumulator into this step, pushes the scores into the rolling
    verdict window and returns the window's verdict (also counted into
    ``pt_step_bound_total{verdict=}``).

    ``scored=False`` (a fresh-compile / disk-load step): the histograms
    still observe the honest phase durations, but the step stays OUT of
    the verdict window — a compile's host time would pollute the
    dispatch share of the next BOUND_WINDOW sampled steps — and its
    accumulated input waits are discarded rather than dumped into the
    next scored step. Returns None for unscored steps.

    Verdict scoring: ``input`` = reader consumer waits + feed-build
    time since the last step + the feed phase (host->device staging is
    the input pipeline's device half); ``dispatch`` = dispatch + fetch
    (host overhead around the device call); ``device`` = the device
    phase. The largest share over the window names the bottleneck."""
    global _last_bound, _input_wait_s
    if not _enabled:
        return None
    _M_STEP_PHASE.observe(feed_s, labels={"phase": "feed"})
    _M_STEP_PHASE.observe(dispatch_s, labels={"phase": "dispatch"})
    _M_STEP_PHASE.observe(device_s, labels={"phase": "device"})
    _M_STEP_PHASE.observe(fetch_s, labels={"phase": "fetch"})
    if not scored:
        with _BOUND_LOCK:
            _input_wait_s = 0.0
        return None
    with _BOUND_LOCK:
        input_s = _input_wait_s + feed_s
        _input_wait_s = 0.0
        _bound_window.append((input_s, dispatch_s + fetch_s, device_s))
        sums = [sum(col) for col in zip(*_bound_window)]
        total = sum(sums) or 1.0
        scores = dict(zip(("input", "dispatch", "device"), sums))
        verdict = BOUND_VERDICTS[sums.index(max(sums))]
        _last_bound = {
            "verdict": verdict,
            "shares": {k: v / total for k, v in scores.items()},
            "steps": len(_bound_window),
        }
    _M_STEP_BOUND.inc(labels={"verdict": verdict})
    return verdict


def boundedness() -> Optional[Dict[str, Any]]:
    """Latest boundedness verdict: ``{verdict, shares: {input,
    dispatch, device}, steps}`` over the trailing window, or None before
    the first telemetry-on step."""
    with _BOUND_LOCK:
        if _last_bound is None:
            return None
        return {"verdict": _last_bound["verdict"],
                "shares": dict(_last_bound["shares"]),
                "steps": _last_bound["steps"]}


# ---------------------------------------------------------------------------
# trace-event timeline (Chrome trace / Perfetto)
# ---------------------------------------------------------------------------

TRACE_SCHEMA_VERSION = 1

# The memory contract: a week-long job buffers the same trailing window
# as a smoke test. At ~120 B/event this is ~1 MB.
TRACE_RING_CAPACITY = 8192

# One clock for every event: perf_counter intervals anchored ONCE to the
# wall clock at import. ts values are unix-epoch microseconds (what
# Perfetto expects), but their DELTAS are monotonic perf_counter deltas
# — a wall-clock step (NTP slew) can never reorder or stretch the
# timeline within a process.
_TRACE_ANCHOR_PERF = time.perf_counter()
_TRACE_ANCHOR_UNIX = time.time()

# Synthetic track (tid) per event category, so spans, step phases,
# compiles and stalls render as distinct rows instead of interleaving on
# the emitting thread's row. Names are exported as thread_name metadata.
TRACE_TRACKS = {
    "span": (1, "host spans"),
    "phase": (2, "step phases"),
    "compile": (3, "compiles"),
    "stall": (4, "stalls"),
    "profiler": (5, "profiler"),
}

_TRACE_LOCK = threading.Lock()
_TRACE_RING: collections.deque = collections.deque(
    maxlen=TRACE_RING_CAPACITY)

# Dynamic per-request tracks (serving_trace.py): tids at or above this
# base are allocated at runtime and labelled via trace_register_track;
# the registry is bounded so the snapshot's metadata block stays small
# when a server churns through many requests (an aged-out track keeps
# its events — only the thread_name label is dropped).
REQUEST_TRACK_BASE = 32
_DYN_TRACK_CAP = 128
_DYN_TRACKS: "collections.OrderedDict[int, str]" = collections.OrderedDict()


def trace_register_track(tid: int, name: str):
    """Label a dynamically allocated track: exported as thread_name
    metadata in ``trace_snapshot``. No-op while tracing is inactive;
    re-registering a tid replaces its label (tracks are recycled
    round-robin by the request plane)."""
    if not _trace_on:
        return
    tid = int(tid)
    with _TRACE_LOCK:
        _DYN_TRACKS[tid] = str(name)
        _DYN_TRACKS.move_to_end(tid)
        while len(_DYN_TRACKS) > _DYN_TRACK_CAP:
            _DYN_TRACKS.popitem(last=False)

# cached hot gate: telemetry on AND someone can see the trace (trace_dir
# configured or the live endpoint up) — same visibility rule as compile
# reports, so tracing is never on by accident
_trace_on = False
_trace_every = 1
_trace_rank = 0
_HOSTNAME = (os.environ.get("HOSTNAME") or "host").split(".")[0]

_M_TRACE_EVENTS = None
_M_TRACE_DROPPED = None


def _trace_instruments():
    global _M_TRACE_EVENTS, _M_TRACE_DROPPED
    if _M_TRACE_EVENTS is None:
        _M_TRACE_EVENTS = counter(
            "pt_trace_events_total",
            "trace events appended to the timeline ring")
        _M_TRACE_DROPPED = counter(
            "pt_trace_events_dropped_total",
            "oldest trace events evicted by the bounded ring")


def trace_active() -> bool:
    """True when trace events are being collected: telemetry on AND
    (``trace_dir`` configured or the live endpoint running)."""
    return _trace_on


def trace_step_sampled(step: int, steps: int = 1) -> bool:
    """Gate for per-step phase trace events: tracing active and the
    ``trace_every_n_steps`` period has a sample point inside
    ``[step, step + steps)`` — so a run_steps window is sampled whenever
    ANY of its steps would be, instead of aliasing the window stride
    against the period."""
    if not _trace_on:
        return False
    if _trace_every <= 1:
        return True
    return (-step) % _trace_every < steps


def _ts_us(t_perf: float) -> float:
    return (_TRACE_ANCHOR_UNIX + (t_perf - _TRACE_ANCHOR_PERF)) * 1e6


def trace_event(name: str, cat: str, t0: float,
                t1: Optional[float] = None,
                args: Optional[Dict[str, Any]] = None,
                tid: Optional[int] = None):
    """Append one event to the timeline ring (no-op unless
    ``trace_active()``). ``t0``/``t1`` are ``time.perf_counter``
    readings: a pair makes a complete ('X') event with a duration, a
    lone ``t0`` an instant ('i') event. ``tid`` overrides the
    category's synthetic track — the request plane lands a request's
    whole life on one dynamic track this way. Never raises — telemetry
    must not fail a step."""
    if not _trace_on:
        return
    ev: Dict[str, Any] = {
        "name": name,
        "cat": cat,
        "ph": "X" if t1 is not None else "i",
        "ts": _ts_us(t0),
        "pid": os.getpid(),
        "tid": (TRACE_TRACKS.get(cat, (0, ""))[0] if tid is None
                else int(tid)),
    }
    if t1 is not None:
        ev["dur"] = max(t1 - t0, 0.0) * 1e6
    else:
        ev["s"] = "p"  # instant events span the process track
    if args:
        ev["args"] = args
    with _TRACE_LOCK:
        dropped = len(_TRACE_RING) == TRACE_RING_CAPACITY
        _TRACE_RING.append(ev)
    _M_TRACE_EVENTS.inc()
    if dropped:
        _M_TRACE_DROPPED.inc()


def _emit_span_trace(name: str, t0: float, t1: float):
    """profiler.record_event trace hook target: every host span —
    monitor.span bodies AND legacy direct record_event callers — lands
    in the ring through this one function, on the profiler's clock."""
    trace_event(name, "span", t0, t1)


def _span_trace_hook():
    """Installed as profiler._trace_hook: returns the emit function
    while tracing is active, else None (one boolean check, no
    allocation — record_event sits on disabled hot paths)."""
    return _emit_span_trace if _trace_on else None


def set_trace_rank(rank: int):
    """Tag this process's exported trace with its fleet rank (called by
    fleet.init) so merge_traces lands its events on the right track."""
    global _trace_rank
    _trace_rank = int(rank)


def trace_events() -> List[Dict[str, Any]]:
    """Buffered trace events, ts-ordered (the ring is append-ordered
    per thread; sorting makes ts monotone per track)."""
    with _TRACE_LOCK:
        evs = [dict(e) for e in _TRACE_RING]
    evs.sort(key=lambda e: e["ts"])
    return evs


def trace_snapshot() -> Dict[str, Any]:
    """The exportable Chrome-trace JSON object: thread/process metadata
    events + the ts-sorted ring, plus a ``metadata`` block carrying the
    clock anchor and rank that merge_traces aligns on."""
    pid = os.getpid()
    meta_events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "ts": 0, "pid": pid, "tid": 0,
        "args": {"name": f"rank{_trace_rank} ({_HOSTNAME}:{pid})"},
    }]
    for _cat, (tid, label) in sorted(TRACE_TRACKS.items()):
        meta_events.append({
            "name": "thread_name", "ph": "M", "ts": 0, "pid": pid,
            "tid": tid, "args": {"name": label},
        })
    with _TRACE_LOCK:
        dyn = sorted(_DYN_TRACKS.items())
    for tid, label in dyn:
        meta_events.append({
            "name": "thread_name", "ph": "M", "ts": 0, "pid": pid,
            "tid": tid, "args": {"name": label},
        })
    return {
        "traceEvents": meta_events + trace_events(),
        "displayTimeUnit": "ms",
        "metadata": {
            "v": TRACE_SCHEMA_VERSION,
            "rank": _trace_rank,
            "host": _HOSTNAME,
            "os_pid": pid,
            "anchor_unix": _TRACE_ANCHOR_UNIX,
        },
    }


def export_trace(path: Optional[str] = None) -> Optional[str]:
    """Write the trace snapshot as JSON: to ``path`` when given, else
    as ``trace-<host>-<pid>.json`` under the ``trace_dir`` flag (None
    and no write when neither is set). Returns the written path."""
    if path is None:
        out_dir = _flags.get_flag("trace_dir")
        if not out_dir:
            return None
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"trace-{_HOSTNAME}-{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump(trace_snapshot(), f, default=str)
    return path


def merge_traces(traces: Iterable, out_path: Optional[str] = None,
                 offsets_us: Optional[Dict[int, float]] = None) -> Dict:
    """Combine per-process trace files (paths or already-loaded dicts)
    into ONE timeline: each worker's events move onto ``pid = rank``
    tracks (rank from the trace's metadata, falling back to input
    order) and timestamps align across processes.

    Clock-offset alignment: every export's ts values are anchored to
    that process's wall clock at import (``metadata.anchor_unix``), so
    NTP-synced hosts line up out of the box; a residual measured skew
    can be corrected per rank via ``offsets_us``. The merged timeline
    is rebased to start at 0 — a multi-worker stall reads as one gap
    across all rank tracks."""
    loaded = []
    seen_ranks = set()
    for i, t in enumerate(traces):
        if isinstance(t, str):
            with open(t) as f:
                t = json.load(f)
        meta = t.get("metadata") or {}
        rank = meta.get("rank")
        if rank is None or rank in seen_ranks:
            # collision/absence fallback: the smallest unused rank, so
            # two traces can never share a pid track (input order is
            # preserved for the well-tagged common case)
            rank = 0
            while rank in seen_ranks:
                rank += 1
        seen_ranks.add(rank)
        off = float((offsets_us or {}).get(rank, 0.0))
        loaded.append((rank, off, t))
    base = None
    for rank, off, t in loaded:
        for ev in t.get("traceEvents", ()):
            if ev.get("ph") != "M":
                ts = float(ev.get("ts", 0.0)) + off
                base = ts if base is None else min(base, ts)
    base = base or 0.0
    meta_events: List[Dict[str, Any]] = []
    data_events: List[Dict[str, Any]] = []
    for rank, off, t in loaded:
        for ev in t.get("traceEvents", ()):
            ev = dict(ev)
            ev["pid"] = rank
            if ev.get("ph") == "M":
                meta_events.append(ev)
            else:
                ev["ts"] = float(ev.get("ts", 0.0)) + off - base
                data_events.append(ev)
    data_events.sort(key=lambda e: e["ts"])
    merged = {
        "traceEvents": meta_events + data_events,
        "displayTimeUnit": "ms",
        "metadata": {
            "v": TRACE_SCHEMA_VERSION,
            "merged_ranks": sorted(seen_ranks),
        },
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(merged, f, default=str)
    return merged


def _sync_trace_on(_value=None):
    global _trace_on
    _trace_on = _enabled and (bool(_flags.get_flag("trace_dir"))
                              or _server is not None)


def _sync_trace_every(value):
    global _trace_every
    _trace_every = int(value)


def _dump_trace_at_exit():
    if _enabled and _flags.get_flag("trace_dir"):
        try:
            export_trace()
        except OSError:
            pass


atexit.register(_dump_trace_at_exit)


# Eagerly register monitor-owned instruments: a /metrics scrape (or the
# doc-coverage test) sees the full builtin set even before the first
# span/stall/compile happens.
_span_seconds = histogram(
    "pt_span_seconds", "host span durations by span name")
_overflow_total()
_stall_counter()
_compile_instruments()
_phase_instruments()
_trace_instruments()
_devmem_instruments()
_oom_counter()

# Route every profiler.record_event host span into the trace ring: the
# legacy profiler API and the new timeline share one clock and one
# event stream (the hook returns None while tracing is off, so the
# record_event disabled path stays a bare yield).
_profiler._trace_hook = _span_trace_hook

# register watchers last so the module is fully initialized when the
# immediate callbacks fire (env-set flags take effect at import)
_flags.watch_flag("telemetry", _sync_from_flags)
_flags.watch_flag("telemetry", _maybe_autostart_server)
_flags.watch_flag("telemetry", _sync_trace_on)
_flags.watch_flag("telemetry", _sync_phases_on)
_flags.watch_flag("step_phases", _sync_phases_on)
_flags.watch_flag("step_phases_every_n", _sync_phases_every)
_flags.watch_flag("metrics_port", _maybe_autostart_server)
_flags.watch_flag("trace_dir", _sync_trace_on)
_flags.watch_flag("trace_every_n_steps", _sync_trace_every)
_flags.watch_flag("device_memory_budget_bytes", _sync_mem_budget)
_flags.watch_flag("stall_timeout_ms", _sync_stall_ms)
_flags.watch_flag("device_memory_every_n_steps", _sync_devmem_every)
