"""Unified serve telemetry: metrics registry, request timelines, traces.

The paper's macro only ships because its analog MAC/ADC transfer curve is
*measured* — non-linearity compensation is calibrated from observed
behavior, not assumed.  This module is the serving-layer analog: every
scheduler decision, pool state change, and fault action the continuous
engine takes is observable through one subsystem instead of a growing pile
of hand-maintained counters.

Three cooperating pieces, bundled by :class:`Telemetry`:

* :class:`MetricsRegistry` — named counters, gauges, and fixed-bucket
  histograms (with exact-sample percentile queries).  Instruments are
  created once and mutated in place, so hot-path holders can cache the
  instrument object; ``reset_run()`` zeroes run-scoped instruments without
  invalidating those handles.  Exports Prometheus text exposition
  (``to_prometheus``) and a plain dict (``snapshot``).

* :class:`Tracer` — per-request event timelines and per-segment spans in
  Chrome trace-event JSON (the ``{"traceEvents": [...]}`` format that opens
  directly in perfetto.dev or chrome://tracing).  Wall-clock microsecond
  timestamps; every event also carries the sim-step clock in ``args``.
  Request lifecycles render as one named track per request (queued /
  prefill / decode phase spans + preempt / fault / retire instants);
  engine-level segment spans, defrag spans, and pool counter series render
  on the engine track.  The event buffer is a ring (``max_events``) so a
  long-running serve cannot leak host memory; drops are counted and
  surfaced in the export metadata, never silent.

* :func:`percentile` — THE percentile helper (benchmarks and the engine
  previously each carried their own); exact ``np.percentile`` over the
  samples with an explicit empty-input policy.

Disabled telemetry (``Telemetry(enabled=False)``, or the engine/launch
``--no-telemetry`` flag) keeps the registry live — counters are plain
in-place integer adds and every ``last_run_*`` back-compat read flows
through them — but turns every tracer call into an early-out, so the token
stream is bit-identical either way (tested) and the serve loop pays only
dict-lookup-free guard checks.

Optionally (``profiler_annotations=True``) each engine dispatch is wrapped
in a ``torch.profiler.record_function`` scope named after its engine span,
so a device profile captured with ``torch.profiler.profile`` lines up 1:1
with the engine's own segment spans in perfetto.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import math
import time
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

__all__ = [
    "percentile", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "Telemetry", "SERVE_METRICS", "declare_serve_metrics",
    "validate_chrome_trace",
]


# ---------------------------------------------------------------------------
# Shared percentile helper (the one true implementation)
# ---------------------------------------------------------------------------

def percentile(values, q: float, *, empty: float = float("nan")) -> float:
    """``np.percentile`` with an explicit empty-input policy.

    Every percentile in the serve stack flows through here (engine TTFT,
    benchmark latency/queue-delay tables, histogram queries) so the
    interpolation rule can never drift between reports.  ``empty`` is
    returned when ``values`` has no samples (NaN by default; benchmarks
    that tabulate pass ``empty=0.0``)."""
    values = np.asarray(list(values), np.float64)
    if values.size == 0:
        return float(empty)
    return float(np.percentile(values, q))


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic counter (int or float).  ``run_scoped`` instruments are
    zeroed by :meth:`MetricsRegistry.reset_run`; lifetime instruments
    (e.g. cumulative dispatch counts) survive it."""

    __slots__ = ("name", "help", "labels", "run_scoped", "value")
    kind = "counter"

    def __init__(self, name, help="", labels=(), run_scoped=True):
        self.name, self.help, self.labels = name, help, labels
        self.run_scoped = run_scoped
        self.value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        self.value += n

    def reset(self):
        self.value = 0


class Gauge:
    """Point-in-time value with ``set`` / ``set_max`` (high-water mark)."""

    __slots__ = ("name", "help", "labels", "run_scoped", "value")
    kind = "gauge"

    def __init__(self, name, help="", labels=(), run_scoped=True):
        self.name, self.help, self.labels = name, help, labels
        self.run_scoped = run_scoped
        self.value = 0

    def set(self, v):
        self.value = v

    def set_max(self, v):
        if v > self.value:
            self.value = v

    def reset(self):
        self.value = 0


class Histogram:
    """Fixed-bucket histogram with exact-sample percentile queries.

    Buckets are upper bounds (``le``), Prometheus-style, with an implicit
    ``+Inf`` bucket.  Raw samples are additionally retained in a bounded
    ring (``max_samples``) so :meth:`percentile` is exact for any run whose
    observation count fits the ring; past the bound the oldest samples roll
    off and ``n_dropped`` says so."""

    __slots__ = ("name", "help", "labels", "run_scoped", "buckets",
                 "bucket_counts", "sum", "count", "samples", "max_samples")
    kind = "histogram"

    def __init__(self, name, help="", labels=(), run_scoped=True,
                 buckets: Sequence[float] = (), max_samples: int = 65536):
        self.name, self.help, self.labels = name, help, labels
        self.run_scoped = run_scoped
        self.buckets = tuple(sorted(buckets))
        self.max_samples = max_samples
        self.reset()

    def reset(self):
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self.sum = 0.0
        self.count = 0
        self.samples = collections.deque(maxlen=self.max_samples)

    def observe(self, v):
        self.bucket_counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        self.samples.append(v)

    @property
    def n_dropped(self) -> int:
        """Samples no longer in the ring (percentiles are exact iff 0)."""
        return self.count - len(self.samples)

    def percentile(self, q: float, *, empty: float = float("nan")) -> float:
        return percentile(self.samples, q, empty=empty)

    def mean(self, *, empty: float = float("nan")) -> float:
        return self.sum / self.count if self.count else float(empty)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def _label_key(labels: Mapping[str, str] | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


def _fmt_labels(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


def _fmt_value(v) -> str:
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


class MetricsRegistry:
    """Name -> instrument table with get-or-create accessors.

    Instrument identity is ``(name, labels)``; re-requesting an existing
    instrument returns the SAME object (help/buckets from the first
    declaration win), so call sites can cache the handle and
    :meth:`reset_run` can zero values in place without breaking it.
    """

    def __init__(self):
        self._metrics: dict[tuple, Any] = {}      # (name, labels) -> inst

    def _get(self, cls, name, help, labels, run_scoped, **kw):
        key = (name, _label_key(labels))
        inst = self._metrics.get(key)
        if inst is None:
            inst = cls(name, help=help, labels=key[1],
                       run_scoped=run_scoped, **kw)
            self._metrics[key] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{inst.kind}, requested {cls.kind}")
        return inst

    def counter(self, name, help="", *, labels=None,
                run_scoped=True) -> Counter:
        return self._get(Counter, name, help, labels, run_scoped)

    def gauge(self, name, help="", *, labels=None,
              run_scoped=True) -> Gauge:
        return self._get(Gauge, name, help, labels, run_scoped)

    def histogram(self, name, help="", *, labels=None, run_scoped=True,
                  buckets=(), max_samples=65536) -> Histogram:
        return self._get(Histogram, name, help, labels, run_scoped,
                         buckets=buckets, max_samples=max_samples)

    def value(self, name, *, labels=None, default=0):
        """Current value of a counter/gauge (``default`` when absent)."""
        inst = self._metrics.get((name, _label_key(labels)))
        return default if inst is None else inst.value

    def series(self, name) -> dict[tuple, Any]:
        """Every labeled instance of ``name``: {labels_tuple: value|inst}."""
        return {labels: inst for (n, labels), inst in self._metrics.items()
                if n == name}

    def reset_run(self) -> None:
        """Zero every run-scoped instrument in place (handles stay valid)."""
        for inst in self._metrics.values():
            if inst.run_scoped:
                inst.reset()

    # ------------------------------------------------------------- exports

    def snapshot(self) -> dict:
        """Plain-dict view: counters/gauges -> value; histograms ->
        {count, sum, mean, p50, p99, n_dropped}.  Labeled series nest as
        ``{name: {label_repr: value}}``."""
        out: dict[str, Any] = {}
        for (name, labels), inst in self._metrics.items():
            if inst.kind == "histogram":
                val = {"count": inst.count, "sum": inst.sum,
                       "mean": inst.mean(empty=0.0),
                       "p50": inst.percentile(50, empty=0.0),
                       "p99": inst.percentile(99, empty=0.0),
                       "n_dropped": inst.n_dropped}
            else:
                val = inst.value
            if labels:
                out.setdefault(name, {})[_fmt_labels(labels)] = val
            else:
                out[name] = val
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one block per metric name:
        optional # HELP / # TYPE, then the labeled samples)."""
        by_name: dict[str, list] = collections.defaultdict(list)
        for (name, labels), inst in self._metrics.items():
            by_name[name].append((labels, inst))
        lines = []
        for name, insts in by_name.items():
            first = insts[0][1]
            if first.help:
                lines.append(f"# HELP {name} {first.help}")
            lines.append(f"# TYPE {name} {first.kind}")
            for labels, inst in insts:
                if inst.kind == "histogram":
                    cum = 0
                    for ub, c in zip(inst.buckets + (float("inf"),),
                                     inst.bucket_counts):
                        cum += c
                        ls = _fmt_labels(
                            labels + (("le", _fmt_value(float(ub))),))
                        lines.append(f"{name}_bucket{ls} {cum}")
                    ls = _fmt_labels(labels)
                    lines.append(f"{name}_sum{ls} {_fmt_value(inst.sum)}")
                    lines.append(f"{name}_count{ls} {inst.count}")
                else:
                    lines.append(f"{name}{_fmt_labels(labels)} "
                                 f"{_fmt_value(inst.value)}")
        return "\n".join(lines) + "\n"

    def write(self, path: str) -> None:
        """Export to ``path``: ``.json`` -> :meth:`snapshot` JSON, anything
        else (``.prom`` / ``.txt``) -> Prometheus text exposition."""
        if str(path).endswith(".json"):
            body = json.dumps(self.snapshot(), indent=2, sort_keys=True)
        else:
            body = self.to_prometheus()
        with open(path, "w") as f:
            f.write(body)


# ---------------------------------------------------------------------------
# Serve metric schema (names shared by the engine, benchmarks, and README)
# ---------------------------------------------------------------------------

# (name, kind, run_scoped, help) — declared up front so an export before
# (or without) traffic still shows the full schema at zero, and so the
# engine's last_run_* back-compat properties always resolve.
SERVE_METRICS: tuple[tuple[str, str, bool, str], ...] = (
    ("serve_segments_total", "counter", True,
     "Jitted decode/mixed segments dispatched this run"),
    ("serve_prefills_total", "counter", True,
     "Blocking per-admission prefill dispatches this run"),
    ("serve_prefill_chunks_total", "counter", True,
     "Prompt chunks advanced inside mixed segments this run"),
    ("serve_dispatches_total", "counter", True,
     "Host->device jitted dispatches this run (segments + prefills)"),
    ("serve_lifetime_dispatches_total", "counter", False,
     "Host->device jitted dispatches since engine construction"),
    ("serve_host_syncs_total", "counter", True,
     "Blocking device->host joins this run (segment harvests + "
     "admission-round tok0 reads)"),
    ("serve_defrags_total", "counter", True,
     "Pool defragmentation page permutations this run"),
    ("serve_preemptions_total", "counter", True,
     "Running requests evicted (pool pressure or injected) this run"),
    ("serve_recomputes_total", "counter", True,
     "Preempted requests re-admitted through recompute prefill this run"),
    ("serve_spills_total", "counter", True,
     "Requests paged out to the host SpillStore this run"),
    ("serve_spill_bytes_total", "counter", True,
     "KV bytes moved device->host by page-out spills this run"),
    ("serve_restores_total", "counter", True,
     "Spilled requests scattered back into the pool this run"),
    ("serve_snapshots_total", "counter", True,
     "Engine snapshots written this run (periodic + drain)"),
    ("serve_recoveries_total", "counter", True,
     "In-flight requests resumed from a restored snapshot this run"),
    ("serve_sheds_total", "counter", True,
     "Arrivals dropped by the bounded admission queue this run"),
    ("serve_timeouts_total", "counter", True,
     "Requests retired at their deadline this run"),
    ("serve_cancels_total", "counter", True,
     "Requests retired by client cancel this run"),
    ("serve_failed_total", "counter", True,
     "Rows quarantined on non-finite logits this run"),
    ("serve_submitted_total", "counter", True,
     "Requests submitted to the scheduler this run"),
    ("serve_admissions_total", "counter", True,
     "Scheduler admissions this run (fresh + recompute re-admits)"),
    ("serve_prefill_seconds_total", "counter", True,
     "Wall seconds spent in blocking admission prefill this run"),
    ("serve_prefix_hits_total", "counter", True,
     "Admissions that mapped >=1 cached prefix block this run"),
    ("serve_prefix_misses_total", "counter", True,
     "Admissions that found no cached prefix this run (prefix_cache on)"),
    ("serve_prefix_hit_tokens_total", "counter", True,
     "Prompt tokens served from cached blocks instead of prefill this run"),
    ("serve_cow_copies_total", "counter", True,
     "Shared blocks privatized by copy-on-write page copies this run"),
    ("serve_suffix_prefills_total", "counter", True,
     "Blocking admissions that prefilled only the unique suffix this run"),
    ("serve_max_concurrency", "gauge", True,
     "High-water mark of simultaneously running requests this run"),
    ("serve_queue_depth", "gauge", True,
     "Requests between arrival and admission (last scheduler round)"),
    ("serve_running", "gauge", True,
     "Running requests (last scheduler round)"),
    ("serve_pool_occupancy", "gauge", True,
     "Live-block fraction of the KV pool (last scheduler round)"),
    ("serve_pool_fragmentation", "gauge", True,
     "Hole fraction of the KV pool live span (last scheduler round)"),
    ("serve_pool_shared_blocks", "gauge", True,
     "Pool blocks referenced by more than one table (last round)"),
    ("serve_pool_owned_blocks", "gauge", True,
     "Pool blocks exclusively owned, refcount == 1 (last round)"),
    ("serve_pool_cached_blocks", "gauge", True,
     "Free blocks whose prefix bytes remain revivable (last round)"),
    ("serve_ttft_seconds", "histogram", True,
     "Wall time-to-first-token: eligible for admission -> first sampled "
     "token harvested"),
    ("serve_request_latency_steps", "histogram", True,
     "Arrival -> completion in sim decode steps (status OK only)"),
    ("serve_queue_delay_steps", "histogram", True,
     "Arrival -> first admission in sim decode steps"),
)

_TTFT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                 2.5, 5.0, 10.0)
_STEP_BUCKETS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                 1000.0, 2500.0)
_HIST_BUCKETS = {
    "serve_ttft_seconds": _TTFT_BUCKETS,
    "serve_request_latency_steps": _STEP_BUCKETS,
    "serve_queue_delay_steps": _STEP_BUCKETS,
}


def declare_serve_metrics(reg: MetricsRegistry) -> MetricsRegistry:
    """Register the full serve schema (idempotent); returns ``reg``."""
    for name, kind, run_scoped, help in SERVE_METRICS:
        if kind == "histogram":
            reg.histogram(name, help, run_scoped=run_scoped,
                          buckets=_HIST_BUCKETS[name])
        else:
            getattr(reg, kind)(name, help, run_scoped=run_scoped)
    return reg


# ---------------------------------------------------------------------------
# Tracer (Chrome trace-event JSON / perfetto)
# ---------------------------------------------------------------------------

PID_SERVE = 1          # one process track for the whole engine
TID_ENGINE = 0         # engine-level spans (segments, defrag, admission)
_TID_REQ_BASE = 1000   # request rid r renders as tid 1000 + r

# Milestones a request timeline chains into phase spans, in order.
_PHASES = (("arrive", "queued"), ("admit", "prefill"),
           ("first_token", "decode"))


class Tracer:
    """Ring-buffered Chrome trace-event recorder.

    All timestamps are wall-clock microseconds since :meth:`reset` (the
    format's native unit); every recording helper also threads the sim-step
    clock through ``args["step"]`` so a trace can be read in either time
    base.  When ``enabled`` is False every helper early-outs before
    touching the buffer — the disabled tracer is free."""

    def __init__(self, *, enabled: bool = True, max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self.reset()

    def reset(self) -> None:
        self._events: collections.deque = collections.deque(
            maxlen=self.max_events)
        self._epoch = time.perf_counter()
        self._names: dict[int, str] = {}       # tid -> thread name
        self._req_points: dict[int, list] = {}  # rid -> [(milestone, ts)]
        self.n_recorded = 0

    @property
    def n_dropped(self) -> int:
        """Events pushed out of the ring (0 unless the run outgrew
        ``max_events``); surfaced in the export metadata, never silent."""
        return self.n_recorded - len(self._events)

    def now(self) -> float:
        """Microseconds since the trace epoch (reset time)."""
        return (time.perf_counter() - self._epoch) * 1e6

    # ------------------------------------------------------------- record

    def _push(self, ev: dict) -> None:
        self._events.append(ev)
        self.n_recorded += 1

    def thread_name(self, tid: int, name: str) -> None:
        """Name a track (emitted once per tid as 'M' metadata on export)."""
        self._names.setdefault(tid, name)

    def instant(self, name: str, *, tid: int = TID_ENGINE, ts=None,
                cat: str = "serve", args: dict | None = None) -> None:
        if not self.enabled:
            return
        self._push({"name": name, "ph": "i", "s": "t", "cat": cat,
                    "ts": self.now() if ts is None else ts,
                    "pid": PID_SERVE, "tid": tid, "args": args or {}})

    def span(self, name: str, t0: float, t1: float, *,
             tid: int = TID_ENGINE, cat: str = "serve",
             args: dict | None = None) -> None:
        """Complete ('X') event from two :meth:`now` timestamps."""
        if not self.enabled:
            return
        self._push({"name": name, "ph": "X", "cat": cat, "ts": t0,
                    "dur": max(t1 - t0, 0.0), "pid": PID_SERVE, "tid": tid,
                    "args": args or {}})

    def counter(self, name: str, values: Mapping[str, float], *,
                ts=None) -> None:
        """Counter ('C') sample: one stacked series chart per name."""
        if not self.enabled:
            return
        self._push({"name": name, "ph": "C", "cat": "serve",
                    "ts": self.now() if ts is None else ts,
                    "pid": PID_SERVE, "tid": TID_ENGINE,
                    "args": dict(values)})

    # -------------------------------------------------- request timelines

    @staticmethod
    def req_tid(rid: int) -> int:
        return _TID_REQ_BASE + rid

    def request_point(self, rid: int, milestone: str, *, step: int,
                      ts=None, **args) -> None:
        """Record a lifecycle milestone ('arrive' / 'admit' /
        'first_token' / 'preempt' / ...) as an instant on the request's
        track; 'arrive', 'admit', and 'first_token' additionally become
        phase-span boundaries at retire time (first occurrence wins, so a
        recompute re-admission keeps the original phase edges)."""
        if not self.enabled:
            return
        ts = self.now() if ts is None else ts
        tid = self.req_tid(rid)
        self.thread_name(tid, f"req {rid}")
        pts = self._req_points.setdefault(rid, [])
        if milestone in ("arrive", "admit", "first_token") \
                and all(m != milestone for m, _ in pts):
            pts.append((milestone, ts))
        self._push({"name": milestone, "ph": "i", "s": "t",
                    "cat": "request", "ts": ts, "pid": PID_SERVE,
                    "tid": tid, "args": {"step": step, **args}})

    def request_retire(self, rid: int, status: str, *, step: int,
                       ts=None, **args) -> None:
        """Close a request's timeline: emits the queued / prefill / decode
        phase spans between its recorded milestones (missing milestones
        collapse their phase) plus a terminal 'retire' instant carrying the
        status."""
        if not self.enabled:
            return
        ts = self.now() if ts is None else ts
        tid = self.req_tid(rid)
        marks = dict(self._req_points.pop(rid, ()))
        edges = [(marks[m], phase) for m, phase in _PHASES if m in marks]
        for (t0, phase), (t1, _) in zip(edges, edges[1:] + [(ts, None)]):
            self.span(phase, t0, t1, tid=tid, cat="request",
                      args={"rid": rid})
        self._push({"name": "retire", "ph": "i", "s": "t",
                    "cat": "request", "ts": ts, "pid": PID_SERVE,
                    "tid": tid,
                    "args": {"step": step, "status": status, **args}})

    # ------------------------------------------------------------- export

    def events(self) -> list[dict]:
        return list(self._events)

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (perfetto /
        chrome://tracing): process/thread metadata, then the buffered
        events sorted by timestamp."""
        meta = [{"name": "process_name", "ph": "M", "pid": PID_SERVE,
                 "tid": TID_ENGINE, "args": {"name": "serve"}},
                {"name": "thread_name", "ph": "M", "pid": PID_SERVE,
                 "tid": TID_ENGINE, "args": {"name": "engine"}}]
        for tid, name in sorted(self._names.items()):
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": PID_SERVE, "tid": tid,
                         "args": {"name": name}})
        return {
            "traceEvents":
                meta + sorted(self._events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
            "otherData": {"n_recorded": self.n_recorded,
                          "n_dropped": self.n_dropped},
        }

    def write(self, path: str) -> None:
        """Export to ``path``: ``.jsonl`` -> one event per line (metadata
        events first — still valid trace-event 'JSON Array Format' when
        wrapped), anything else -> the full Chrome trace JSON object."""
        if str(path).endswith(".jsonl"):
            with open(path, "w") as f:
                for ev in self.to_chrome()["traceEvents"]:
                    f.write(json.dumps(ev) + "\n")
        else:
            with open(path, "w") as f:
                json.dump(self.to_chrome(), f)


# ---------------------------------------------------------------------------
# Bundle
# ---------------------------------------------------------------------------

class Telemetry:
    """Registry + tracer + run-scoped raw traces, behind one reset.

    ``enabled=False`` disables the tracer and the occupancy /
    fragmentation rings but keeps the registry live (counters back the
    engine's ``last_run_*`` reads and cost one in-place add each).
    ``trace_samples`` bounds the occupancy / fragmentation rings — the
    raw per-round sequences benchmarks plot — so a long-running serve
    holds at most that many points (the registry gauges always carry the
    latest sample regardless).

    ``profiler_annotations=True`` makes :meth:`annotate` yield a
    ``torch.profiler.record_function`` scope (otherwise a null context), so
    engine dispatch spans show up named inside a captured device profile.
    """

    def __init__(self, *, enabled: bool = True, trace_samples: int = 4096,
                 max_trace_events: int = 200_000,
                 profiler_annotations: bool = False):
        self.enabled = enabled
        self.trace_samples = trace_samples
        self.profiler_annotations = profiler_annotations
        self.metrics = declare_serve_metrics(MetricsRegistry())
        self.tracer = Tracer(enabled=enabled, max_events=max_trace_events)
        self.reset_run()

    def reset_run(self) -> None:
        """THE run-scoped reset (the engine's two hand-maintained
        ``last_run_*`` blocks collapsed into one place): zeroes run-scoped
        instruments, rewinds the tracer, and empties the raw rings."""
        self.metrics.reset_run()
        self.tracer.reset()
        self.ttft_seconds: dict[int, float] = {}
        self.occupancy_trace: collections.deque = collections.deque(
            maxlen=self.trace_samples)
        self.fragmentation_trace: collections.deque = collections.deque(
            maxlen=self.trace_samples)

    def set_enabled(self, enabled: bool) -> None:
        """Toggle tracing on a live engine (the registry stays on either
        way; used by the benchmark's telemetry-overhead gate)."""
        self.enabled = enabled
        self.tracer.enabled = enabled

    def annotate(self, name: str):
        """Context manager for an engine dispatch: a named
        ``torch.profiler.record_function`` scope when profiler annotations
        are on, else a free null context."""
        if self.profiler_annotations:
            from torch.profiler import record_function
            return record_function(name)
        return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Trace validation (CI smoke + tests)
# ---------------------------------------------------------------------------

_VALID_PHASES = frozenset("BEXiICMbensOPDv")


def validate_chrome_trace(trace, *, require_phases: Iterable[str] = "XiCM",
                          require_names: Iterable[str] = ()) -> dict:
    """Validate a Chrome trace-event JSON export; returns the parsed dict.

    ``trace`` is a path or an already-parsed object.  Checks the JSON
    Object Format contract perfetto/chrome://tracing rely on: a
    ``traceEvents`` list whose entries carry name/ph/pid/tid, numeric
    non-negative ``ts`` and ``dur`` where applicable, and known phase
    codes — then that every phase in ``require_phases`` and every event
    name in ``require_names`` actually occurs.  Raises ValueError with the
    first violation (CI runs this against the serve-sim / serve-chaos
    artifacts)."""
    if isinstance(trace, (str, bytes)):
        with open(trace) as f:
            trace = json.load(f)
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a JSON object with 'traceEvents'")
    events = trace["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    seen_phases, seen_names = set(), set()
    for i, ev in enumerate(events):
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        ph = ev["ph"]
        if ph not in _VALID_PHASES:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: 'X' event bad dur {dur!r}")
        if ph == "i" and ev.get("s", "t") not in ("g", "p", "t"):
            raise ValueError(f"event {i}: bad instant scope {ev.get('s')!r}")
        seen_phases.add(ph)
        seen_names.add(ev["name"])
    missing = set(require_phases) - seen_phases
    if missing:
        raise ValueError(f"required phases absent: {sorted(missing)} "
                         f"(have {sorted(seen_phases)})")
    missing = set(require_names) - seen_names
    if missing:
        raise ValueError(f"required event names absent: {sorted(missing)}")
    return trace


def _main(argv=None) -> int:
    """``python -m repro_torch.serve.telemetry validate TRACE...`` — the CI
    smoke for exported trace artifacts (exit 0 iff every file is a valid
    Chrome trace containing the required names/prefixes)."""
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.serve.telemetry")
    sub = ap.add_subparsers(dest="cmd", required=True)
    val = sub.add_parser("validate", help="validate Chrome trace exports")
    val.add_argument("traces", nargs="+", help="trace JSON files")
    val.add_argument("--require-names", default="",
                     help="comma-separated event names that must occur")
    val.add_argument("--require-prefix", default=None,
                     help="at least one event name must start with this")
    args = ap.parse_args(argv)
    names = tuple(n for n in args.require_names.split(",") if n)
    for path in args.traces:
        trace = validate_chrome_trace(path, require_names=names)
        events = trace["traceEvents"]
        if args.require_prefix is not None and not any(
                e["name"].startswith(args.require_prefix) for e in events):
            raise ValueError(f"{path}: no event name starts with "
                             f"{args.require_prefix!r}")
        drops = trace.get("otherData", {}).get("n_dropped", 0)
        print(f"{path}: valid ({len(events)} events, {drops} dropped)")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
