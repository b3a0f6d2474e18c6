"""Per-step distributed tracing + flight recorder (the observability
tier, docs/design/observability.md).

Three layers, all pure Python + stdlib (native-free, like the serving
tier):

* :class:`Tracer` — a low-overhead span tracer. Every hot-path stage of
  the step protocol (quorum, per-bucket fetch dispatch/wait, ring ops,
  unpack/put, drain/vote, heal stripes per donor, durable saves,
  publishes) records a span: a ``time.monotonic_ns()`` start + duration
  tagged with the step-protocol coordinates
  (``replica_id/quorum_id/epoch/step/policy_name``) that make spans
  from different groups alignable. Spans live in a bounded per-step
  ring (last ``TORCHFT_TRACE_STEPS`` steps, default 64), so memory is
  O(steps x spans/step) forever. The run-total counters in
  ``Manager.metrics()`` answer "how much"; the spans answer "when, and
  overlapped with what" — the attribution layer the fetch-wall work
  and the churn soak need (the 100k-GPU HSDP paper's per-step
  telemetry, arxiv 2602.00277).

* :class:`FlightRecorder` — crash-time dumps. On vote abort, latched
  CommunicatorError, heal failover, policy escalation, and
  atexit-after-an-unhandled-exception, the span ring + event history +
  a metrics snapshot are written to ``TORCHFT_FLIGHT_DIR`` as one JSON
  file that Perfetto loads directly (``traceEvents`` + a ``torchft``
  sidecar object), so any incident is postmortem-able without a
  re-run.

* Exports — :func:`chrome_trace` renders the ring in Chrome
  trace-event format (one track per pipeline stage; served at
  ``GET /trace.json`` on the CheckpointServer),
  :func:`prometheus_text` renders a metrics snapshot in Prometheus
  text exposition (served at ``GET /metrics``), and
  :func:`merge_traces` aligns many groups' traces on
  ``(quorum_id, epoch, step)`` into one fleet timeline
  (``scripts/tracefleet.py``).

Tracing defaults ON (the bench's ``multigroup_8mb_trace_ab`` row holds
the overhead under 2% of host steps/s); ``TORCHFT_TRACING=0`` disables
it process-wide, turning every ``span()`` into a shared no-op.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import re
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

logger: logging.Logger = logging.getLogger(__name__)

FLIGHT_FORMAT = "tft-flight-1"
TRACE_FORMAT = "tft-trace-1"

# Context tag keys every exported span carries (missing ones render as
# their neutral defaults): the cross-group alignment coordinates plus
# the policy attribution. Frozen by tests/test_metrics_schema.py.
CONTEXT_TAGS = ("replica_id", "quorum_id", "epoch", "step", "policy_name")

# Stable track (tid) order for the known pipeline stages — one Perfetto
# track per stage, in protocol order. Unknown stages append after.
STAGES = (
    "quorum", "heal", "heal_stripe", "fetch_dispatch", "fetch_wait",
    "ring", "hier_intra", "hier_leader", "put", "overlap_drain",
    "drain", "vote", "ckpt_save", "publish",
)


def default_enabled() -> bool:
    """Process-wide tracing default: on unless ``TORCHFT_TRACING`` is
    ``0``/``false`` (the bench A/B and overhead-sensitive jobs opt
    out)."""
    return os.environ.get("TORCHFT_TRACING", "1").strip().lower() \
        not in ("0", "false")


def default_trace_steps() -> int:
    """Ring depth in steps (``TORCHFT_TRACE_STEPS``, default 64)."""
    try:
        return max(int(os.environ.get("TORCHFT_TRACE_STEPS", 64)), 1)
    except ValueError:
        return 64


class _NoopSpan:
    """Shared do-nothing span for disabled tracers: ``span()`` on the
    hot path must cost one attribute read + one method call, nothing
    else."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass

    def set(self, **tags: Any) -> "_NoopSpan":
        return self


_NOOP_SPAN = _NoopSpan()


class _Span:
    """One in-flight span: started on ``__enter__``/construction,
    recorded into the tracer's ring on ``__exit__``. ``ctx`` is the
    tracer's copy-on-write context dict at start time (shared, never
    mutated), so capturing it is one reference, not a copy."""

    __slots__ = ("tracer", "stage", "tags", "ctx", "t0_ns", "dur_ns")

    def __init__(self, tracer: "Tracer", stage: str,
                 tags: Optional[Dict[str, Any]]) -> None:
        self.tracer = tracer
        self.stage = stage
        self.tags = tags
        self.ctx = tracer._ctx
        self.t0_ns = time.monotonic_ns()
        self.dur_ns = -1  # open until __exit__

    def set(self, **tags: Any) -> "_Span":
        """Attach/overwrite tags mid-span (e.g. the vote's decision,
        the quorum's fast/slow classification — facts only known at the
        end)."""
        if self.tags is None:
            self.tags = {}
        self.tags.update(tags)
        return self

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        self.dur_ns = time.monotonic_ns() - self.t0_ns
        if exc is not None:
            self.set(error=repr(exc))
        self.tracer._finish(self)

    def as_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "stage": self.stage,
            "t0_ns": self.t0_ns,
            "dur_ns": self.dur_ns,
        }
        d.update(self.ctx)
        if self.tags:
            d.update(self.tags)
        return d


class Tracer:
    """Bounded per-step span ring.

    Thread-safe: spans are recorded from the caller thread, the quorum
    thread, the comm worker, the put executor, and striped-heal fetch
    threads; the ring append is one short lock hold. Span START costs a
    ``monotonic_ns`` + one object allocation; a disabled tracer's
    ``span()`` returns a shared no-op.

    Args:
        steps: ring depth in steps (default ``TORCHFT_TRACE_STEPS`` /
            64): spans whose context ``step`` falls more than this many
            distinct steps behind are evicted oldest-first.
        enabled: overrides the ``TORCHFT_TRACING`` default.
        max_spans_per_step: hard per-step bound (default 4096) so a
            pathological caller (per-leaf spans) degrades to counted
            drops, never unbounded memory.
    """

    def __init__(self, steps: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 max_spans_per_step: int = 4096) -> None:
        self.enabled = (bool(enabled) if enabled is not None
                        else default_enabled())
        self._steps = (int(steps) if steps is not None
                       else default_trace_steps())
        self._steps = max(self._steps, 1)
        self._max_per_step = max(int(max_spans_per_step), 1)
        self._lock = threading.Lock()
        # step -> [span dict, ...], oldest step first. Keys are the
        # context step at span START (spans opened before the first
        # step() land under step 0/-1 and age out like any other).
        self._ring: "OrderedDict[Any, List[Dict[str, Any]]]" = \
            OrderedDict()
        # Copy-on-write context: set_context REPLACES the dict, so an
        # in-flight span's captured reference stays a consistent
        # snapshot without per-span copies.
        self._ctx: Dict[str, Any] = {
            "replica_id": "", "quorum_id": -1, "epoch": 0, "step": 0,
            "policy_name": "",
        }
        # Open spans (begin recorded, no end yet): exported as B events
        # with a synthesized E at dump time, so a dump taken mid-step
        # still shows what was in flight.
        self._open: Dict[int, _Span] = {}
        self.spans_total = 0
        self.spans_dropped = 0

    # ------------------------------------------------------------ record

    def set_context(self, **tags: Any) -> None:
        """Update the alignment context stamped on subsequent spans
        (copy-on-write; cheap, called at step/quorum boundaries).
        Maintained even when span recording is disabled: the flight
        recorder keys its per-(reason, step) dedup — and its filenames
        — on this context, and a disabled tracer must not collapse
        every later incident onto step 0."""
        with self._lock:
            ctx = dict(self._ctx)
            ctx.update(tags)
            self._ctx = ctx

    def context(self) -> Dict[str, Any]:
        return dict(self._ctx)

    def span(self, stage: str, **tags: Any) -> Any:
        """Context manager recording one span of ``stage``. Extra kwargs
        become span tags (bucket index, donor address, byte counts...).
        """
        if not self.enabled:
            return _NOOP_SPAN
        s = _Span(self, stage, tags or None)
        with self._lock:
            self._open[id(s)] = s
        return s

    def _finish(self, s: _Span) -> None:
        rec = s.as_dict()
        step = rec.get("step", 0)
        with self._lock:
            self._open.pop(id(s), None)
            lst = self._ring.get(step)
            if lst is None:
                lst = self._ring[step] = []
                while len(self._ring) > self._steps:
                    self._ring.popitem(last=False)
            if len(lst) >= self._max_per_step:
                self.spans_dropped += 1
                return
            lst.append(rec)
            self.spans_total += 1

    # ------------------------------------------------------------ export

    def spans(self, steps: Optional[int] = None) -> List[Dict[str, Any]]:
        """Recorded spans of the last ``steps`` steps (default: the
        whole ring), oldest step first."""
        with self._lock:
            keys = list(self._ring.keys())
            if steps is not None:
                n = max(int(steps), 0)
                # explicit, not keys[-n:]: a -0 slice is the WHOLE
                # list, inverting a zero-step request.
                keys = keys[len(keys) - n:] if n else []
            return [dict(rec) for k in keys for rec in self._ring[k]]

    def open_spans(self) -> List[Dict[str, Any]]:
        """Snapshot of spans currently in flight (no duration yet)."""
        with self._lock:
            return [s.as_dict() for s in list(self._open.values())]

    def stage_totals(self, step: Optional[Any] = None
                     ) -> Dict[str, float]:
        """Summed span wall (ms) per stage for one step of the ring
        (default: the newest step) — the fleet telemetry digest's
        stage-split source (docs/design/fleet_health.md). Empty when
        the step has no spans (tracing off, or nothing recorded)."""
        with self._lock:
            if step is None:
                if not self._ring:
                    return {}
                step = next(reversed(self._ring))
            out: Dict[str, float] = {}
            for rec in self._ring.get(step, ()):
                out[rec["stage"]] = (out.get(rec["stage"], 0.0)
                                     + max(rec["dur_ns"], 0) / 1e6)
            return out

    def chrome_trace(self, steps: Optional[int] = None) -> Dict[str, Any]:
        """The ring as a Chrome trace-event JSON object
        (Perfetto-loadable): completed spans are ``ph: "X"`` complete
        events, still-open spans a ``B``/``E`` pair whose ``E`` is
        synthesized at export (``args.open = true``), one track (tid)
        per pipeline stage, and ``M`` metadata events naming the
        process (replica id) and each track."""
        return chrome_trace(self.spans(steps), self.open_spans(),
                            now_ns=time.monotonic_ns())

    def metrics(self) -> Dict[str, float]:
        """Tracer health counters (merged into ``Manager.metrics()``)."""
        with self._lock:
            return {
                "trace_spans_total": float(self.spans_total),
                "trace_spans_dropped": float(self.spans_dropped),
            }


def maybe_span(tracer: Optional["Tracer"], stage: str,
               **tags: Any) -> Any:
    """``tracer.span(stage, **tags)``, or the shared no-op context
    manager when ``tracer`` is None — the ONE null-tracer guard for
    modules that receive an optional tracer (heal sessions, backends),
    so null semantics can never drift between them."""
    if tracer is None:
        return _NOOP_SPAN
    return tracer.span(stage, **tags)


# ---------------------------------------------------------------- chrome


def _stage_tids(stages: List[str]) -> Dict[str, int]:
    tids: Dict[str, int] = {}
    for s in STAGES:
        tids[s] = len(tids) + 1
    for s in stages:
        if s not in tids:
            tids[s] = len(tids) + 1
    return tids


def _span_args(rec: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in rec.items()
            if k not in ("stage", "t0_ns", "dur_ns")}


def chrome_trace(spans: List[Dict[str, Any]],
                 open_spans: Optional[List[Dict[str, Any]]] = None,
                 now_ns: Optional[int] = None,
                 pid: Optional[int] = None) -> Dict[str, Any]:
    """Render span dicts as a Chrome trace-event object. Timestamps are
    the spans' monotonic clock in microseconds — meaningful relative to
    each other within one process; :func:`merge_traces` aligns clocks
    ACROSS processes on the shared protocol coordinates."""
    open_spans = open_spans or []
    pid = os.getpid() if pid is None else int(pid)
    tids = _stage_tids([r["stage"] for r in spans]
                       + [r["stage"] for r in open_spans])
    replica = ""
    for r in spans + open_spans:
        if r.get("replica_id"):
            replica = str(r["replica_id"])
            break
    events: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid,
        "args": {"name": replica or f"pid {pid}"},
    }]
    used = {r["stage"] for r in spans} | {r["stage"] for r in open_spans}
    for stage, tid in tids.items():
        if stage in used:
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": stage}})
    for r in spans:
        events.append({
            "name": r["stage"], "cat": "torchft", "ph": "X",
            "ts": r["t0_ns"] / 1e3, "dur": max(r["dur_ns"], 0) / 1e3,
            "pid": pid, "tid": tids[r["stage"]],
            "args": _span_args(r),
        })
    end_ts = (now_ns if now_ns is not None
              else time.monotonic_ns()) / 1e3
    for r in open_spans:
        tid = tids[r["stage"]]
        args = _span_args(r)
        args["open"] = True
        events.append({"name": r["stage"], "cat": "torchft", "ph": "B",
                       "ts": r["t0_ns"] / 1e3, "pid": pid, "tid": tid,
                       "args": args})
        events.append({"name": r["stage"], "cat": "torchft", "ph": "E",
                       "ts": max(end_ts, r["t0_ns"] / 1e3), "pid": pid,
                       "tid": tid})
    return {"traceEvents": events, "torchft": {"format": TRACE_FORMAT}}


# ------------------------------------------------------------ prometheus

_LABEL_ESCAPE = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}
_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")


def _escape_label(v: Any) -> str:
    s = str(v)
    for a, b in _LABEL_ESCAPE.items():
        s = s.replace(a, b)
    return s


def _metric_name(key: str) -> str:
    return "torchft_" + _NAME_OK.sub("_", key)


# Metric families rendered as proper Prometheus SUMMARIES instead of
# bare per-quantile gauges: {summary name: (quantile -> source key,
# _sum source key, _count source key)}. The quantile source keys are
# consumed (they do not ALSO render as torchft_<key> gauges); the
# sum/count sources still render under their own documented names —
# they are read by bench/dashboards directly. The exact max stays its
# own gauge (summaries have no max slot). Frozen by
# tests/test_metrics_schema.py.
SUMMARY_SPECS: Dict[str, tuple] = {
    "quorum_ms": ({"0.5": "quorum_ms_p50", "0.95": "quorum_ms_p95"},
                  "quorum_ms_total", "quorum_count"),
}


def prometheus_text(numeric: Dict[str, Any],
                    info: Optional[Dict[str, str]] = None,
                    labels: Optional[Dict[str, str]] = None) -> str:
    """Render a numeric metrics snapshot (``Manager.metrics()``) as
    Prometheus text exposition: every key becomes
    ``torchft_<key>{<labels>}``, typed ``counter`` when the name ends
    in ``_total``/``_count`` (the repo's counter spelling) and
    ``gauge`` otherwise, with ``# HELP``/``# TYPE`` lines on every
    family. Latency-reservoir quantile triples listed in
    ``SUMMARY_SPECS`` render as ONE Prometheus ``summary`` family
    (``torchft_quorum_ms{quantile="0.5"} ... torchft_quorum_ms_sum /
    _count``) instead of bare gauges, so PromQL's
    ``histogram/summary`` tooling works on them. String diagnostics
    (``Manager.metrics_info()``) render as ONE ``torchft_info``
    info-style metric whose value is 1 and whose labels carry the
    strings — the Prometheus idiom for non-numeric facts, and the
    reason the numeric dict must stay numeric at the source."""
    base = "".join(f'{k}="{_escape_label(v)}",'
                   for k, v in sorted((labels or {}).items()))
    lines: List[str] = []
    consumed: set = set()
    for sname, (quantiles, sum_key, count_key) in \
            sorted(SUMMARY_SPECS.items()):
        if not all(k in numeric for k in quantiles.values()):
            continue
        name = _metric_name(sname)
        lines.append(f"# HELP {name} torchft_tpu {sname} summary")
        lines.append(f"# TYPE {name} summary")
        for q in sorted(quantiles, key=float):
            key = quantiles[q]
            consumed.add(key)
            pairs = base + f'quantile="{q}",'
            lines.append(
                f"{name}{{{pairs[:-1]}}} {float(numeric[key])!r}")
        label_s = f"{{{base[:-1]}}}" if base else ""
        if sum_key in numeric:
            lines.append(
                f"{name}_sum{label_s} {float(numeric[sum_key])!r}")
        if count_key in numeric:
            lines.append(
                f"{name}_count{label_s} {float(numeric[count_key])!r}")
    for key in sorted(numeric):
        if key in consumed:
            continue  # rendered as a summary quantile above
        val = numeric[key]
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            continue  # defensively skip anything non-numeric
        name = _metric_name(key)
        kind = ("counter" if key.endswith(("_total", "_count"))
                else "gauge")
        lines.append(f"# HELP {name} torchft_tpu {key}")
        lines.append(f"# TYPE {name} {kind}")
        label_s = f"{{{base[:-1]}}}" if base else ""
        # repr, not %g: 6 significant digits would freeze counters past
        # 1e6 (1000000 and 1000001 both render "1e+06"), zeroing
        # Prometheus rate() exactly where byte counters live.
        lines.append(f"{name}{label_s} {float(val)!r}")
    if info:
        pairs = base + "".join(
            f'{_NAME_OK.sub("_", k)}="{_escape_label(v)}",'
            for k, v in sorted(info.items()))
        lines.append("# HELP torchft_info torchft_tpu string diagnostics")
        lines.append("# TYPE torchft_info gauge")
        lines.append(f"torchft_info{{{pairs[:-1]}}} 1")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------- fleet merge


def _align_key(args: Dict[str, Any]) -> Optional[tuple]:
    try:
        return (int(args["quorum_id"]), int(args["epoch"]),
                int(args["step"]))
    except (KeyError, TypeError, ValueError):
        return None


def merge_traces(traces: List[Dict[str, Any]],
                 names: Optional[List[str]] = None) -> Dict[str, Any]:
    """Merge many groups' Chrome traces into ONE fleet timeline.

    Each group's spans carry monotonic timestamps from its OWN clock;
    wall clocks step and monotonic zeros differ per process, so raw
    merging would scatter the fleet. Alignment instead uses the step
    protocol itself: spans tagged with the same
    ``(quorum_id, epoch, step)`` describe the SAME global round, so for
    every shared key the earliest span start should coincide across
    groups (the quorum round is a barrier). The reference group is the
    one sharing keys with the MOST other groups (a cold-restarted or
    tracing-off first group must not blank the fleet's alignment);
    every other group's offset is the median over keys shared with the
    reference of (reference's earliest start - its own), robust to a
    few skewed stages. A group sharing NO keys with the reference keeps
    its raw clock, is listed in ``torchft.unaligned_groups``, and logs
    a warning - never a silent scatter. Groups are reassigned distinct
    pids (1..N) with their replica id as the process name."""
    # Pass 1: per-group events, alignment keys, process names.
    infos: List[Dict[str, Any]] = []
    for i, trace in enumerate(traces):
        events = list(trace.get("traceEvents", []))
        keys: Dict[tuple, float] = {}
        pname = ""
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                pname = str(ev.get("args", {}).get("name", "")) or pname
            if ev.get("ph") not in ("X", "B"):
                continue
            key = _align_key(ev.get("args", {}))
            if key is None:
                continue
            ts = float(ev["ts"])
            if key not in keys or ts < keys[key]:
                keys[key] = ts
        if not pname:
            # Caller-supplied fallback (the scrape address) only when
            # the trace itself names no replica.
            pname = (names[i] if names is not None and i < len(names)
                     and names[i] else f"group{i}")
        infos.append({"events": events, "keys": keys, "pname": pname})

    def overlap_score(i: int) -> tuple:
        shared = sum(
            1 for j, o in enumerate(infos)
            if j != i and infos[i]["keys"].keys() & o["keys"].keys())
        return (shared, len(infos[i]["keys"]), -i)

    ref = max(range(len(infos)), key=overlap_score) if infos else 0
    ref_keys = infos[ref]["keys"] if infos else {}

    merged: List[Dict[str, Any]] = []
    offsets: List[float] = []
    unaligned: List[str] = []
    for i, info in enumerate(infos):
        if i == ref:
            offset = 0.0
        else:
            deltas = sorted(
                ref_keys[k] - info["keys"][k]
                for k in info["keys"].keys() & ref_keys.keys())
            if deltas:
                offset = deltas[len(deltas) // 2]
            else:
                offset = 0.0
                unaligned.append(info["pname"])
                logger.warning(
                    "merge_traces: group %r shares no (quorum_id, "
                    "epoch, step) keys with reference %r - its spans "
                    "keep their raw clock and will NOT align",
                    info["pname"], infos[ref]["pname"])
        offsets.append(offset)
        pid = i + 1
        for ev in info["events"]:
            ev = dict(ev)
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = float(ev["ts"]) + offset
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                ev["args"] = {"name": info["pname"]}
            merged.append(ev)
    return {
        "traceEvents": merged,
        "torchft": {
            "format": TRACE_FORMAT,
            "merged_groups": [o["pname"] for o in infos],
            "aligned_on": ["quorum_id", "epoch", "step"],
            "reference_group": infos[ref]["pname"] if infos else "",
            "offsets_us": offsets,
            "unaligned_groups": unaligned,
        },
    }


# --------------------------------------------------------- flight recorder

# Crash-hook state: the sys/threading excepthooks latch "an unhandled
# exception happened" and atexit then asks every live FlightRecorder to
# dump — the "the job died, what was it doing" file that makes an
# incident postmortem-able without a re-run.
_CRASH_LOCK = threading.Lock()
_CRASH_SEEN: Dict[str, Any] = {"seen": False, "what": ""}
_CRASH_HOOKS_INSTALLED = False
_RECORDERS: List["FlightRecorder"] = []


def _note_crash(what: str) -> None:
    with _CRASH_LOCK:
        _CRASH_SEEN["seen"] = True
        if not _CRASH_SEEN["what"]:
            _CRASH_SEEN["what"] = what


def _install_crash_hooks() -> None:
    global _CRASH_HOOKS_INSTALLED
    with _CRASH_LOCK:
        if _CRASH_HOOKS_INSTALLED:
            return
        _CRASH_HOOKS_INSTALLED = True

    prev_sys = sys.excepthook

    def sys_hook(exc_type, exc, tb):  # noqa: ANN001
        _note_crash(repr(exc))
        prev_sys(exc_type, exc, tb)

    sys.excepthook = sys_hook

    prev_thread = threading.excepthook

    def thread_hook(args):  # noqa: ANN001
        # SystemExit from daemon teardown is routine, not a crash.
        if args.exc_type is not SystemExit:
            _note_crash(repr(args.exc_value))
        prev_thread(args)

    threading.excepthook = thread_hook
    atexit.register(_atexit_dump)


def _atexit_dump() -> None:
    with _CRASH_LOCK:
        seen, what = _CRASH_SEEN["seen"], _CRASH_SEEN["what"]
        recorders = list(_RECORDERS)
    if not seen:
        return
    for rec in recorders:
        rec.dump("atexit_after_exception", extra={"exception": what})


class FlightRecorder:
    """Crash-time dump writer: the span ring + event history + a
    metrics snapshot as one Perfetto-loadable JSON file under
    ``TORCHFT_FLIGHT_DIR``.

    Disabled (every ``dump`` a no-op) when no directory is configured —
    flight recording is an operational opt-in, the tracer itself stays
    on. Dumps never raise (observability must never fail a step), are
    deduped per (reason, step) so a flapping trigger cannot spam one
    file per retry, and are capped per process
    (``TORCHFT_FLIGHT_MAX``, default 64).

    Args:
        tracer: the span ring to dump.
        directory: dump directory (default ``TORCHFT_FLIGHT_DIR``).
        replica_id: stamped into filenames + the dump body.
        metrics_fn / info_fn / history_fn: zero-arg snapshot callables
            (the Manager wires its own) captured at dump time.
    """

    def __init__(self, tracer: Tracer,
                 directory: Optional[str] = None,
                 replica_id: str = "",
                 metrics_fn: Optional[Callable[[], Dict]] = None,
                 info_fn: Optional[Callable[[], Dict]] = None,
                 history_fn: Optional[Callable[[], List]] = None) -> None:
        self.tracer = tracer
        self.directory = (directory if directory is not None
                          else os.environ.get("TORCHFT_FLIGHT_DIR", ""))
        self.replica_id = replica_id
        self._metrics_fn = metrics_fn
        self._info_fn = info_fn
        self._history_fn = history_fn
        self._lock = threading.Lock()
        self._seen: set = set()
        self.dumps_total = 0
        self.last_path = ""
        try:
            self._max_dumps = max(
                int(os.environ.get("TORCHFT_FLIGHT_MAX", 64)), 1)
        except ValueError:
            self._max_dumps = 64
        if self.enabled:
            _install_crash_hooks()
            with _CRASH_LOCK:
                _RECORDERS.append(self)

    @property
    def enabled(self) -> bool:
        return bool(self.directory)

    def close(self) -> None:
        """Unregister from the atexit crash dump (Manager.shutdown)."""
        with _CRASH_LOCK:
            if self in _RECORDERS:
                _RECORDERS.remove(self)

    def dump(self, reason: str,
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write one dump; returns its path, or None when disabled /
        deduped / failed. Safe from any thread."""
        if not self.enabled:
            return None
        try:
            return self._dump(reason, extra)
        except Exception:  # noqa: BLE001 — never fail the step
            logger.exception("flight-recorder dump failed (reason=%s)",
                             reason)
            return None

    def _dump(self, reason: str,
              extra: Optional[Dict[str, Any]]) -> Optional[str]:
        step = self.tracer.context().get("step", 0)
        with self._lock:
            key = (reason, step)
            if key in self._seen or self.dumps_total >= self._max_dumps:
                return None
            # Reserve the dedup slot + cap so concurrent triggers of
            # the same incident write once; ROLLED BACK on a failed
            # write (transient ENOSPC must not permanently suppress
            # this incident's dump or count phantom dumps).
            self._seen.add(key)
            self.dumps_total += 1
        try:
            return self._write_dump(reason, step, extra)
        except BaseException:
            with self._lock:
                self._seen.discard(key)
                self.dumps_total -= 1
            raise

    def _write_dump(self, reason: str, step: Any,
                    extra: Optional[Dict[str, Any]]) -> str:
        trace = self.tracer.chrome_trace()
        body: Dict[str, Any] = dict(trace)
        side: Dict[str, Any] = {
            "format": FLIGHT_FORMAT,
            "reason": reason,
            "replica_id": self.replica_id,
            "step": step,
            "wall_time": time.time(),
            "mono_ns": time.monotonic_ns(),
            "context": self.tracer.context(),
        }
        for name, fn in (("metrics", self._metrics_fn),
                         ("info", self._info_fn),
                         ("history", self._history_fn)):
            if fn is not None:
                try:
                    side[name] = fn()
                except Exception:  # noqa: BLE001
                    side[name] = {"error": "snapshot failed"}
        if extra:
            side["extra"] = extra
        body["torchft"] = side
        os.makedirs(self.directory, exist_ok=True)
        rid = _NAME_OK.sub("_", self.replica_id or f"pid{os.getpid()}")
        fname = f"flight_{rid}_s{step}_{_NAME_OK.sub('_', reason)}.json"
        path = os.path.join(self.directory, fname)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            # default=str: span tags are open-ended (callers attach
            # whatever attributes a stage has); an unserializable tag
            # must degrade to its repr, never kill the dump.
            json.dump(body, f, default=str)
        os.replace(tmp, path)
        with self._lock:
            self.last_path = path
        logger.warning("flight recorder: dumped %s (reason=%s, step=%s)",
                       path, reason, step)
        return path

    def metrics(self) -> Dict[str, float]:
        with self._lock:
            return {"flight_dumps_total": float(self.dumps_total)}
