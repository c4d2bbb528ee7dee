"""Flight-recorder telemetry: spans, counters, gauges, trace export.

The repo's engine tiers, serving daemon, and chaos subsystem all need
per-stage time attribution (where do the 12 960-cell mega-grid seconds
go? what fraction of a served query is queue wait vs flush?) without
perturbing the numbers they measure.  This module is that recorder:

* ``span(name)`` — a nested-span context manager.  Spans record Chrome
  trace-event ``B``/``E`` pairs into a per-thread ring buffer and feed
  a per-name duration histogram (count / total / p50 / p99).
* ``count(name, n)`` — monotonic counters (protocol messages, cache
  hits, retries).
* ``gauge(name, value)`` — last-value-wins instantaneous readings
  (prefetch queue depth, in-flight tiles).
* ``observe(name, value)`` — one sample of an arbitrary-unit
  distribution (per-query latency in ms, directory occupancy).

**Off by default, near-zero cost.**  The module-level fast path is one
global load + ``None`` check; ``span()`` returns a shared no-op context
manager when disabled.  Enable with ``RECXL_TELEMETRY=1`` in the
environment, ``telemetry.enable()``, or the scoped
``with telemetry.recording() as rec:``.  Telemetry NEVER changes
numerical results, memo keys, bank bytes, or compile counts — pinned by
``tests/test_telemetry.py`` (the zero-churn discipline of PRs 5/6/9).

**Lock-free-ish rings.**  Each thread appends to its own ``_ThreadLog``
(created once under the recorder lock, then touched only by its owner
thread), so steady-state recording takes no locks.  Rings are bounded:
when full, the oldest half is dropped in one slice — a flight recorder
keeps the most recent window.  Aggregates (histograms, counters) are
kept separately and survive ring wrap.

**Export.**  ``export_chrome(path)`` writes Chrome trace-event JSONL —
one event object per line — loadable at https://ui.perfetto.dev.
``summary()`` merges every thread into one plain dict (the thing that
flows into ``ScenarioServer.stats()``, streamed ``SimResult.meta``, and
BENCH rows).  ``validate_chrome_trace(path)`` is the schema check CI
and tests share: every ``B`` has a matching ``E``, thread ids resolve
to thread-name metadata.

Span taxonomy and counter units are documented in
``docs/observability.md``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, IO, List, Optional, Tuple, Union

__all__ = [
    "Recorder",
    "active",
    "count",
    "disable",
    "enable",
    "enabled",
    "export_chrome",
    "gauge",
    "observe",
    "recording",
    "reset",
    "span",
    "summary",
    "validate_chrome_trace",
]

#: Default per-thread ring capacity, in events (a span costs two).
DEFAULT_RING_EVENTS = 65536

#: Per-(thread, name) duration/value samples kept for percentiles.
#: Beyond this the histogram keeps count/total/max exactly but stops
#: collecting new percentile samples (first-window reservoir).
MAX_SAMPLES = 8192


class _NoopSpan:
    """The disabled-path span: a shared, stateless context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class _ThreadLog:
    """One thread's ring buffer + aggregates.  Owner-thread-only writes."""

    __slots__ = ("tid", "os_tid", "name", "cap", "events", "n_dropped",
                 "stack", "spans", "dists", "counters", "gauges")

    def __init__(self, tid: int, os_tid: Optional[int], name: str,
                 cap: int) -> None:
        self.tid = tid          # stable export tid (registration order)
        self.os_tid = os_tid    # threading ident, informational
        self.name = name
        self.cap = cap
        # Ring events are tuples (ph, t_ns, name, payload):
        #   ("B", t, name, args-dict-or-None)   span open
        #   ("E", t, name, None)                span close
        #   ("C", t, name, value)               counter/gauge sample
        #   ("X", t, name, dur_ns)              complete event (observe)
        self.events: List[Tuple[str, int, str, Any]] = []
        self.n_dropped = 0
        self.stack: List[str] = []
        # name -> [count, total_ns, max_ns, samples]
        self.spans: Dict[str, List[Any]] = {}
        # name -> [count, total, max, samples]  (raw units)
        self.dists: Dict[str, List[Any]] = {}
        self.counters: Dict[str, float] = {}
        # name -> (t_ns, value): last-wins merged by timestamp
        self.gauges: Dict[str, Tuple[int, float]] = {}

    def push(self, ev: Tuple[str, int, str, Any]) -> None:
        if len(self.events) >= self.cap:
            drop = max(1, self.cap // 2)
            del self.events[:drop]
            self.n_dropped += drop
        self.events.append(ev)


def _obs(table: Dict[str, List[Any]], name: str, value: float) -> None:
    st = table.get(name)
    if st is None:
        st = table[name] = [0, 0.0, 0.0, []]
    st[0] += 1
    st[1] += value
    if value > st[2]:
        st[2] = value
    if len(st[3]) < MAX_SAMPLES:
        st[3].append(value)


class _Span:
    """Live span: records B/E events and feeds the duration histogram."""

    __slots__ = ("_rec", "_name", "_args", "_log", "_t0")

    def __init__(self, rec: "Recorder", name: str,
                 args: Optional[Dict[str, Any]]) -> None:
        self._rec = rec
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        log = self._rec._log()
        self._log = log
        t0 = time.perf_counter_ns()
        self._t0 = t0
        log.push(("B", t0, self._name, self._args))
        log.stack.append(self._name)
        return self

    def __exit__(self, *exc: object) -> bool:
        t1 = time.perf_counter_ns()
        log = self._log
        # Context managers unwind LIFO, so the top of the stack is us.
        if log.stack and log.stack[-1] == self._name:
            log.stack.pop()
        log.push(("E", t1, self._name, None))
        _obs(log.spans, self._name, t1 - self._t0)
        return False


class Recorder:
    """A telemetry session: per-thread logs plus merge/export views."""

    def __init__(self, ring_events: int = DEFAULT_RING_EVENTS) -> None:
        self.ring_events = int(ring_events)
        self.pid = os.getpid()
        self.t0_ns = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._logs: List[_ThreadLog] = []
        self._tls = threading.local()

    # -- recording (hot path) -------------------------------------------

    def _log(self) -> _ThreadLog:
        log = getattr(self._tls, "log", None)
        if log is None:
            t = threading.current_thread()
            with self._lock:
                log = _ThreadLog(len(self._logs) + 1, t.ident, t.name,
                                 self.ring_events)
                self._logs.append(log)
            self._tls.log = log
        return log

    def span(self, name: str,
             args: Optional[Dict[str, Any]] = None) -> _Span:
        return _Span(self, name, args)

    def count(self, name: str, n: float = 1, ev: bool = True) -> None:
        """``ev=False`` updates the aggregate only (no ring event):
        the cheap mode for per-cell hot paths -- a counter sampled tens
        of thousands of times per run would wrap the event tape anyway,
        and its ``summary()`` total is what consumers read."""
        log = self._log()
        total = log.counters.get(name, 0) + n
        log.counters[name] = total
        if ev:
            log.push(("C", time.perf_counter_ns(), name, total))

    def gauge(self, name: str, value: float) -> None:
        log = self._log()
        t = time.perf_counter_ns()
        log.gauges[name] = (t, value)
        log.push(("C", t, name, value))

    def observe(self, name: str, value: float, ev: bool = True) -> None:
        log = self._log()
        _obs(log.dists, name, value)
        if ev:
            log.push(("X", time.perf_counter_ns(), name, value))

    # -- merge / export --------------------------------------------------

    def _snapshot_logs(self) -> List[_ThreadLog]:
        with self._lock:
            return list(self._logs)

    def summary(self) -> Dict[str, Any]:
        """Merge every thread into one plain-dict summary.

        ``spans`` durations are reported in milliseconds; ``dists``
        (from :meth:`observe`) keep their caller's raw units.
        """
        logs = self._snapshot_logs()
        spans: Dict[str, List[Any]] = {}
        dists: Dict[str, List[Any]] = {}
        counters: Dict[str, float] = {}
        gauges: Dict[str, Tuple[int, float]] = {}
        n_events = 0
        n_dropped = 0
        for log in logs:
            n_events += len(log.events)
            n_dropped += log.n_dropped
            for table, merged in ((log.spans, spans), (log.dists, dists)):
                for name, st in list(table.items()):
                    dst = merged.get(name)
                    if dst is None:
                        merged[name] = [st[0], st[1], st[2], list(st[3])]
                    else:
                        dst[0] += st[0]
                        dst[1] += st[1]
                        dst[2] = max(dst[2], st[2])
                        dst[3].extend(st[3])
            for name, v in list(log.counters.items()):
                counters[name] = counters.get(name, 0) + v
            for name, tv in list(log.gauges.items()):
                if name not in gauges or tv[0] > gauges[name][0]:
                    gauges[name] = tv

        def _stats(st: List[Any], scale: float) -> Dict[str, float]:
            n, total, mx, samples = st
            out = {
                "count": n,
                "total": round(total * scale, 6),
                "mean": round(total * scale / max(n, 1), 6),
                "max": round(mx * scale, 6),
            }
            if samples:
                xs = sorted(samples)
                out["p50"] = round(_pct(xs, 0.50) * scale, 6)
                out["p99"] = round(_pct(xs, 0.99) * scale, 6)
            return out

        return {
            "spans": {k: _stats(v, 1e-6) for k, v in sorted(spans.items())},
            "dists": {k: _stats(v, 1.0) for k, v in sorted(dists.items())},
            "counters": {k: counters[k] for k in sorted(counters)},
            "gauges": {k: gauges[k][1] for k in sorted(gauges)},
            "threads": len(logs),
            "events": n_events,
            "events_dropped": n_dropped,
        }

    def span_events(self, name: Optional[str] = None
                    ) -> List[Tuple[str, int, str, int]]:
        """Flat, time-ordered ``(ph, t_ns, name, tid)`` event view.

        Handy for tests asserting ordering (e.g. the chaos-recovery
        detection -> rebuild -> re-dispatch timeline).
        """
        out: List[Tuple[str, int, str, int]] = []
        for log in self._snapshot_logs():
            for ph, t, nm, _payload in list(log.events):
                if ph in ("B", "E") and (name is None or nm == name
                                         or nm.startswith(name)):
                    out.append((ph, t, nm, log.tid))
        out.sort(key=lambda ev: ev[1])
        return out

    def export_chrome(self, path_or_file: Union[str, IO[str]]) -> int:
        """Write Chrome trace-event JSONL (one event per line).

        Returns the number of event lines written.  Load the file at
        https://ui.perfetto.dev or chrome://tracing.
        """
        if isinstance(path_or_file, str):
            with open(path_or_file, "w", encoding="utf-8") as fh:
                return self.export_chrome(fh)
        fh = path_or_file
        t0 = self.t0_ns
        n = 0
        for log in self._snapshot_logs():
            meta = {"ph": "M", "name": "thread_name", "pid": self.pid,
                    "tid": log.tid,
                    "args": {"name": log.name or f"thread-{log.tid}"}}
            fh.write(json.dumps(meta) + "\n")
            n += 1
            for ph, t, name, payload in list(log.events):
                ev: Dict[str, Any] = {
                    "ph": ph, "ts": (t - t0) / 1e3, "pid": self.pid,
                    "tid": log.tid, "name": name, "cat": "recxl",
                }
                if ph == "B" and payload:
                    ev["args"] = payload
                elif ph == "C":
                    ev["args"] = {"value": payload}
                elif ph == "X":
                    # observe(): a zero-extent sample rendered as a
                    # complete event so it shows on the track.
                    ev["dur"] = 0.0
                    ev["args"] = {"value": payload}
                fh.write(json.dumps(ev, default=str) + "\n")
                n += 1
        return n


def _pct(sorted_xs: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted sample list."""
    if not sorted_xs:
        return 0.0
    idx = min(len(sorted_xs) - 1, int(q * len(sorted_xs)))
    return float(sorted_xs[idx])


# -- module-level switch + conveniences ---------------------------------

_RECORDER: Optional[Recorder] = None


def active() -> Optional[Recorder]:
    """The live :class:`Recorder`, or ``None`` when telemetry is off."""
    return _RECORDER


def enabled() -> bool:
    return _RECORDER is not None


def enable(ring_events: int = DEFAULT_RING_EVENTS) -> Recorder:
    """Turn telemetry on (idempotent); returns the recorder."""
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = Recorder(ring_events)
    return _RECORDER


def disable() -> None:
    global _RECORDER
    _RECORDER = None


def reset(ring_events: int = DEFAULT_RING_EVENTS) -> Recorder:
    """Drop all recorded data and start a fresh (enabled) recorder."""
    global _RECORDER
    _RECORDER = Recorder(ring_events)
    return _RECORDER


@contextlib.contextmanager
def recording(ring_events: int = DEFAULT_RING_EVENTS):
    """Scoped enable: fresh recorder inside, previous state restored."""
    global _RECORDER
    prev = _RECORDER
    rec = Recorder(ring_events)
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = prev


def span(name: str, **args: Any) -> Union[_Span, _NoopSpan]:
    """``with telemetry.span("tile/h2d", tile=3): ...``"""
    rec = _RECORDER
    if rec is None:
        return _NOOP_SPAN
    return _Span(rec, name, args or None)


def count(name: str, n: float = 1) -> None:
    rec = _RECORDER
    if rec is not None:
        rec.count(name, n)


def gauge(name: str, value: float) -> None:
    rec = _RECORDER
    if rec is not None:
        rec.gauge(name, value)


def observe(name: str, value: float) -> None:
    rec = _RECORDER
    if rec is not None:
        rec.observe(name, value)


def summary() -> Dict[str, Any]:
    rec = _RECORDER
    return rec.summary() if rec is not None else {}


def export_chrome(path_or_file: Union[str, IO[str]]) -> int:
    rec = _RECORDER
    return rec.export_chrome(path_or_file) if rec is not None else 0


def validate_chrome_trace(path: str) -> Dict[str, int]:
    """Validate an exported JSONL trace against the trace-event schema.

    Checks (raising ``ValueError`` with a specific message on the first
    violation):

    * every line parses as a JSON object with ``ph``, and timed events
      carry numeric ``ts`` + integer ``pid``/``tid``;
    * every ``B`` has a matching same-name ``E`` on the same
      ``(pid, tid)`` track, properly nested (LIFO);
    * every ``tid`` seen on an event resolves to a ``thread_name``
      metadata (``M``) record.

    Returns ``{"events", "threads", "spans"}`` counts for reporting.
    """
    stacks: Dict[Tuple[int, int], List[str]] = {}
    named_tids: set = set()
    seen_tids: set = set()
    n_events = 0
    n_spans = 0
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError as e:
                raise ValueError(f"line {lineno}: not JSON: {e}") from e
            if not isinstance(ev, dict) or "ph" not in ev:
                raise ValueError(f"line {lineno}: no 'ph' field")
            ph = ev["ph"]
            n_events += 1
            if ph == "M":
                if ev.get("name") == "thread_name":
                    named_tids.add((ev.get("pid"), ev.get("tid")))
                continue
            for field in ("pid", "tid"):
                if not isinstance(ev.get(field), int):
                    raise ValueError(
                        f"line {lineno}: missing int '{field}'")
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"line {lineno}: missing numeric 'ts'")
            key = (ev["pid"], ev["tid"])
            seen_tids.add(key)
            if ph == "B":
                stacks.setdefault(key, []).append(ev.get("name", ""))
            elif ph == "E":
                stack = stacks.get(key)
                if not stack:
                    raise ValueError(
                        f"line {lineno}: 'E' {ev.get('name')!r} with no "
                        f"open 'B' on tid {ev['tid']}")
                top = stack.pop()
                if top != ev.get("name"):
                    raise ValueError(
                        f"line {lineno}: 'E' {ev.get('name')!r} closes "
                        f"open span {top!r} (bad nesting)")
                n_spans += 1
    for key, stack in stacks.items():
        if stack:
            raise ValueError(
                f"tid {key[1]}: {len(stack)} unclosed 'B' events "
                f"({stack[-1]!r} still open)")
    unnamed = seen_tids - named_tids
    if unnamed:
        raise ValueError(
            f"tids without thread_name metadata: "
            f"{sorted(t for _, t in unnamed)}")
    return {"events": n_events, "threads": len(seen_tids),
            "spans": n_spans}


# Environment opt-in: RECXL_TELEMETRY=1 enables at import time.
if os.environ.get("RECXL_TELEMETRY", "") not in ("", "0"):
    enable()
