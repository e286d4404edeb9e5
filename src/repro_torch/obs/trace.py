"""Structured span tracing with a Chrome-trace (Perfetto) exporter.

Spans cover the serving request path — FrontDesk admit → EDF schedule →
batcher window → ``MOOService._step_round`` → ``ProbeExecutor``
(compile vs device dispatch) → vault persist — with *explicit* parent
propagation: a span (or its id) is handed down call chains as an
argument, never smuggled through thread-locals, because the path
crosses threads (caller → dispatcher → vault writer) where implicit
context would silently detach.

Design constraints (see DESIGN.md §14):

* **Disabled is free.** ``Tracer(enabled=False)`` — the default — makes
  ``span()`` return one shared no-op singleton and ``record_span()``
  return ``None`` immediately: no clock reads, no allocation, no lock.
  Components therefore instrument unconditionally and let the tracer
  decide.
* **Bounded memory.** Finished spans land in a ``deque(maxlen=...)``
  ring buffer; a long serving run keeps the most recent window instead
  of growing without bound.
* **Cross-thread truth.** Each span records the *real* recording
  thread id, so the Chrome export shows the admit on the caller thread,
  the dispatch on the ``frontdesk-dispatcher`` thread, and the vault
  commit on ``frontier-vault-writer`` — the actual concurrency
  structure, not a flattened fiction.
"""

from __future__ import annotations

import collections
import itertools
import json
import threading
import time

__all__ = ["Span", "Tracer"]

_span_ids = itertools.count(1)


class Span:
    """One live span: a context manager that records itself on exit.

    ``span_id`` is allocated at creation so children created while the
    span is still open can parent to it.  ``args`` is a mutable dict —
    callers may attach results (e.g. probe counts) before exit.
    """

    __slots__ = ("tracer", "name", "cat", "parent_id", "args", "span_id",
                 "t0", "t1", "thread_id", "thread_name")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 parent_id: int | None, args: dict | None):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.parent_id = parent_id
        self.args = dict(args) if args else {}
        self.span_id = next(_span_ids)
        self.t0 = tracer.clock()
        self.t1: float | None = None
        t = threading.current_thread()
        self.thread_id = t.ident
        self.thread_name = t.name

    @property
    def enabled(self) -> bool:
        """True — this is a live (recording) span."""
        return True

    def set(self, key: str, value) -> None:
        """Attach one result arg to the span."""
        self.args[key] = value

    def __enter__(self) -> "Span":
        """Enter the span's context (it is already open)."""
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Close the span, noting the exception type if one escaped."""
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.end()

    def end(self) -> None:
        """Close the span and hand it to the tracer (idempotent)."""
        if self.t1 is None:
            self.t1 = self.tracer.clock()
            self.tracer._record(self)


class _NoopSpan:
    """The shared do-nothing span a disabled tracer hands out."""

    __slots__ = ()
    span_id = None
    parent_id = None
    enabled = False

    def set(self, key: str, value) -> None:
        """Ignored."""

    def end(self) -> None:
        """Ignored."""

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NOOP_SPAN = _NoopSpan()


def _parent_id(parent) -> int | None:
    """Normalize a parent reference (Span, record dict, id, None)."""
    if parent is None:
        return None
    if isinstance(parent, int):
        return parent
    return getattr(parent, "span_id", None)


class Tracer:
    """Span collector with a bounded ring buffer and Chrome export.

    ``clock`` defaults to ``time.perf_counter`` — the same clock the
    serving stack's timing attribution uses, so retroactive
    ``record_span`` calls can replay already-measured intervals.
    """

    def __init__(self, enabled: bool = False, max_spans: int = 100_000,
                 clock=time.perf_counter):
        self.enabled = bool(enabled)
        self.clock = clock
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque(
            maxlen=max_spans)

    # -- recording -----------------------------------------------------
    def span(self, name: str, cat: str = "", parent=None,
             args: dict | None = None):
        """Open a span (context manager).  No-op singleton when
        disabled — the fast path is one attribute read."""
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, cat, _parent_id(parent), args)

    def record_span(self, name: str, t0: float, t1: float, cat: str = "",
                    parent=None, args: dict | None = None):
        """Record an already-measured interval retroactively (the
        caller timed it with the tracer's clock).  Returns the span so
        later spans can parent to it; ``None`` when disabled."""
        if not self.enabled:
            return None
        sp = Span(self, name, cat, _parent_id(parent), args)
        sp.t0 = float(t0)
        sp.t1 = float(t1)
        self._record(sp)
        return sp

    def now(self) -> float:
        """The tracer clock when enabled, 0.0 when disabled (so hot
        paths can bracket work without paying a clock read)."""
        return self.clock() if self.enabled else 0.0

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    # -- reading -------------------------------------------------------
    def spans(self) -> list[Span]:
        """Recorded spans, oldest first (a copy)."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        """Drop every recorded span."""
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        """Number of recorded spans."""
        with self._lock:
            return len(self._spans)

    # -- export --------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The recorded spans as a Chrome trace-event document.

        Load the JSON in ``chrome://tracing`` or https://ui.perfetto.dev
        — complete (``ph: "X"``) events with microsecond timestamps
        rebased to the earliest span, one row per real thread, plus
        thread-name metadata events.  ``span_id`` / ``parent_id`` ride
        in ``args`` so tooling can rebuild the explicit parent chain.
        """
        spans = self.spans()
        origin = min((s.t0 for s in spans), default=0.0)
        events = []
        threads: dict[int, str] = {}
        for s in sorted(spans, key=lambda s: s.t0):
            tid = s.thread_id or 0
            threads.setdefault(tid, s.thread_name or f"thread-{tid}")
            args = {k: v for k, v in s.args.items()}
            args["span_id"] = s.span_id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            events.append({
                "name": s.name,
                "cat": s.cat or "span",
                "ph": "X",
                "ts": (s.t0 - origin) * 1e6,
                "dur": max(0.0, ((s.t1 if s.t1 is not None else s.t0)
                                 - s.t0)) * 1e6,
                "pid": 1,
                "tid": tid,
                "args": args,
            })
        meta = [{
            "name": "thread_name",
            "ph": "M",
            "pid": 1,
            "tid": tid,
            "args": {"name": name},
        } for tid, name in sorted(threads.items())]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome(self, path) -> str:
        """Write :meth:`chrome_trace` to ``path``; returns the path."""
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        return str(path)
