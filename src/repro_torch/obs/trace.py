"""Tracer: nestable wall-clock spans over a thread-safe event buffer.

Design constraints (from the serving hot path):

- **Monotonic clock.**  All timestamps are ``time.monotonic_ns()`` —
  never wall time, so spans are immune to clock steps and cheap to
  subtract.  Exporters convert to microseconds.
- **Explicit parent ids.**  Each thread keeps its own open-span stack
  (``threading.local``), so nesting is tracked per thread and spans
  opened on different threads never adopt each other as parents.
- **Thread-safe buffer.**  Finished events are appended under a lock;
  readers (`events()`, exporters) snapshot under the same lock.
- **Retroactive spans.**  Some spans are only known after the fact (a
  request's queue wait ends at admission): ``add_span`` records an
  explicit ``[t0, t1]`` interval without touching the nesting stack.

Disabled tracing is ``tracer=None`` at the call site — instrumented code
guards every emission with one ``is None`` check, which is the entire
tracer-off cost.  There is deliberately no NullTracer object on the hot
paths: an attribute load + method call per event would already be most
of a no-op tracer's budget.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class TraceEvent:
    """One finished span or instant.  ``t1_ns`` is None for instants."""
    kind: str                      # "span" | "instant"
    name: str
    lane: str                      # one row in the exported trace
    t0_ns: int
    t1_ns: Optional[int]
    span_id: int
    parent_id: Optional[int]
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur_ns(self) -> int:
        return 0 if self.t1_ns is None else self.t1_ns - self.t0_ns


class _OpenSpan:
    """Context-manager handle returned by ``Tracer.span``."""

    __slots__ = ("_tr", "name", "lane", "args", "span_id", "parent_id",
                 "t0_ns")

    def __init__(self, tr: "Tracer", name: str, lane: str, args: dict):
        self._tr = tr
        self.name = name
        self.lane = lane
        self.args = args
        self.span_id = next(tr._ids)
        self.parent_id = None
        self.t0_ns = 0

    def __enter__(self) -> "_OpenSpan":
        stack = self._tr._stack()
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        self.t0_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.monotonic_ns()
        stack = self._tr._stack()
        # tolerate mis-nested exits: pop to (and including) this span
        while stack:
            top = stack.pop()
            if top is self:
                break
        self._tr._append(TraceEvent("span", self.name, self.lane,
                                    self.t0_ns, t1, self.span_id,
                                    self.parent_id, self.args))


class Tracer:
    """Collects spans/instants; export via ``repro.obs.export``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[TraceEvent] = []
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self.t_origin_ns = time.monotonic_ns()   # exporters zero here

    # -- internals ----------------------------------------------------- #

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _append(self, ev: TraceEvent) -> None:
        with self._lock:
            self._events.append(ev)

    # -- recording API ------------------------------------------------- #

    @staticmethod
    def now() -> int:
        return time.monotonic_ns()

    def span(self, name: str, *, lane: Optional[str] = None,
             **args) -> _OpenSpan:
        """Open a nested span: ``with tracer.span("decode_step",
        lane="tenant:base", step=i): ...``.  Parent is the innermost
        open span of the *current thread*."""
        return _OpenSpan(self, name,
                         lane if lane is not None
                         else threading.current_thread().name, args)

    def add_span(self, name: str, t0_ns: int, t1_ns: int, *,
                 lane: Optional[str] = None, **args) -> None:
        """Record a span with explicit endpoints (retroactive — e.g. a
        queue wait closed at admission).  Does not join the nesting
        stack."""
        self._append(TraceEvent(
            "span", name,
            lane if lane is not None else threading.current_thread().name,
            int(t0_ns), int(t1_ns), next(self._ids), None, args))

    def instant(self, name: str, *, lane: Optional[str] = None,
                **args) -> None:
        """Record a point event (rendered as an arrow/mark in Perfetto)."""
        self._append(TraceEvent(
            "instant", name,
            lane if lane is not None else threading.current_thread().name,
            time.monotonic_ns(), None, next(self._ids), None, args))

    # -- reading ------------------------------------------------------- #

    def events(self) -> List[TraceEvent]:
        with self._lock:
            return list(self._events)

    def spans(self, name: Optional[str] = None) -> List[TraceEvent]:
        return [e for e in self.events()
                if e.kind == "span" and (name is None or e.name == name)]

    def lanes(self) -> List[str]:
        seen: Dict[str, None] = {}
        for e in self.events():
            seen.setdefault(e.lane)
        return list(seen)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
