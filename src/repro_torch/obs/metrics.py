"""Typed metrics: counters, gauges, histograms in a named registry.

The registry is the single source the serving ``stats()`` sections and
the ``--metrics-every`` dumps are built from.  Names are slash-
namespaced (``decode/steps``, ``sched/swaps``); ``snapshot()`` returns
the flat name->value view and ``nested()`` groups by the first path
segment (the ``DecodeServer.stats()`` sections).

``dump_text()`` emits one ``name value`` pair per line, sorted — the
plain-text format the ``tools/check_*.py`` gates can diff or threshold
without a JSON parser.

Thread-safety: instrument lookup/creation and histogram updates are
locked; counter/gauge writes take the same per-instrument lock.  The
locks are uncontended in the single-threaded serve/train loops, so the
hot-path cost is one lock acquire per event (~100ns, vs millisecond
decode steps).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Union

Number = Union[int, float]


class Counter:
    """Monotonically increasing count (events, bytes, dispatches)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        return self._value


class Gauge:
    """Last-write-wins scalar (queue depth, ms_per_step EMA)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value: Number = 0

    def set(self, v: Number) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> Number:
        return self._value


class Histogram:
    """Distribution sketch: exact count/sum/min/max plus percentiles
    over a bounded sample buffer.

    The buffer holds every observation up to ``cap``; past that it is
    decimated 2:1 (every other retained sample dropped, subsequent
    observations recorded at half rate) so memory stays bounded while
    percentiles remain representative of the whole run, not just its
    tail.
    """

    def __init__(self, name: str, cap: int = 8192):
        self.name = name
        self._lock = threading.Lock()
        self._cap = max(2, cap)
        self._samples: List[float] = []
        self._stride = 1          # record every _stride-th observation
        self._seen_mod = 0
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: Number) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._seen_mod = (self._seen_mod + 1) % self._stride
            if self._seen_mod == 0:
                self._samples.append(v)
                if len(self._samples) >= self._cap:
                    self._samples = self._samples[::2]
                    self._stride *= 2

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        with self._lock:
            s = sorted(self._samples)
        if not s:
            return 0.0
        k = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
        return s[k]

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min if self.min is not None else 0.0,
                "max": self.max if self.max is not None else 0.0,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class MetricsRegistry:
    """Get-or-create registry of named, typed instruments."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # -- views --------------------------------------------------------- #

    def snapshot(self) -> Dict[str, object]:
        """Flat ``name -> value`` (histograms -> summary dict)."""
        with self._lock:
            items = list(self._instruments.items())
        out: Dict[str, object] = {}
        for name, inst in items:
            out[name] = (inst.summary() if isinstance(inst, Histogram)
                         else inst.value)
        return out

    def nested(self) -> Dict[str, Dict[str, object]]:
        """Group the snapshot by first ``/`` segment: ``decode/steps``
        lands in ``nested()["decode"]["steps"]`` (the ``stats()``
        section layout)."""
        out: Dict[str, Dict[str, object]] = {}
        for name, val in self.snapshot().items():
            section, _, rest = name.partition("/")
            out.setdefault(section, {})[rest or section] = val
        return out

    def dump_text(self) -> str:
        """One sorted ``name value`` per line; histogram summaries are
        flattened as ``name.count`` / ``name.p50`` / ... — greppable by
        the check_* gates."""
        lines = []
        for name, val in sorted(self.snapshot().items()):
            if isinstance(val, dict):
                for k, v in sorted(val.items()):
                    lines.append(f"{name}.{k} {v:.6g}")
            else:
                lines.append(f"{name} {val:.6g}"
                             if isinstance(val, float) else
                             f"{name} {val}")
        return "\n".join(lines)
