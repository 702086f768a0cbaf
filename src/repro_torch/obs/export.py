"""Trace/metrics exporters: Chrome trace JSON, JSONL event log, text.

- ``write_chrome_trace`` — the Chrome Trace Event format
  (``chrome://tracing`` / https://ui.perfetto.dev both load it): spans
  as complete ``"X"`` events, instants as ``"i"``, one *lane* per
  ``tid`` with a ``thread_name`` metadata record.  Events are sorted by
  start time within each lane, so ``ts`` is monotonic per (pid, tid) —
  ``tools/check_trace.py`` asserts exactly that.
- ``write_jsonl`` — one JSON object per line (``kind`` span/instant/
  metric), append-friendly and greppable; the train loop's per-step
  selection telemetry lands here.
- ``write_metrics_text`` — the registry's plain-text dump.
- ``write_trace`` — picks the format from the file extension
  (``.jsonl`` -> JSONL, anything else -> Chrome JSON), which is what
  the ``--trace <path>`` launcher flags call.

Timestamps are exported in microseconds relative to the tracer's
origin, so traces start near t=0 regardless of host uptime.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TraceEvent, Tracer

PID = 0
PROCESS_NAME = "repro"


def _jsonable_args(args: dict) -> dict:
    out = {}
    for k, v in args.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


def _us(tracer: Tracer, t_ns: int,
        t_origin_ns: Optional[int] = None) -> float:
    origin = tracer.t_origin_ns if t_origin_ns is None else t_origin_ns
    return (t_ns - origin) / 1e3


def _process_records(tracer: Tracer, *, pid: int, process_name: str,
                     t_origin_ns: Optional[int] = None) -> List[dict]:
    """One process' worth of Chrome trace records: the process_name
    metadata, one (thread_name, thread_sort_index) pair per lane, and
    the lane-sorted events.  ``t_origin_ns`` overrides the tracer's own
    origin so N tracers can share a common t=0 (fleet merging)."""
    lanes: Dict[str, int] = {}
    for ev in tracer.events():
        lanes.setdefault(ev.lane, len(lanes))
    records: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    for lane, tid in lanes.items():
        records.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": lane}})
        # sort_index keeps lane order stable in the Perfetto UI
        records.append({"name": "thread_sort_index", "ph": "M",
                        "pid": pid, "tid": tid,
                        "args": {"sort_index": tid}})
    by_lane: Dict[str, List[TraceEvent]] = {}
    for ev in tracer.events():
        by_lane.setdefault(ev.lane, []).append(ev)
    for lane, evs in by_lane.items():
        tid = lanes[lane]
        for ev in sorted(evs, key=lambda e: (e.t0_ns, e.span_id)):
            rec = {"name": ev.name, "pid": pid, "tid": tid,
                   "ts": _us(tracer, ev.t0_ns, t_origin_ns),
                   "args": _jsonable_args(ev.args)}
            if ev.kind == "span":
                rec["ph"] = "X"
                rec["dur"] = max(0.0, ev.dur_ns / 1e3)
                if ev.parent_id is not None:
                    rec["args"]["parent"] = ev.parent_id
                rec["args"]["id"] = ev.span_id
            else:
                rec["ph"] = "i"
                rec["s"] = "t"
            records.append(rec)
    return records


def chrome_trace_dict(tracer: Tracer,
                      metrics: Optional[MetricsRegistry] = None, *,
                      pid: int = PID,
                      process_name: str = PROCESS_NAME) -> dict:
    """Build the Chrome trace object without writing it (tests)."""
    records = _process_records(tracer, pid=pid, process_name=process_name)
    meta = {"traceEvents": records, "displayTimeUnit": "ms"}
    if metrics is not None:
        meta["metrics"] = metrics.snapshot()
    return meta


def merged_chrome_trace_dict(named_tracers,
                             metrics: Optional[MetricsRegistry] = None
                             ) -> dict:
    """Merge N tracers into one Chrome trace — one *process* (pid) with
    its own lane set per entry, as ``[(process_name, tracer), ...]``.

    All processes share a common time origin (the earliest tracer
    origin), so fleet traces line replicas up on one timeline in
    Perfetto.  Per-lane ``ts`` monotonicity is preserved: each (pid,
    tid) lane is sorted independently, exactly what
    ``tools/check_trace.py`` validates.
    """
    named_tracers = list(named_tracers)
    if not named_tracers:
        raise ValueError("merged_chrome_trace_dict needs >= 1 tracer")
    origin = min(tr.t_origin_ns for _, tr in named_tracers)
    records: List[dict] = []
    for pid, (name, tr) in enumerate(named_tracers):
        records.extend(_process_records(tr, pid=pid, process_name=name,
                                        t_origin_ns=origin))
    meta = {"traceEvents": records, "displayTimeUnit": "ms"}
    if metrics is not None:
        meta["metrics"] = metrics.snapshot()
    return meta


def write_chrome_trace(path, tracer: Tracer,
                       metrics: Optional[MetricsRegistry] = None) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace_dict(tracer, metrics)))
    return path


def jsonl_lines(tracer: Tracer,
                metrics: Optional[MetricsRegistry] = None) -> List[str]:
    lines = [json.dumps({"kind": "header", "format": "tracekit.v1",
                         "clock": "monotonic_us"})]
    for ev in sorted(tracer.events(), key=lambda e: (e.t0_ns, e.span_id)):
        rec = {"kind": ev.kind, "name": ev.name, "lane": ev.lane,
               "ts_us": _us(tracer, ev.t0_ns), "id": ev.span_id,
               "args": _jsonable_args(ev.args)}
        if ev.kind == "span":
            rec["dur_us"] = max(0.0, ev.dur_ns / 1e3)
            rec["parent"] = ev.parent_id
        lines.append(json.dumps(rec))
    if metrics is not None:
        for name, val in sorted(metrics.snapshot().items()):
            lines.append(json.dumps(
                {"kind": "metric", "name": name, "value": val}))
    return lines


def write_jsonl(path, tracer: Tracer,
                metrics: Optional[MetricsRegistry] = None) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(jsonl_lines(tracer, metrics)) + "\n")
    return path


def write_metrics_text(path, metrics: MetricsRegistry) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(metrics.dump_text() + "\n")
    return path


def write_trace(path, tracer: Tracer,
                metrics: Optional[MetricsRegistry] = None) -> Path:
    """Format by extension: ``.jsonl`` -> JSONL event log, anything
    else -> Chrome/Perfetto trace JSON (the ``--trace`` flag contract)."""
    if str(path).endswith(".jsonl"):
        return write_jsonl(path, tracer, metrics)
    return write_chrome_trace(path, tracer, metrics)


def load_trace_file(path) -> List[dict]:
    """Load either exported format back into a flat list of event
    dicts (validation + round-trip tests)."""
    path = Path(path)
    text = path.read_text()
    if str(path).endswith(".jsonl"):
        return [json.loads(line) for line in text.splitlines() if line]
    obj = json.loads(text)
    return obj["traceEvents"] if isinstance(obj, dict) else obj
