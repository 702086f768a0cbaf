"""StepEmitter: structured replacement for the train loop's ``print``
(a copy of the JAX package's ``obs.emit``).

The launcher smoke tests grep stdout for ``step N: loss=X.XXXX`` — that
exact format is preserved (with extra ``key=value`` pairs appended after
the loss), while every step additionally lands as a structured record:

- an ``instant`` event on the tracer's ``step`` lane carrying the full
  metrics dict (so the JSONL export holds per-step selection telemetry
  for every step, not just the ``log_every``-th);
- gauges/histograms in the metrics registry (``train/loss``,
  ``train/step_ms``, ``train/sel_q`` ...), dumped as text every
  ``metrics_every`` steps when set.

``warn`` replaces the ad-hoc warning prints (e.g. the adapter-export
skip) with a ``warning`` instant plus a stable ``warning: ...`` stdout
line.
"""
from __future__ import annotations

import sys
from typing import Dict, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

# metric keys promoted onto the stdout line after the loss, in order,
# when present in the step metrics
_STDOUT_EXTRAS = ("sel_q", "sel_churn", "ms")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


class StepEmitter:
    """Per-step sink for the train loop.

    ``log_every`` gates only stdout; the tracer and registry see every
    step.  All sinks are optional — with everything None/0 this is the
    old ``print``-at-``log_every`` behavior, byte-stable.
    """

    def __init__(self, *, log_every: int = 0,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 metrics_every: int = 0,
                 stream=None):
        self.log_every = int(log_every)
        self.tracer = tracer
        self.metrics = metrics
        self.metrics_every = int(metrics_every)
        self.stream = stream if stream is not None else sys.stdout

    def on_step(self, step: int, metrics: Dict[str, object]) -> None:
        """``step`` is 1-based (the step just finished)."""
        if self.tracer is not None:
            # metrics may itself carry a "step" key — the explicit
            # argument wins the merge, no duplicate kwarg
            self.tracer.instant("train_step_metrics", lane="step",
                                **{**metrics, "step": step})
        if self.metrics is not None:
            for k, v in metrics.items():
                if not isinstance(v, (int, float)):
                    continue
                if k in ("ms", "step_ms"):
                    self.metrics.histogram("train/step_ms").observe(v)
                else:
                    self.metrics.gauge(f"train/{k}").set(v)
            self.metrics.counter("train/steps").inc()
            if self.metrics_every and step % self.metrics_every == 0:
                print(f"-- metrics @ step {step} --", file=self.stream,
                      flush=True)
                print(self.metrics.dump_text(), file=self.stream,
                      flush=True)
        if self.log_every and step % self.log_every == 0:
            loss = metrics.get("loss")
            line = (f"step {step}: loss={loss:.4f}"
                    if isinstance(loss, float)
                    else f"step {step}: loss={loss}")
            extras = [f"{k}={_fmt(metrics[k])}" for k in _STDOUT_EXTRAS
                      if k in metrics]
            if extras:
                line += " " + " ".join(extras)
            print(line, file=self.stream, flush=True)

    def warn(self, message: str, **args) -> None:
        if self.tracer is not None:
            self.tracer.instant("warning", lane="step",
                                message=message, **args)
        print(f"warning: {message}", file=self.stream, flush=True)
