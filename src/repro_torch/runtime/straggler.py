"""Straggler detection & mitigation hooks (a copy of the JAX package's
straggler module, which imports no JAX).

On a real multi-host deployment every host runs this monitor around its
train step.  Mitigations are deliberately mechanism-not-policy:

- **detect**: per-step wall-time EMA + deviation; a host whose step time
  exceeds ``threshold x`` the fleet median (gathered via the lightweight
  all-gather in ``fleet_sync``, or fed externally) is flagged.
- **mitigate**:
  * ``skip_data``   — the flagged host serves a zero-weight batch (its
    gradient contribution masks to zero; the all-reduce stays collective-
    complete so nothing deadlocks) — implemented via the loss mask.
  * ``checkpoint_and_exit`` — cooperative eviction: flush a checkpoint
    and exit with a distinct code so the scheduler can replace the node.

On this single-host container the fleet is simulated (tests inject fake
timings); the decision logic is identical.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class StragglerConfig:
    ema_alpha: float = 0.1
    threshold: float = 2.0        # x median
    warmup_steps: int = 5
    action: str = "skip_data"     # skip_data | checkpoint_and_exit | none


def ema_update(ema: Optional[float], sample: float,
               alpha: float) -> float:
    """One exponential-moving-average step (first sample seeds it)."""
    return sample if ema is None else alpha * sample + (1 - alpha) * ema


def flagged_vs_median(ema: float, fleet_emas: List[float],
                      threshold: float) -> bool:
    """The fleet-median straggler rule, shared by this monitor and the
    serve-side ``ReplicaHealth`` (runtime/elastic.py): flagged when the
    host's EMA exceeds ``threshold`` x the fleet median.  A single host
    (or all-equal EMAs) can never be flagged — its EMA IS the median
    and ``threshold > 1``."""
    med = sorted(fleet_emas)[len(fleet_emas) // 2]
    return ema > threshold * max(med, 1e-9)


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig(),
                 num_hosts: int = 1, host_id: int = 0):
        self.cfg = cfg
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.ema: Optional[float] = None
        self.steps = 0
        self.flagged = False
        self._t0: Optional[float] = None

    def step_begin(self):
        self._t0 = time.monotonic()

    def step_end(self, fleet_emas: Optional[List[float]] = None) -> str:
        """Returns the action to take: 'none' | 'skip_data' | 'evict'."""
        dt = time.monotonic() - self._t0
        self.ema = ema_update(self.ema, dt, self.cfg.ema_alpha)
        self.steps += 1
        if self.steps < self.cfg.warmup_steps:
            return "none"
        emas = fleet_emas if fleet_emas is not None else [self.ema]
        self.flagged = flagged_vs_median(self.ema, emas,
                                         self.cfg.threshold)
        if not self.flagged or self.cfg.action == "none":
            return "none"
        if self.cfg.action == "skip_data":
            return "skip_data"
        return "evict"
