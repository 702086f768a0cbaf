"""ElasticFleet: replica health, the failure contract and fault
injection (a copy of ``repro.runtime.elastic``, which imports no JAX,
over the port's registry, ``ServeConfig`` and straggler rule).

The Router (``runtime/fleet.py``) composes these pieces:

- ``ReplicaHealth``: per-replica step-time EMAs against the fleet
  median (``straggler.flagged_vs_median``) flag a **straggler**; a
  replica that holds work but makes no progress for ``wedge_rounds``
  consecutive rounds is **wedged**, and the Router fences it and
  replays its in-flight requests on peers (``Request.replay_clone``).
- ``ReplicaFailure`` / ``ReplicaKilled``: a ``Replica.step`` that
  raises ``ReplicaFailure`` fences that replica instead of crashing the
  fleet.
- ``FaultPlan``: seeded, deterministic fault injection from compact
  specs, ``;``-separated::

      kill:replica1@round12            step raises ReplicaKilled
      wedge:replica0@round5            steps stop making progress
      slow:replica1@round3:3x          replica runs 3x slower
      adapter_read_error:n=2           first 2 registry reads fail
      adapter_read_error:p=0.2         each read fails w.p. 0.2 (seeded)

  It acts at two hooks only: ``Replica.step`` (kill / wedge / slow) and
  the registry's read path (``registry.fault_hook`` ->
  ``read_with_retry``).  ``slow`` skips rounds (the replica steps every
  F-th round) and, for every replica, reports a synthetic step time (1
  ms, F ms for the slowed one), so the straggler flag is decided by
  rounds, not by the wall clock.

Determinism: with a fixed seed and request set, every FaultPlan leg
fences the same replica at the same round and replays the same
requests, so chaos legs compare token streams bitwise.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.adapters.registry import AdapterReadError
from repro_torch.runtime.serve_config import FleetConfig
from repro_torch.runtime.straggler import ema_update, flagged_vs_median


class ReplicaFailure(RuntimeError):
    """A replica failed mid-step; the Router fences it and fails over."""


class ReplicaKilled(ReplicaFailure):
    """Injected hard death (FaultPlan ``kill``)."""


# ---------------------------------------------------------------------- #
# fault injection
# ---------------------------------------------------------------------- #

_STEP_SPEC = re.compile(
    r"^(?P<kind>kill|wedge|slow):(?P<target>[^@:]+)@round(?P<round>\d+)"
    r"(?::(?P<factor>\d+(?:\.\d+)?)x)?$")
_READ_SPEC = re.compile(
    r"^adapter_read_error:(?:n=(?P<n>\d+)|p=(?P<p>0?\.\d+|1(?:\.0*)?))$")


@dataclass
class FaultSpec:
    kind: str                  # kill | wedge | slow | adapter_read_error
    target: str = ""           # replica name, or "any"
    round: int = 0             # fires once the fleet completed N rounds
    factor: float = 1.0        # slow: slowdown multiple
    count: int = 0             # adapter_read_error: first n reads fail
    prob: float = 0.0          # adapter_read_error: per-read probability


class FaultPlan:
    """A parsed, seeded fault schedule.  Query ``action``/``step_ms``
    from ``Replica.step``; install ``read_hook`` on a registry via
    ``install_registry_hook``.  All state advances deterministically."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._killed: set = set()
        self._read_errors_left = sum(s.count for s in self.specs
                                     if s.kind == "adapter_read_error")
        self._read_prob = max((s.prob for s in self.specs
                               if s.kind == "adapter_read_error"),
                              default=0.0)
        # slow legs switch health observation to a synthetic clock so
        # the EMA/median flag is deterministic, not wall-jitter-driven
        self._synthetic_clock = any(s.kind == "slow" for s in self.specs)
        self.injected: Dict[str, int] = {"kill": 0, "wedge": 0,
                                         "slow": 0, "read_error": 0}

    @classmethod
    def parse(cls, text: Optional[str], seed: int = 0) -> "FaultPlan":
        """Parse ``;``-separated fault entries (see module docstring);
        an empty/None ``text`` yields an inert plan."""
        specs: List[FaultSpec] = []
        for raw in (text or "").split(";"):
            entry = raw.strip()
            if not entry:
                continue
            m = _STEP_SPEC.match(entry)
            if m is not None:
                kind = m.group("kind")
                factor = float(m.group("factor") or 1.0)
                if kind == "slow" and factor <= 1.0:
                    raise ValueError(
                        f"slow fault needs a factor > 1x: {entry!r}")
                if kind != "slow" and m.group("factor"):
                    raise ValueError(
                        f"only slow faults take a factor: {entry!r}")
                specs.append(FaultSpec(kind=kind,
                                       target=m.group("target"),
                                       round=int(m.group("round")),
                                       factor=factor))
                continue
            m = _READ_SPEC.match(entry)
            if m is not None:
                specs.append(FaultSpec(
                    kind="adapter_read_error",
                    count=int(m.group("n") or 0),
                    prob=float(m.group("p") or 0.0)))
                continue
            raise ValueError(
                f"unparseable fault spec {entry!r} (expected e.g. "
                f"'kill:replica1@round12', 'wedge:replica0@round5', "
                f"'slow:replica1@round3:3x', 'adapter_read_error:n=2')")
        return cls(specs, seed=seed)

    def __bool__(self) -> bool:
        return bool(self.specs)

    def _matches(self, spec: FaultSpec, name: str, rnd: int) -> bool:
        if rnd < spec.round:
            return False
        if spec.target == "any":
            return True
        return spec.target == name

    def action(self, name: str, rnd: int) -> str:
        """What ``Replica.step`` should do for ``name`` at fleet round
        ``rnd``: ``run`` | ``kill`` (raise) | ``wedge`` (no progress)
        | ``stall`` (slow replica's skipped round)."""
        for spec in self.specs:
            if spec.kind == "kill" and name not in self._killed \
                    and self._matches(spec, name, rnd):
                # "any" kills the first replica queried at/after the
                # round — deterministic under the Router's fixed
                # iteration order
                self._killed.add(name)
                self.injected["kill"] += 1
                return "kill"
            if spec.kind == "wedge" and self._matches(spec, name, rnd):
                self.injected["wedge"] += 1
                return "wedge"
            if spec.kind == "slow" and self._matches(spec, name, rnd):
                if (rnd - spec.round) % max(1, int(round(spec.factor))):
                    self.injected["slow"] += 1
                    return "stall"
        return "run"

    def step_ms(self, name: str, rnd: int, real_ms: float) -> float:
        """The step time health should observe.  Slow legs use a
        synthetic 1ms base so the EMA/median flag is deterministic;
        the slowed replica reports ``factor`` x that."""
        if not self._synthetic_clock:
            return real_ms
        ms = 1.0
        for spec in self.specs:
            if spec.kind == "slow" and self._matches(spec, name, rnd):
                ms *= spec.factor
        return ms

    # -- registry read-path injection ---------------------------------- #

    def read_hook(self, adapter_id: str) -> None:
        """Raise a transient ``AdapterReadError`` per the plan; wired
        as ``registry.fault_hook`` so it fires inside the retrying read
        path (``read_with_retry``)."""
        if self._read_errors_left > 0:
            self._read_errors_left -= 1
            self.injected["read_error"] += 1
            raise AdapterReadError(
                f"injected transient read failure for {adapter_id!r} "
                f"({self._read_errors_left} left in plan)")
        if self._read_prob > 0 and self._rng.random() < self._read_prob:
            self.injected["read_error"] += 1
            raise AdapterReadError(
                f"injected probabilistic read failure for "
                f"{adapter_id!r} (p={self._read_prob})")

    def install_registry_hook(self, registry) -> None:
        """Attach ``read_hook`` to any registry exposing the
        ``fault_hook`` attribute (both registry flavors do)."""
        if registry is not None and hasattr(registry, "fault_hook") \
                and any(s.kind == "adapter_read_error"
                        for s in self.specs):
            registry.fault_hook = self.read_hook


# ---------------------------------------------------------------------- #
# replica health
# ---------------------------------------------------------------------- #


@dataclass
class _HealthState:
    ema_ms: Optional[float] = None
    rounds: int = 0            # rounds with a step-time observation
    no_progress: int = 0       # consecutive no-progress-with-work rounds
    state: str = "ok"          # ok | slow | wedged (last assessment)
    flags: int = field(default=0)   # rounds spent flagged slow


class ReplicaHealth:
    """Per-replica serve-side health: ``StragglerMonitor``'s EMA/median
    straggler rule generalized to N replicas the Router observes from
    outside, plus wedge detection from the progress signal.

    The Router feeds one ``observe`` per replica per round (step time
    when the replica stepped, ``progressed=False`` when it held work
    but its ``_progress_key`` did not move) and acts on ``assess``:
    ``wedged`` replicas get fenced; ``slow`` ones only flagged — work
    stealing already rebalances their queues, and a slowdown hard
    enough to matter escalates to a wedge-fence on its own.
    """

    def __init__(self, cfg: Optional[FleetConfig] = None):
        self.cfg = cfg if cfg is not None else FleetConfig()
        self._state: Dict[str, _HealthState] = {}

    def observe(self, name: str, *, step_ms: Optional[float] = None,
                progressed: bool = True, has_work: bool = True) -> None:
        st = self._state.setdefault(name, _HealthState())
        if step_ms is not None:
            st.ema_ms = ema_update(st.ema_ms, float(step_ms),
                                   self.cfg.ema_alpha)
            st.rounds += 1
        if has_work and not progressed:
            st.no_progress += 1
        elif progressed:
            st.no_progress = 0

    def assess(self) -> Dict[str, str]:
        """``name -> "ok" | "slow" | "wedged"`` under the current EMAs.
        Wedge wins over slow; warmup suppresses the slow flag only —
        a wedge is a hard progress fact, not a noisy timing one."""
        warmed = [st.ema_ms for st in self._state.values()
                  if st.ema_ms is not None
                  and st.rounds >= self.cfg.warmup_rounds]
        out: Dict[str, str] = {}
        for name, st in self._state.items():
            if st.no_progress >= self.cfg.wedge_rounds:
                st.state = "wedged"
            elif (st.ema_ms is not None
                  and st.rounds >= self.cfg.warmup_rounds and warmed
                  and flagged_vs_median(st.ema_ms, warmed,
                                        self.cfg.slow_threshold)):
                st.state = "slow"
                st.flags += 1
            else:
                st.state = "ok"
            out[name] = st.state
        return out

    def forget(self, name: str) -> None:
        self._state.pop(name, None)

    def last_state(self, name: str) -> str:
        st = self._state.get(name)
        return st.state if st is not None else "ok"

    def no_progress_rounds(self, name: str) -> int:
        st = self._state.get(name)
        return st.no_progress if st is not None else 0

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Per-replica health stats (the ``stats()["fleet"]["health"]``
        section and the launcher's health dump)."""
        return {name: {"ema_ms": (round(st.ema_ms, 4)
                                  if st.ema_ms is not None else None),
                       "rounds": st.rounds,
                       "no_progress": st.no_progress,
                       "state": st.state,
                       "slow_flags": st.flags}
                for name, st in self._state.items()}
