"""TrainerCore: the functional init/step/state protocol every trainer
obeys (counterpart of ``repro.trainers.api``).

    init(generator, params)  -> TrainState
    step(state, batch)       -> (TrainState, metrics)
    memory_report(state)     -> {bytes per component}

A ``TrainState`` splits into an **array tree** (``arrays``: the
checkpoint payload, tensors) and **host meta** (``meta``: JSON values —
for BlockLLM the norm dictionary, visit counts, plan indices, loss
history).  The train loop, the launcher and the checkpoint path are
generic over it, with the same leaf names and manifest as the JAX
package, so a JAX checkpoint resumes in the port.

Where JAX donates array groups to its jitted step, the port's step
updates them in place: after ``step(state, batch)`` treat the input
state as consumed (``state_spec.donate`` names the groups).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_names

Pytree = Any
Metrics = Dict[str, Any]

# host meta keeps a bounded loss window (patience triggers, logging)
HISTORY_CAP = 256

_DISTRIBUTED = ("distributed lowering is not ported yet (ROADMAP queue "
                "A10: distributed + tooling)")


@dataclass
class TrainState:
    """The whole of a trainer's mutable state: ``arrays`` (named tensor
    tree groups, keys from ``state_spec.arrays``) and ``meta`` (flat JSON
    host values).  ``step`` consumes the groups in ``state_spec.donate``
    (updated in place)."""
    arrays: Dict[str, Pytree]
    meta: Dict[str, Any]


@dataclass(frozen=True)
class StateSpec:
    """Declared shape of a core's ``TrainState``: the key sets of both
    halves, the array groups the step consumes, and each group's role."""
    arrays: Tuple[str, ...]
    meta: Tuple[str, ...]
    donate: Tuple[str, ...] = ()
    roles: Tuple[Tuple[str, str], ...] = ()


class TrainerCore:
    """Base class for functional trainers: configuration and caches only;
    all mutable training state lives in the ``TrainState``."""

    name: str = "?"
    state_spec: StateSpec = StateSpec(arrays=(), meta=())
    device: torch.device

    def init(self, generator: Optional[torch.Generator] = None,
             params: Optional[Pytree] = None) -> TrainState:
        raise NotImplementedError

    def step(self, state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        """Default transition for arrays-only cores: ``_raw_step``, then
        the step counter and the bounded loss history."""
        arrays, loss, _ = self._raw_step(state.arrays, self.to_device(batch))
        loss = float(loss)
        meta = dict(state.meta)
        meta["step"] = int(meta["step"]) + 1
        meta["loss_history"] = (list(state.meta["loss_history"])
                                + [loss])[-HISTORY_CAP:]
        return TrainState(arrays, meta), {"loss": loss, "step": meta["step"]}

    def memory_report(self, state: TrainState) -> Dict[str, int]:
        raise NotImplementedError

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        """The batch's arrays as tensors on the core's device."""
        return {k: (v if isinstance(v, torch.Tensor) else torch.tensor(v))
                .to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def merged_params(self, state: TrainState) -> Pytree:
        """Full, inference-ready parameter tree (adapter-export hook)."""
        return state.arrays["params"]

    @torch.no_grad()
    def eval_loss(self, state: TrainState, batch) -> float:
        loss, _ = self._loss_fn(self.merged_params(state),
                                self.to_device(batch))
        return float(loss)

    def init_abstract(self, params_abstract: Pytree) -> TrainState:
        raise NotImplementedError(_DISTRIBUTED)

    def lowerable(self, state: TrainState, batch):
        raise NotImplementedError(_DISTRIBUTED)

    def _init_meta(self) -> Dict[str, Any]:
        return {"step": 0, "loss_history": []}

    def _raw_step(self, arrays: Dict[str, Pytree], batch):
        """Array transition ``(arrays, batch) -> (arrays', loss,
        metrics)``."""
        raise NotImplementedError


def nbytes(tree: Pytree) -> int:
    return sum(l.nbytes for l in _flatten_with_names(tree)[1])


def jsonable(obj):
    """Recursively coerce numpy / tensor values so ``meta`` survives
    ``json.dumps`` (the checkpoint manifest is JSON)."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def check_state(core: TrainerCore, state: TrainState):
    """Raise unless a state honors the core's declared spec: exact key
    split, JSON-able meta, tensor-only leaves in ``arrays``."""
    spec = core.state_spec
    if set(state.arrays) != set(spec.arrays):
        raise ValueError((core.name, sorted(state.arrays), spec.arrays))
    if set(state.meta) != set(spec.meta):
        raise ValueError((core.name, sorted(state.meta), spec.meta))
    json.dumps(jsonable(state.meta))  # raises if not serializable
    for leaf in _flatten_with_names(state.arrays)[1]:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"{core.name}: non-tensor leaf {leaf!r}")
    for k in spec.donate:
        if k not in spec.arrays:
            raise ValueError((core.name, k))


class TrainerHandle:
    """Pairs a core with one state — the object imperative callers (the
    train loop, examples, tests) hold.  Unknown attributes fall through
    to the core (``adam``, ``bcfg``, ``recompiles``, ...)."""

    def __init__(self, core: TrainerCore, state: TrainState):
        self.core = core
        self.state = state

    def train_step(self, batch) -> Metrics:
        self.state, metrics = self.core.step(self.state, batch)
        return metrics

    def memory_report(self) -> Dict[str, int]:
        return self.core.memory_report(self.state)

    def merged_params(self) -> Pytree:
        return self.core.merged_params(self.state)

    def eval_loss(self, batch) -> float:
        return self.core.eval_loss(self.state, batch)

    def reselect(self) -> None:
        """Force a coordinate-block re-selection (BlockLLM cores)."""
        self.state = self.core.reselect(self.state)

    @property
    def cfg(self):
        return self.core.cfg

    @property
    def step(self) -> int:
        return int(self.state.meta.get("step", 0))

    @property
    def loss_history(self):
        return self.state.meta.get("loss_history", [])

    @property
    def params(self) -> Pytree:
        return self.state.arrays["params"]

    @property
    def opt_state(self):
        return self.state.arrays["opt"]

    @property
    def masks(self) -> Pytree:
        return self.state.arrays["masks"]

    @property
    def active(self) -> Dict[str, Pytree]:
        return {"sel": self.state.arrays["sel"],
                "probe": self.state.arrays["probe"]}

    @property
    def plan(self):
        return self.core.plan_of(self.state)

    @property
    def q(self) -> float:
        return float(self.state.meta["q"])

    @property
    def index(self):
        return self.core.index_for(self.state.arrays["params"])

    @property
    def reselections(self) -> int:
        return int(self.state.meta["reselections"])

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.core, name)
