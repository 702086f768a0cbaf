"""Fault-tolerant training loop, generic over the TrainerCore protocol
(counterpart of ``repro.runtime.train_loop``).

Wires together the step-indexed data pipeline, any trainer speaking the
``repro_torch.trainers`` protocol (a ``TrainerHandle``), atomic
checkpointing with auto-resume, straggler monitoring, simulated crashes
and BlockDelta adapter export.  One checkpoint path for every trainer:
the state's array tree goes into the npz payload, its host meta into the
manifest, in the JAX package's format (a JAX checkpoint resumes here).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional

from repro_torch.checkpoint import checkpointer as ckpt_lib
from repro_torch.obs import StepEmitter
from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor
from repro_torch.trainers.api import TrainState, jsonable


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    log_every: int = 10
    # TraceKit: dump the metrics registry as text every N steps (0: off)
    metrics_every: int = 0
    straggler: StragglerConfig = dataclasses.field(
        default_factory=lambda: StragglerConfig(action="none"))
    # BlockDelta export: at every checkpoint (and at run end) diff the
    # trainer's merged params against the pre-finetune base and publish
    # the row-sparse delta to an adapter registry
    adapter_dir: Optional[str] = None
    adapter_id: str = "adapter"
    # int8-quantize exported delta payloads (rows -> int8 codec blocks +
    # f32 scales; about 4x smaller registry entries, dequantized on apply)
    quantize_deltas: bool = False


def _protocol_state(trainer) -> TrainState:
    st = getattr(trainer, "state", None)
    if not isinstance(st, TrainState):
        raise TypeError("the train loop drives TrainerCore handles "
                        "(trainers.handle / TrainerHandle)")
    return st


def _save_ckpt(trainer, cfg: TrainLoopConfig, step: int):
    st = _protocol_state(trainer)
    meta = {"trainer": getattr(trainer.core, "name", "?"),
            "host": jsonable(st.meta)}
    ckpt_lib.save(cfg.ckpt_dir, step, st.arrays, meta=meta,
                  keep=cfg.keep_ckpts)


def _restore_ckpt(trainer, cfg: TrainLoopConfig, step: int):
    st = _protocol_state(trainer)
    # validate the manifest before loading arrays
    meta = ckpt_lib.read_meta(cfg.ckpt_dir, step)
    if "host" not in meta:
        raise ValueError(
            f"checkpoint step {step} in {cfg.ckpt_dir} has no 'host' "
            "meta — it predates the TrainerCore checkpoint format and "
            "cannot be resumed by this loop")
    saved = meta.get("trainer")
    name = getattr(trainer.core, "name", "?")
    if saved is not None and saved != name:
        raise ValueError(
            f"checkpoint step {step} was written by trainer "
            f"{saved!r} but the active trainer is {name!r}")
    arrays, _ = ckpt_lib.restore(cfg.ckpt_dir, step, st.arrays)
    trainer.state = TrainState(arrays, dict(meta["host"]))


def run(trainer, batch_fn: Callable[[int], dict], cfg: TrainLoopConfig,
        *, on_step: Optional[Callable[[int, Dict], None]] = None,
        crash_at: Optional[int] = None, tracer=None, metrics=None,
        emitter: Optional[StepEmitter] = None) -> Dict:
    """Run (or resume) training.  ``batch_fn(step) -> batch``.

    ``crash_at``: raise at that step after the state changed — the
    fault-tolerance tests prove checkpoint/restart recovers exactly.
    Returns ``{"losses", "final_step", "step_ms"}``: ``step_ms`` is the
    host wall time of each step run here (every trainer step ends in a
    host read of its loss, so the time covers the device work)."""
    start_step = 0
    if cfg.ckpt_dir:
        latest = ckpt_lib.latest_step(cfg.ckpt_dir)
        if latest is not None:
            _restore_ckpt(trainer, cfg, latest)
            start_step = latest

    emit = emitter if emitter is not None else StepEmitter(
        log_every=cfg.log_every, tracer=tracer, metrics=metrics,
        metrics_every=cfg.metrics_every)
    export = _AdapterExporter.maybe(trainer, cfg, start_step, emitter=emit)
    mon = StragglerMonitor(cfg.straggler)
    history, step_ms = [], []
    for step in range(start_step, cfg.total_steps):
        mon.step_begin()
        t0 = time.monotonic()
        if tracer is None:
            batch = batch_fn(step)
            metrics_d = trainer.train_step(batch)
        else:
            with tracer.span("data", lane="data", step=step + 1):
                batch = batch_fn(step)
            with tracer.span("train_step", lane="step", step=step + 1):
                metrics_d = trainer.train_step(batch)
        step_ms.append((time.monotonic() - t0) * 1e3)
        action = mon.step_end()
        metrics_d["straggler_action"] = action
        history.append(metrics_d["loss"])
        if on_step:
            on_step(step, metrics_d)
        emit.on_step(step + 1, metrics_d)
        if cfg.ckpt_dir and (step + 1) % cfg.ckpt_every == 0:
            if tracer is None:
                _save_ckpt(trainer, cfg, step + 1)
            else:
                with tracer.span("checkpoint", lane="ckpt", step=step + 1):
                    _save_ckpt(trainer, cfg, step + 1)
            if export:
                if tracer is None:
                    export.emit(trainer, step + 1)
                else:
                    with tracer.span("adapter_export", lane="export",
                                     step=step + 1):
                        export.emit(trainer, step + 1)
        if crash_at is not None and step + 1 == crash_at:
            raise RuntimeError(f"simulated node failure at step {step + 1}")
    if export:
        export.emit(trainer, cfg.total_steps)
    return {"losses": history, "final_step": cfg.total_steps,
            "step_ms": step_ms}


class _AdapterExporter:
    """Publishes the trainer's row-sparse delta against the pre-finetune
    base to an adapter registry at checkpoint boundaries.

    The base snapshot is a deep copy (the trainer updates its tensors in
    place, and ``reselect`` writes rows into ``params``), persisted under
    ``<adapter_dir>/_base/<adapter_id>`` on the first run and reloaded
    from there on resume.  ``quantize`` publishes int8 payloads
    (``adapters.quantize_delta``)."""

    def __init__(self, registry, base, adapter_id: str,
                 quantize: bool = False):
        self.registry = registry
        self.base = base
        self.adapter_id = adapter_id
        self.quantize = quantize
        self.last_step = -1

    @staticmethod
    def _snapshot_dir(cfg: "TrainLoopConfig") -> Path:
        # under "_base/": never listed by AdapterRegistry.list_adapters
        return Path(cfg.adapter_dir) / "_base" / cfg.adapter_id

    @staticmethod
    def maybe(trainer, cfg: "TrainLoopConfig", start_step: int,
              emitter: Optional[StepEmitter] = None):
        if not cfg.adapter_dir:
            return None
        from repro_torch.adapters import AdapterRegistry, copy_tree
        snap = _AdapterExporter._snapshot_dir(cfg)
        if start_step == 0:
            base = copy_tree(trainer.merged_params())
            ckpt_lib.save(snap, 0, base,
                          meta={"kind": "adapter-base-snapshot",
                                "adapter_id": cfg.adapter_id}, keep=1)
        else:
            if ckpt_lib.latest_step(snap) is None:
                msg = ("adapter export skipped: resume without a base "
                       "snapshot")
                if emitter is not None:
                    emitter.warn(msg, start_step=start_step)
                else:
                    print(msg, flush=True)
                return None
            base, _ = ckpt_lib.restore(snap, 0, trainer.merged_params())
        return _AdapterExporter(AdapterRegistry(cfg.adapter_dir), base,
                                cfg.adapter_id,
                                quantize=cfg.quantize_deltas)

    def emit(self, trainer, step: int):
        if step == self.last_step:
            return  # final step coincides with a checkpoint boundary
        from repro_torch.adapters import delta_from_trainer, quantize_delta
        d = delta_from_trainer(trainer, self.base,
                               meta={"step": step,
                                     "adapter_id": self.adapter_id})
        if self.quantize:
            d = quantize_delta(d)
        self.registry.put(self.adapter_id, d)
        self.last_step = step
