"""Full-Adam reference trainer as a ``TrainerCore`` (counterpart of
``repro.trainers.full_adam``): dense gradients and dense moments, the
paper's memory baseline.  ``adam+q8`` stores the moments as int8 blocks
+ f32 scales (``optim.q8adam``).  The step updates ``params`` and
``opt`` in place (JAX donates both); under a ``shard_ctx`` mesh the
moments are ZeRO chunks (``optim.zero.adam_step``)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_names, tree_map
from repro_torch.models import model as model_lib
from repro_torch.optim import zero as zero_lib
from repro_torch.optim.adam import Adam
from repro_torch.runtime import shard_ctx
from repro_torch.optim.q8adam import Q8Adam, is_quantized
from repro_torch.trainers.api import StateSpec, TrainerCore, TrainState, nbytes
from repro_torch.trainers.registry import register

Pytree = Any


class FullAdamCore(TrainerCore):
    name = "adam"
    state_spec = StateSpec(
        arrays=("params", "opt"),
        meta=("step", "loss_history"),
        donate=("params", "opt"),
        roles=(("params", "params"), ("opt", "opt")),
    )

    def __init__(self, cfg, *, adam: Optional[Adam] = None, loss_fn=None,
                 attn_impl: str = "full", quantize_state: bool = False,
                 device=None):
        self.cfg = cfg
        self.device = model_lib.resolve_device(device)
        self.adam = adam or Adam(lr=1e-3)
        if quantize_state and not is_quantized(self.adam):
            self.adam = Q8Adam(self.adam)
        self.quantize_state = quantize_state
        self._loss_fn = loss_fn or (lambda p, b: model_lib.loss_fn(
            p, cfg, b, attn_impl=attn_impl))

    def init(self, generator: Optional[torch.Generator] = None,
             params: Optional[Pytree] = None) -> TrainState:
        if params is None:
            params = model_lib.init_params(self.cfg, generator=generator,
                                           device=self.device)
        params = tree_map(lambda a: a.to(self.device), params)
        return TrainState({"params": params, "opt": self.adam.init(params)},
                          self._init_meta())

    def _raw_step(self, arrays, batch):
        _, leaves, td = _flatten_with_names(arrays["params"])
        req = [l.detach().requires_grad_() for l in leaves]
        loss, metrics = self._loss_fn(td.unflatten(req), batch)
        grads = td.unflatten(list(torch.autograd.grad(loss, req)))
        del req
        with torch.no_grad():
            params, opt, _, _ = zero_lib.adam_step(
                self.adam, grads, arrays["opt"], arrays["params"])
        loss, metrics = shard_ctx.reduce_metrics(loss.detach(), metrics)
        return {"params": params, "opt": opt}, loss, metrics

    def memory_report(self, state: TrainState) -> Dict[str, int]:
        report = {
            "params_bytes": nbytes(state.arrays["params"]),
            "grads_bytes": nbytes(state.arrays["params"]),
            "opt_state_bytes": self.adam.state_bytes(state.arrays["opt"]),
            "mask_bytes": 0, "probe_bytes": 0,
        }
        report["total_train_state"] = sum(
            v for k, v in report.items() if k != "params_bytes")
        return report


@register("adam")
def make_full_adam(cfg, *, adam=None, loss_fn=None, attn_impl="full",
                   quantize_state=False, device=None, **_) -> FullAdamCore:
    return FullAdamCore(cfg, adam=adam, loss_fn=loss_fn,
                        attn_impl=attn_impl, quantize_state=quantize_state,
                        device=device)


@register("adam+q8")
def make_full_adam_q8(cfg, **kw) -> FullAdamCore:
    """Full Adam with Q8State moments (int8 + block scales)."""
    kw["quantize_state"] = True
    return make_full_adam(cfg, **kw)
