"""LoRA baseline as a ``TrainerCore`` (counterpart of
``repro.trainers.lora``): arrays ``{params, factors, opt}`` (the base
frozen; Adam over the factor tree), host meta ``{step, loss_history}``.
The factor math is ``baselines.lora``.  The step updates ``factors`` and
``opt`` in place (JAX donates both); under a ``shard_ctx`` mesh the
moments are ZeRO chunks (``optim.zero.adam_step``).  The factors are
whole matrices, so a model axis above 1 is refused."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.baselines.lora import lora_init, lora_merge
from repro_torch.checkpoint.checkpointer import _flatten_with_names, tree_map
from repro_torch.models import model as model_lib
from repro_torch.optim import zero as zero_lib
from repro_torch.optim.adam import Adam
from repro_torch.runtime import shard_ctx
from repro_torch.trainers.api import StateSpec, TrainerCore, TrainState, nbytes
from repro_torch.trainers.registry import register

Pytree = Any


class LoRACore(TrainerCore):
    name = "lora"
    state_spec = StateSpec(
        arrays=("params", "factors", "opt"),
        meta=("step", "loss_history"),
        donate=("factors", "opt"),
        roles=(("params", "params"), ("factors", "active"),
               ("opt", "opt")),
    )

    def __init__(self, cfg, *, rank: int = 8, alpha=None,
                 adam: Optional[Adam] = None, loss_fn=None,
                 attn_impl: str = "full", device=None):
        self.cfg = cfg
        self.device = model_lib.resolve_device(device)
        self.rank = rank
        self.alpha = alpha if alpha is not None else 4 * rank
        self.adam = adam or Adam(lr=1e-3)
        self._loss_fn = loss_fn or (lambda p, b: model_lib.loss_fn(
            p, cfg, b, attn_impl=attn_impl))

    def init(self, generator: Optional[torch.Generator] = None,
             params: Optional[Pytree] = None) -> TrainState:
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        if params is None:
            params = model_lib.init_params(self.cfg, generator=generator,
                                           device=self.device)
        params = tree_map(lambda a: a.to(self.device), params)
        factors = lora_init(generator, params, self.rank)
        return TrainState({"params": params, "factors": factors,
                           "opt": self.adam.init(factors)},
                          self._init_meta())

    def _merge(self, params, factors):
        return lora_merge(params, factors, alpha=self.alpha, rank=self.rank)

    def _raw_step(self, arrays, batch):
        ctx = shard_ctx.get()
        if ctx is not None and ctx.tp_size > 1:
            raise NotImplementedError(
                "lora under tensor parallelism: the factors' product is a "
                "whole weight (ROADMAP queue A, item 4b)")
        _, leaves, td = _flatten_with_names(arrays["factors"])
        req = [l.detach().requires_grad_() for l in leaves]
        loss, metrics = self._loss_fn(
            self._merge(arrays["params"], td.unflatten(req)), batch)
        grads = td.unflatten(list(torch.autograd.grad(loss, req)))
        del req
        with torch.no_grad():
            factors, opt, _, _ = zero_lib.adam_step(
                self.adam, grads, arrays["opt"], arrays["factors"])
        loss, metrics = shard_ctx.reduce_metrics(loss.detach(), metrics)
        return ({"params": arrays["params"], "factors": factors, "opt": opt},
                loss, metrics)

    @torch.no_grad()
    def merged_params(self, state: TrainState) -> Pytree:
        return self._merge(state.arrays["params"], state.arrays["factors"])

    def memory_report(self, state: TrainState) -> Dict[str, int]:
        factors = state.arrays["factors"]
        report = {
            "params_bytes": nbytes(state.arrays["params"]) + nbytes(factors),
            "grads_bytes": nbytes(factors),
            "opt_state_bytes": self.adam.state_bytes(state.arrays["opt"]),
            "mask_bytes": 0, "probe_bytes": 0,
        }
        report["total_train_state"] = sum(
            v for k, v in report.items() if k != "params_bytes")
        return report


@register("lora")
def make_lora(cfg, *, rank=8, alpha=None, adam=None, loss_fn=None,
              attn_impl="full", device=None, **_) -> LoRACore:
    return LoRACore(cfg, rank=rank, alpha=alpha, adam=adam,
                    loss_fn=loss_fn, attn_impl=attn_impl, device=device)
