"""GaLore baseline as a ``TrainerCore`` (counterpart of
``repro.trainers.galore``): arrays ``{params, opt}`` (``opt`` is the
``GaLoreState``: projections + projected moments), host meta ``{step,
loss_history}``.  The optimizer math is ``baselines.galore.GaLore``.
The step updates ``params`` and ``opt`` in place (JAX donates both).

Under a ``shard_ctx`` mesh the gradients take the data mean
(``shard_ctx.reduce_grads``) and the GaLore state stays whole on every
rank: its projection refresh is an SVD of the whole gradient matrix.
A model axis above 1 is refused (ROADMAP queue A, item 4b)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.baselines.galore import GaLore
from repro_torch.checkpoint.checkpointer import _flatten_with_names, tree_map
from repro_torch.models import model as model_lib
from repro_torch.runtime import shard_ctx
from repro_torch.trainers.api import StateSpec, TrainerCore, TrainState, nbytes
from repro_torch.trainers.registry import register

Pytree = Any


class GaLoreCore(TrainerCore):
    name = "galore"
    state_spec = StateSpec(
        arrays=("params", "opt"),
        meta=("step", "loss_history"),
        donate=("params", "opt"),
        roles=(("params", "params"), ("opt", "opt")),
    )

    def __init__(self, cfg, *, galore: Optional[GaLore] = None, loss_fn=None,
                 attn_impl: str = "full", device=None):
        self.cfg = cfg
        self.device = model_lib.resolve_device(device)
        self.galore = galore or GaLore()
        self._loss_fn = loss_fn or (lambda p, b: model_lib.loss_fn(
            p, cfg, b, attn_impl=attn_impl))

    def init(self, generator: Optional[torch.Generator] = None,
             params: Optional[Pytree] = None) -> TrainState:
        if params is None:
            params = model_lib.init_params(self.cfg, generator=generator,
                                           device=self.device)
        params = tree_map(lambda a: a.to(self.device), params)
        return TrainState({"params": params, "opt": self.galore.init(params)},
                          self._init_meta())

    def _raw_step(self, arrays, batch):
        ctx = shard_ctx.get()
        if ctx is not None and ctx.tp_size > 1:
            raise NotImplementedError(
                "galore under tensor parallelism: the projection's SVD needs "
                "the whole gradient matrix (ROADMAP queue A, item 4b)")
        _, leaves, td = _flatten_with_names(arrays["params"])
        req = [l.detach().requires_grad_() for l in leaves]
        loss, metrics = self._loss_fn(td.unflatten(req), batch)
        grads = torch.autograd.grad(loss, req)
        del req
        grads = td.unflatten(shard_ctx.reduce_grads(list(grads)))
        params, opt = self.galore.update(grads, arrays["opt"],
                                         arrays["params"])
        loss, metrics = shard_ctx.reduce_metrics(loss.detach(), metrics)
        return {"params": params, "opt": opt}, loss, metrics

    def memory_report(self, state: TrainState) -> Dict[str, int]:
        report = {
            "params_bytes": nbytes(state.arrays["params"]),
            "grads_bytes": nbytes(state.arrays["params"]),
            "opt_state_bytes": self.galore.state_bytes(state.arrays["opt"]),
            "mask_bytes": 0, "probe_bytes": 0,
        }
        report["total_train_state"] = sum(
            v for k, v in report.items() if k != "params_bytes")
        return report


@register("galore")
def make_galore(cfg, *, galore=None, loss_fn=None, attn_impl="full",
                rank=8, lr=1e-3, update_proj_gap=200, device=None,
                **_) -> GaLoreCore:
    if galore is None:
        galore = GaLore(rank=rank, lr=lr, update_proj_gap=update_proj_gap)
    return GaLoreCore(cfg, galore=galore, loss_fn=loss_fn,
                      attn_impl=attn_impl, device=device)
