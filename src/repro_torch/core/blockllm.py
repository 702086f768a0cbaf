"""BlockLLM device math (paper Algorithm 1): config + the raw step fn
(counterpart of ``repro.core.blockllm``).

``build_step_fn`` returns the masked-Adam step over the *active*
parameter subset.  The orchestration (selection, probe rotation, the
loss-patience trigger) lives in ``repro_torch.trainers.blockllm``.

Memory model (the paper's contribution): gradients, Adam moments and
masks exist only for the active subset.  The step differentiates with
``torch.autograd.grad`` with respect to the active rows and leaves only
(where JAX takes ``value_and_grad(argnums=(0, 1))``); frozen parameters
do not require a gradient, so autograd never builds their backward.

In place where JAX donates: the step updates ``sel`` and the optimizer
state in place (through the kernels on the fused path) and returns
them; ``masks`` is replaced at a refresh step.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_names, tree_map
from repro_torch.core import units as units_lib
from repro_torch.core.selection import SelectorConfig
from repro_torch.core.units import Plan, PlanStructure, UnitIndex
from repro_torch.kernels import ops as kernel_ops
from repro_torch.optim.adam import AdamState
from repro_torch.optim.q8adam import Q8AdamState, is_quantized

# the JAX package's "pallas" is the port's "kernel", "interpret" its "plain"
FUSED_MODES = ("off", "auto", "kernel", "plain")


@dataclass
class BlockLLMConfig:
    selector: SelectorConfig = field(default_factory=SelectorConfig)
    mask_refresh: str = "select"   # select | never  (paper: at selection)
    quantile_sample: int = 65536   # subsample size for large-tensor quantiles
    carry_surviving: bool = False  # keep Adam state of re-selected survivors
    fused_update: str = "off"      # off | auto | kernel | plain: the fused
    #                                masked-Adam kernels (kernels.ops)

    def __post_init__(self):
        if self.fused_update not in FUSED_MODES:
            raise ValueError(
                f"fused_update must be one of {FUSED_MODES} (JAX's "
                f"'pallas' is 'kernel', 'interpret' is 'plain'), got "
                f"{self.fused_update!r}")


def _masked_quantile_threshold(u, q_keep, sample):
    """Per-row threshold tau such that |u| >= tau keeps ~q_keep of it.

    u: [K, ...] (stacked) or [...] (leaf).  Exact quantile (linear
    interpolation, as ``jnp.quantile``) for small tensors; the same
    strided subsample as the JAX package for large ones."""
    flat = u.reshape(u.shape[0], -1) if u.dim() > 1 else u.reshape(1, -1)
    n = flat.shape[1]
    if n > sample:
        stride = n // sample
        flat = flat[:, ::stride][:, :sample]
    a = flat.float().abs()
    level = float(np.clip(np.float32(1.0) - np.float32(q_keep),
                          np.float32(0), np.float32(1)))
    return torch.quantile(a, level, dim=1)


def build_step_fn(cfg, index: UnitIndex, adam, bcfg: BlockLLMConfig,
                  structure: PlanStructure, *, refresh: bool,
                  with_masks: bool, loss_fn: Callable):
    """The raw BlockLLM train step.

    Signature of the returned fn:
        step(params, sel, probe, stack_idx, probe_idx, opt_state, masks,
             batch, q) -> (new_sel, new_opt, new_masks, loss, metrics,
                           norm_out)
    ``sel`` and the optimizer state are updated in place; ``loss`` and
    the metrics and norms are detached device tensors.
    """
    supports_overlay = "overlay" in inspect.signature(loss_fn).parameters
    fused = bcfg.fused_update

    def step(params, sel, probe, stack_idx, probe_idx, opt_state, masks,
             batch, q):
        plan = Plan(structure, stack_idx, probe_idx)
        sel_g = tree_map(lambda a: a.detach().requires_grad_(), sel)
        probe_g = tree_map(lambda a: a.detach().requires_grad_(), probe)
        if not supports_overlay:  # custom loss: explicit scatter merge
            merged = units_lib.merge_active(params, index, plan,
                                            {"sel": sel_g, "probe": probe_g})
            loss, metrics = loss_fn(merged, batch)
        else:
            # stacked rows merge lazily per layer (overlay), so the
            # gradient accumulates at [K, ...]; leaf units swap in
            overlay = {}
            for sid, k in structure.k_per_stack:
                if k:
                    overlay[sid] = {"idx": stack_idx[sid].tolist(),
                                    "rows": sel_g["stacks"][sid],
                                    "pidx": None, "probe": None}
            for sid, p_ in structure.probe_per_stack:
                if p_:
                    ov = overlay.setdefault(sid, {"idx": None, "rows": None})
                    ov["pidx"] = probe_idx[sid].tolist()
                    ov["probe"] = probe_g[sid]
            merged = dict(params)
            for name, sub in sel_g["leaves"].items():
                merged[name] = sub
            loss, metrics = loss_fn(merged, batch, overlay=overlay)
        _, sl, td_sel = _flatten_with_names(sel_g)
        _, pl, td_probe = _flatten_with_names(probe_g)
        grads = torch.autograd.grad(loss, sl + pl)
        g_sel = td_sel.unflatten(grads[:len(sl)])
        g_probe = td_probe.unflatten(grads[len(sl):])
        del sel_g, probe_g, merged, grads

        with torch.no_grad():
            # per-unit gradient norms -> host norm dictionary
            norm_out = {"stacks": {}, "leaves": {}, "probe": {}}
            for sid, rows in g_sel["stacks"].items():
                norm_out["stacks"][sid] = units_lib.per_row_sq_norms(rows)
            for name, sub in g_sel["leaves"].items():
                norm_out["leaves"][name] = units_lib.subtree_sq_norm(sub)
            for sid, rows in g_probe.items():
                norm_out["probe"][sid] = units_lib.per_row_sq_norms(rows)
            del g_probe

            if refresh:
                upds, _ = adam.processed_grad(g_sel, opt_state)

                def stack_mask(u):  # per-row (= per-layer) tau
                    tau = _masked_quantile_threshold(u, q,
                                                     bcfg.quantile_sample)
                    return u.abs() >= tau.reshape((-1,) + (1,) * (u.dim()
                                                                  - 1))

                def leaf_mask(u):  # whole-leaf unit: one tau per tensor
                    tau = _masked_quantile_threshold(
                        u.reshape(1, -1), q, bcfg.quantile_sample)[0]
                    return u.abs() >= tau

                new_masks = {"stacks": tree_map(stack_mask, upds["stacks"]),
                             "leaves": tree_map(leaf_mask, upds["leaves"])}
                del upds
            else:
                new_masks = masks

            if fused != "off" and not refresh:
                mask_arg = new_masks if with_masks else None
                kw = dict(lr=adam._lr(opt_state.count), b1=adam.b1,
                          b2=adam.b2, eps=adam.eps,
                          weight_decay=adam.weight_decay,
                          count=int(opt_state.count), mode=fused)
                count = (opt_state.count + 1).to(torch.int32)
                if is_quantized(adam):
                    # moments stay int8 + scale end to end
                    kernel_ops.masked_adam_q8_tree(
                        sel, g_sel, opt_state.mu_q, opt_state.mu_scale,
                        opt_state.nu_q, opt_state.nu_scale, mask_arg, **kw)
                    new_opt = Q8AdamState(count, *opt_state[1:])
                else:
                    kernel_ops.masked_adam_tree(sel, g_sel, opt_state.mu,
                                                opt_state.nu, mask_arg, **kw)
                    new_opt = AdamState(count, opt_state.mu, opt_state.nu)
                new_sel = sel
            else:
                new_sel, new_opt = adam.update(
                    g_sel, opt_state, sel,
                    update_mask=new_masks if with_masks or refresh else None)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return new_sel, new_opt, new_masks, loss.detach(), metrics, norm_out

    return step
