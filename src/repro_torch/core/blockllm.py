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

Under a ``runtime.shard_ctx`` mesh (``launch.steps``) the gradient hook
runs after ``torch.autograd.grad``: the selected rows' gradients are
reduce-scattered (the data mean) into the ZeRO chunks of their moments
and the update runs there (``optim.zero.adam_step``), the probe rows'
gradients are all-reduced, and the per-unit squared norms, the loss
and the metrics are reduced too — over the model group as well for a
model-split leaf — so every rank selects the same rows.  Only the
active rows cross the wire.
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
from repro_torch.optim import zero as zero_lib
from repro_torch.runtime import shard_ctx

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
        sel_names, sl, td_sel = _flatten_with_names(sel_g)
        probe_names, pl, td_probe = _flatten_with_names(probe_g)
        # a row's leaf the loss does not reach gets JAX's zero gradient:
        # an encoder-decoder row's xattn wk / wv, whose cross k/v come
        # from the frozen params, not the overlay (as in JAX)
        grads = torch.autograd.grad(loss, sl + pl, allow_unused=True,
                                    materialize_grads=True)
        g_sel = td_sel.unflatten(grads[:len(sl)])
        g_probe = list(grads[len(sl):])
        del sel_g, probe_g, merged, grads
        ctx = shard_ctx.get()
        if ctx is not None and refresh:
            raise NotImplementedError(
                "the mask-refresh step stays on one device: the distributed "
                "step is built with refresh=False, as JAX's lowerable")

        with torch.no_grad():
            if not refresh:
                # the gradient hook (probe rows in the same bucket) and
                # the update on this rank's ZeRO chunks
                new_masks = masks
                new_sel, new_opt, zero, g_c = zero_lib.adam_step(
                    adam, g_sel, opt_state, sel,
                    update_mask=masks if with_masks else None, fused=fused,
                    extra=g_probe)
                g_c, g_probe = g_c[:len(sl)], g_c[len(sl):]
            else:
                zero, g_c = None, _flatten_with_names(g_sel)[1]
            norm_out = _norms(ctx, sel_names, g_c, zero, probe_names,
                              g_probe)
            del g_probe

            if refresh:
                # only the update is needed: its new moments go at once
                # (two f32 copies of the selection's moments; JAX's jit
                # drops them unused)
                upds = adam.processed_grad(g_sel, opt_state)[0]

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
                new_sel, new_opt = adam.update(g_sel, opt_state, sel,
                                               update_mask=new_masks)
        loss, metrics = shard_ctx.reduce_metrics(loss.detach(), {
            k: v.detach() for k, v in metrics.items()})
        return new_sel, new_opt, new_masks, loss, metrics, norm_out

    return step


def _param_name(sel_name: str) -> str:
    """A selection / probe leaf's parameter name: ``stacks/s0/pos1/attn/
    wq`` or ``s0/pos1/attn/wq`` -> ``stages/0/pos1/attn/wq``;
    ``leaves/embed`` -> ``embed``."""
    parts = sel_name.split("/")
    if parts[0] == "leaves":
        return "/".join(parts[1:])
    if parts[0] == "stacks":
        parts = parts[1:]
    return "/".join(["stages", parts[0][1:]] + parts[1:])


def _norms(ctx, sel_names, g_sel, zero, probe_names, g_probe):
    """Per-unit squared gradient norms from the reduced gradients: each
    leaf's part summed over the ranks holding its other pieces (the data
    group for a ZeRO chunk, the model group for a model-split leaf), in
    as few all-reduces as there are such groups."""
    parts = {}   # unit -> {axes: partial [K] or scalar}

    def add(unit, name, s, chunked):
        axes = ()
        if ctx is not None:
            if chunked:
                axes += tuple(ctx.dp_axes)
            if ctx.tp_sharded(_param_name(name)):
                axes += (ctx.tp_axis,)
        by = parts.setdefault(unit, {})
        by[axes] = s if axes not in by else by[axes] + s

    for i, (name, g) in enumerate(zip(sel_names, g_sel)):
        p = name.split("/")
        sq = g.float().square()
        chunked = zero is not None and zero.dims[i] is not None
        if p[0] == "stacks":
            add(("stacks", f"{p[1]}/{p[2]}"), name,
                zero.row_sums(i, sq) if zero is not None
                else units_lib.per_row_sq_norms(g), chunked)
        else:
            add(("leaves", p[1]), name, sq.sum(), chunked)
    for name, g in zip(probe_names, g_probe):
        p = name.split("/")
        add(("probe", f"{p[0]}/{p[1]}"), name,
            units_lib.per_row_sq_norms(g), False)
    # one all-reduce per reduction group, over every unit's partial
    by_axes = {}
    for unit, by in parts.items():
        for axes, t in by.items():
            by_axes.setdefault(axes, []).append((unit, t))
    norm_out = {"stacks": {}, "leaves": {}, "probe": {}}
    for axes, items in by_axes.items():
        if axes:
            flat = shard_ctx.sum_over(torch.cat(
                [t.reshape(-1) for _, t in items]), axes)
            off = 0
            for i, (unit, t) in enumerate(items):
                items[i] = (unit, flat[off:off + t.numel()].reshape(t.shape))
                off += t.numel()
        for (kind, unit), t in items:
            prev = norm_out[kind].get(unit)
            norm_out[kind][unit] = t if prev is None else prev + t
    return norm_out
