"""BlockLLM as a ``TrainerCore`` (paper Algorithm 1 over explicit state;
counterpart of ``repro.trainers.blockllm``).

The device math is ``core.blockllm.build_step_fn``; this module is the
orchestration — selection, probe rotation, the loss-patience trigger —
over a ``TrainState`` whose host quantities (norm dictionary, visit
counts, plan indices, loss history, the mask-refresh flag) are JSON meta,
so the generic checkpoint path resumes BlockLLM bit-exactly.

State layout (``BlockLLMCore.state_spec``):

- arrays: ``params`` (full frozen tree), ``sel`` (active rows/leaves),
  ``probe`` (rotating probe rows), ``opt`` (Adam moments over ``sel``),
  ``masks`` (within-layer update masks, or None when disabled)
- meta: norm dict + ages, visit counts, plan indices, q, loss history,
  step/reselection counters, the pending-mask-refresh flag

In place: ``step`` updates ``sel``, ``opt`` and ``masks`` (JAX donates
them), and ``reselect`` writes the trained rows into ``params`` in place
(no copy of the full tree): both consume their input state.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_names, tree_map
from repro_torch.core import selection as sel_lib
from repro_torch.core import units as units_lib
from repro_torch.core.blockllm import BlockLLMConfig, build_step_fn
from repro_torch.core.selection import (NormTracker, SelectorConfig,
                                        VisitTracker)
from repro_torch.core.units import Plan, PlanStructure, index_tensor
from repro_torch.models import model as model_lib
from repro_torch.optim.adam import Adam, AdamState
from repro_torch.optim.q8adam import (Q8Adam, from_adam_state, is_quantized,
                                      to_adam_state)
from repro_torch.trainers.api import (HISTORY_CAP, StateSpec, TrainerCore,
                                      TrainState, nbytes)
from repro_torch.trainers.registry import register

Pytree = Any


def _ones_masks_like(sel_tree):
    return tree_map(lambda a: torch.ones(a.shape, dtype=torch.bool,
                                         device=a.device), sel_tree)


def _idx_lists(idx_dict) -> Dict[str, list]:
    return {k: v.tolist() for k, v in idx_dict.items()}


@torch.no_grad()
def _carry_moments(new_plan: Plan, old_plan: Plan, new_state: AdamState,
                   old_state: AdamState) -> AdamState:
    """Carry both Adam moments for rows selected in consecutive rounds
    (into ``new_state``'s fresh moments, in place)."""
    for sid, new_idx in new_plan.stack_idx.items():
        old_idx = old_plan.stack_idx.get(sid, index_tensor([])).tolist()
        common = [(old_idx.index(g), j)
                  for j, g in enumerate(new_idx.tolist()) if g in old_idx]
        if not common:
            continue
        src = torch.as_tensor([c[0] for c in common])
        dst = torch.as_tensor([c[1] for c in common])
        for new, old in ((new_state.mu, old_state.mu),
                         (new_state.nu, old_state.nu)):
            for n, o in zip(_flatten_with_names(new["stacks"][sid])[1],
                            _flatten_with_names(old["stacks"][sid])[1]):
                n[dst.to(n.device)] = o[src.to(o.device)]
    return AdamState(old_state.count, new_state.mu, new_state.nu)


class BlockLLMCore(TrainerCore):
    name = "blockllm"
    state_spec = StateSpec(
        arrays=("params", "sel", "probe", "opt", "masks"),
        meta=("step", "loss_history", "norms", "norm_age", "visit_counts",
              "visit_rounds", "reselections", "q", "stack_idx", "probe_idx",
              "active_leaves", "needs_mask_refresh", "sel_churn",
              "last_reselect_step"),
        donate=("sel", "opt", "masks"),
        roles=(("params", "params"), ("sel", "active"), ("probe", "active"),
               ("opt", "opt"), ("masks", "active")),
    )

    def __init__(self, cfg, *, bcfg=None, adam: Optional[Adam] = None,
                 loss_fn=None, attn_impl: str = "full",
                 quantize_state: bool = False, device=None):
        self.cfg = cfg
        self.device = model_lib.resolve_device(device)
        self.bcfg = bcfg or BlockLLMConfig()
        self.adam = adam or Adam(lr=1e-3)
        # Q8State: the moments live as int8 + block scales in ``opt``
        if quantize_state and not is_quantized(self.adam):
            self.adam = Q8Adam(self.adam)
        self.quantize_state = quantize_state
        self._loss_fn = loss_fn or (
            lambda p, batch, overlay=None: model_lib.loss_fn(
                p, cfg, batch, attn_impl=attn_impl, overlay=overlay))
        self._step_fns: Dict = {}
        self._index = None
        self.recompiles = 0   # step functions built (one per structure)

    # ------------------------------------------------------------------ #
    # state plumbing
    # ------------------------------------------------------------------ #

    def index_for(self, params) -> units_lib.UnitIndex:
        if self._index is None:
            self._index = units_lib.build_unit_index(self.cfg, params)
        return self._index

    def plan_of(self, state: TrainState) -> Plan:
        """Rebuild the selection Plan from host meta."""
        index = self.index_for(state.arrays["params"])
        sidx, pidx = state.meta["stack_idx"], state.meta["probe_idx"]
        structure = PlanStructure(
            k_per_stack=tuple((s.sid, len(sidx.get(s.sid, ())))
                              for s in index.stacks),
            probe_per_stack=tuple((s.sid, len(pidx.get(s.sid, ())))
                                  for s in index.stacks),
            active_leaves=tuple(sorted(state.meta["active_leaves"])),
        )
        return Plan(
            structure=structure,
            stack_idx={k: index_tensor(v) for k, v in sidx.items() if len(v)},
            probe_idx={k: index_tensor(v) for k, v in pidx.items() if len(v)},
        )

    def _use_masks(self) -> bool:
        return (self.bcfg.selector.mask_updates
                and self.bcfg.mask_refresh != "never")

    def _trackers(self, meta) -> Tuple[NormTracker, VisitTracker]:
        norms, visits = NormTracker(), VisitTracker()
        norms.norms = {k: float(v) for k, v in meta["norms"].items()}
        norms.age = {k: int(v) for k, v in meta["norm_age"].items()}
        visits.counts = {k: int(v) for k, v in meta["visit_counts"].items()}
        visits.total_rounds = int(meta["visit_rounds"])
        return norms, visits

    def _pack(self, params, active, opt, masks, plan: Plan, q, *,
              norms: NormTracker, visits: VisitTracker, step: int,
              loss_history, reselections: int, needs_mask_refresh: bool,
              sel_churn: float = 1.0,
              last_reselect_step: int = 0) -> TrainState:
        arrays = {"params": params, "sel": active["sel"],
                  "probe": active["probe"], "opt": opt, "masks": masks}
        cap = max(HISTORY_CAP, self.bcfg.selector.patience + 1)
        meta = {
            "step": int(step),
            "loss_history": list(loss_history)[-cap:],
            "norms": norms.norms, "norm_age": norms.age,
            "visit_counts": visits.counts,
            "visit_rounds": visits.total_rounds,
            "reselections": int(reselections), "q": float(q),
            "stack_idx": _idx_lists(plan.stack_idx),
            "probe_idx": _idx_lists(plan.probe_idx),
            "active_leaves": list(plan.structure.active_leaves),
            "needs_mask_refresh": bool(needs_mask_refresh),
            "sel_churn": float(sel_churn),
            "last_reselect_step": int(last_reselect_step),
        }
        return TrainState(arrays, meta)

    # ------------------------------------------------------------------ #
    # protocol: init / step / reselect
    # ------------------------------------------------------------------ #

    def init(self, generator: Optional[torch.Generator] = None,
             params: Optional[Pytree] = None) -> TrainState:
        if params is None:
            params = model_lib.init_params(self.cfg, generator=generator,
                                           device=self.device)
        params = tree_map(lambda a: a.to(self.device), params)
        index = self.index_for(params)
        norms, visits = NormTracker(), VisitTracker()
        plan, q = sel_lib.select(index, norms, visits, self.bcfg.selector,
                                 cursor=0)
        visits.record(plan.selected_labels())
        active = units_lib.extract_active(params, index, plan)
        opt = self.adam.init(active["sel"])
        use_masks = self._use_masks()
        masks = _ones_masks_like(active["sel"]) if use_masks else None
        return self._pack(params, active, opt, masks, plan, q, norms=norms,
                          visits=visits, step=0, loss_history=[],
                          reselections=1, needs_mask_refresh=use_masks)

    def _get_step_fn(self, structure: PlanStructure, refresh: bool,
                     with_masks: bool):
        key = (structure, refresh, with_masks)
        if key not in self._step_fns:
            self.recompiles += 1
            self._step_fns[key] = build_step_fn(
                self.cfg, self._index, self.adam, self.bcfg, structure,
                refresh=refresh, with_masks=with_masks,
                loss_fn=self._loss_fn)
        return self._step_fns[key]

    def step(self, state: TrainState, batch):
        arrays, meta = state.arrays, state.meta
        params = arrays["params"]
        self.index_for(params)
        plan = self.plan_of(state)
        norms, visits = self._trackers(meta)
        refresh = bool(meta["needs_mask_refresh"])
        with_masks = arrays["masks"] is not None

        fn = self._get_step_fn(plan.structure, refresh, with_masks)
        sel, opt, masks, loss, dev_metrics, norm_out = fn(
            params, arrays["sel"], arrays["probe"], plan.stack_idx,
            plan.probe_idx, arrays["opt"], arrays["masks"],
            self.to_device(batch), float(meta["q"]))
        # fresh probe dict: probe rotation replaces its entries
        active = {"sel": sel, "probe": dict(arrays["probe"])}

        step_no = int(meta["step"])
        host = self._ingest_norms(norm_out, loss, dev_metrics, plan, params,
                                  active, norms, step_no)
        loss_f = host.pop("loss")
        loss_history = list(meta["loss_history"]) + [loss_f]
        step_no += 1

        new_state = self._pack(
            params, active, opt, masks, plan, meta["q"], norms=norms,
            visits=visits, step=step_no, loss_history=loss_history,
            reselections=int(meta["reselections"]),
            needs_mask_refresh=False,
            sel_churn=float(meta["sel_churn"]),
            last_reselect_step=int(meta["last_reselect_step"]))

        every = self.bcfg.selector.reselect_every
        if every and step_no % every == 0:
            new_state = self.reselect(new_state)
        elif not every and sel_lib.should_reselect(
                loss_history, self.bcfg.selector.patience):
            new_state = self.reselect(new_state)

        nm = new_state.meta
        metrics = {"loss": loss_f, "step": step_no,
                   "reselections": int(nm["reselections"]),
                   "sel_q": float(nm["q"]),
                   "sel_churn": float(nm["sel_churn"]),
                   "sel_grad_concentration": sel_lib.norm_concentration(
                       norms.norms, 1.0 - self.bcfg.selector.sparsity),
                   "sel_steps_since_reselect": step_no - int(
                       nm["last_reselect_step"])}
        metrics.update(host)
        return new_state, metrics

    def reselect(self, state: TrainState) -> TrainState:
        """Fold the trained rows back into ``params`` (in place: the input
        state is consumed), re-run selection (Algorithm 2), reset (or
        carry) the optimizer."""
        index = self.index_for(state.arrays["params"])
        old_plan = self.plan_of(state)
        norms, visits = self._trackers(state.meta)
        params = units_lib.write_back(
            state.arrays["params"], index, old_plan,
            {"sel": state.arrays["sel"], "probe": state.arrays["probe"]})
        plan, q = sel_lib.select(index, norms, visits, self.bcfg.selector,
                                 cursor=int(state.meta["reselections"]))
        visits.record(plan.selected_labels())
        active = units_lib.extract_active(params, index, plan)
        carry = (self.bcfg.carry_surviving
                 and old_plan.structure == plan.structure)
        if not carry:
            opt = self.adam.init(active["sel"])
        elif is_quantized(self.adam):
            # carry in the f32 view: codec blocks of a flattened moment
            # leaf do not align with selection rows
            opt = from_adam_state(_carry_moments(
                plan, old_plan, self.adam.base.init(active["sel"]),
                to_adam_state(state.arrays["opt"], state.arrays["sel"])))
        else:
            opt = _carry_moments(plan, old_plan,
                                 self.adam.init(active["sel"]),
                                 state.arrays["opt"])
        use_masks = self._use_masks()
        # masks are always materialized (all ones until the refresh
        # step) so the state's tree structure is checkpoint-stable
        masks = _ones_masks_like(active["sel"]) if use_masks else None
        return self._pack(
            params, active, opt, masks, plan, q, norms=norms, visits=visits,
            step=int(state.meta["step"]), loss_history=[],
            reselections=int(state.meta["reselections"]) + 1,
            needs_mask_refresh=use_masks,
            sel_churn=sel_lib.plan_churn(old_plan, plan),
            last_reselect_step=int(state.meta["step"]))

    def _ingest_norms(self, norm_out, loss, dev_metrics, plan: Plan, params,
                      active, norms: NormTracker, step: int) -> Dict:
        """Fold per-unit gradient norms into the host dictionary and
        advance the rotating probes (stale-first order next round).
        The loss, the device metrics and every norm come to the host in
        one copy.  Returns ``{"loss": ..., **metrics}`` as floats."""
        parts = [("loss", None, loss.reshape(1))]
        parts += [(k, None, v.reshape(1)) for k, v in dev_metrics.items()]
        for sid, sq in norm_out["stacks"].items():
            parts.append((sid, plan.stack_idx[sid].tolist(), sq))
        for name, sq in norm_out["leaves"].items():
            parts.append((name, None, sq.reshape(1)))
        for sid, sq in norm_out["probe"].items():
            parts.append((sid, plan.probe_idx[sid].tolist(), sq))
        flat = torch.cat([t.float() for _, _, t in parts]).cpu().numpy()
        host, updates, off = {}, {}, 0
        n_head = 1 + len(dev_metrics)
        for i, (key, rows, t) in enumerate(parts):
            vals = flat[off:off + t.numel()]
            off += t.numel()
            if i < n_head:
                host[key] = float(vals[0])
            elif rows is None:
                updates[key] = float(np.sqrt(float(vals[0])))
            else:
                for g, v in zip(rows, np.sqrt(vals.astype(np.float64))):
                    updates[f"{key}/g{int(g)}"] = v
        norms.update(updates, step)
        index = self._index
        for sid in list(plan.probe_idx):
            info = index.stack(sid)
            excl = set(plan.stack_idx[sid].tolist()
                       if sid in plan.stack_idx else ())
            cands = [g for g in range(info.n_rows) if g not in excl]
            if not cands:
                continue
            cands.sort(key=lambda g: norms.age.get(f"{sid}/g{g}", -1))
            take = cands[:len(plan.probe_idx[sid])]
            plan.probe_idx[sid] = index_tensor(take)
            active["probe"][sid] = units_lib._gather(
                params["stages"][info.si][info.pos], plan.probe_idx[sid])
        return host

    # ------------------------------------------------------------------ #
    # protocol: reporting / export
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def merged_params(self, state: TrainState) -> Pytree:
        """A new tree with the trained rows written in (``params`` is left
        untouched: the stacks with selected rows are copies)."""
        index = self.index_for(state.arrays["params"])
        return units_lib.merge_active(
            state.arrays["params"], index, self.plan_of(state),
            {"sel": state.arrays["sel"], "probe": state.arrays["probe"]})

    def memory_report(self, state: TrainState) -> Dict[str, int]:
        report = {
            "params_bytes": nbytes(state.arrays["params"]),
            "grads_bytes": nbytes(state.arrays["sel"]),
            "opt_state_bytes": self.adam.state_bytes(state.arrays["opt"]),
            "mask_bytes": (nbytes(state.arrays["masks"])
                           if state.arrays["masks"] is not None else 0),
            "probe_bytes": nbytes(state.arrays["probe"]),
        }
        report["total_train_state"] = sum(
            v for k, v in report.items() if k != "params_bytes")
        return report


@register("blockllm")
def make_blockllm(cfg, *, adam=None, bcfg=None, loss_fn=None,
                  attn_impl="full", sparsity=0.95, patience=100,
                  policy="static", k_frac=0.25, probe_rows=1,
                  quantize_state=False, device=None, **_) -> BlockLLMCore:
    device = model_lib.resolve_device(device)
    if bcfg is None:
        # quantized state on the card defaults to the fused dequant ->
        # Adam -> requant kernel (the JAX package: "pallas" on a TPU); an
        # explicit bcfg always takes precedence
        fused = "off"
        if quantize_state and device.type == "cuda":
            fused = "kernel"
        bcfg = BlockLLMConfig(selector=SelectorConfig(
            sparsity=sparsity, patience=patience, policy=policy,
            static_k_frac=k_frac, probe_rows_per_stack=probe_rows),
            fused_update=fused)
    return BlockLLMCore(cfg, bcfg=bcfg, adam=adam, loss_fn=loss_fn,
                        attn_impl=attn_impl, quantize_state=quantize_state,
                        device=device)


@register("blockllm+q8")
def make_blockllm_q8(cfg, **kw) -> BlockLLMCore:
    """BlockLLM with Q8State moments (int8 + block scales)."""
    kw["quantize_state"] = True
    return make_blockllm(cfg, **kw)
