"""Selectable units of BlockLLM (counterpart of ``repro.core.units``).

A *unit* is the paper's "layer", the block the selector turns on or off:

- **stack rows**: ``params["stages"][si]["pos{j}"]`` holds a tree whose
  leaves are stacked ``[G, ...]``; row ``g`` is one transformer layer;
- **whole leaves**: ``embed``, ``head``, ``final_norm`` (and, for the
  families not ported yet, ``vision_proj``, ``encoder``).

``extract_active`` gathers the selected and probe rows (copies) and
copies the selected leaf units; ``merge_active`` scatters them back into
a new tree that gradients reach only through the active rows;
``write_back`` scatters the trained rows into ``params`` in place.
Plan indices are int32 tensors kept on the CPU (host values, as the
selection runs on the host).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_names, tree_map

Pytree = Any


def _leaves(tree):
    return _flatten_with_names(tree)[1]


@dataclass(frozen=True)
class StackInfo:
    sid: str          # "s{si}/pos{j}"
    si: int
    pos: str          # "pos{j}"
    n_rows: int       # G
    params_per_row: int


@dataclass(frozen=True)
class LeafInfo:
    name: str         # top-level key in params
    numel: int


@dataclass(frozen=True)
class UnitIndex:
    stacks: Tuple[StackInfo, ...]
    leaves: Tuple[LeafInfo, ...]
    total_params: int

    def stack(self, sid: str) -> StackInfo:
        return next(s for s in self.stacks if s.sid == sid)

    def unit_sizes(self) -> Dict[str, int]:
        """unit label -> param count.  Stack rows are 's.../g{g}'."""
        out = {l.name: l.numel for l in self.leaves}
        for s in self.stacks:
            for g in range(s.n_rows):
                out[f"{s.sid}/g{g}"] = s.params_per_row
        return out


LEAF_UNIT_KEYS = ("embed", "head", "final_norm", "vision_proj", "encoder")


def build_unit_index(cfg, params) -> UnitIndex:
    stacks = []
    for si, stage in enumerate(params["stages"]):
        for pos, sub in sorted(stage.items()):
            leaves = _leaves(sub)
            g = leaves[0].shape[0]
            per_row = sum(l.numel() for l in leaves) // g
            stacks.append(StackInfo(f"s{si}/{pos}", si, pos, g, per_row))
    leaf_infos = []
    for name in LEAF_UNIT_KEYS:
        if name in params:
            leaf_infos.append(LeafInfo(
                name, sum(l.numel() for l in _leaves(params[name]))))
    total = sum(l.numel() for l in _leaves(params))
    return UnitIndex(tuple(stacks), tuple(leaf_infos), total)


@dataclass(frozen=True)
class PlanStructure:
    """The static part of a selection plan (per-stack K, probe counts,
    active leaf units)."""
    k_per_stack: Tuple[Tuple[str, int], ...]      # (sid, K) gathered rows
    probe_per_stack: Tuple[Tuple[str, int], ...]  # (sid, P) probe rows
    active_leaves: Tuple[str, ...]                # whole-leaf units


def index_tensor(rows) -> torch.Tensor:
    """A plan index vector: int32 on the CPU."""
    return torch.as_tensor(list(rows), dtype=torch.int32)


@dataclass
class Plan:
    """Structure + the index values (int32 CPU tensors)."""
    structure: PlanStructure
    stack_idx: Dict[str, torch.Tensor]   # sid -> int32 [K]
    probe_idx: Dict[str, torch.Tensor]   # sid -> int32 [P]

    def selected_labels(self) -> List[str]:
        out = list(self.structure.active_leaves)
        for sid, idx in self.stack_idx.items():
            out += [f"{sid}/g{int(g)}" for g in idx.tolist()]
        return out


def _stage_sub(params, info: StackInfo):
    return params["stages"][info.si][info.pos]


def _gather(sub, idx: torch.Tensor):
    return tree_map(lambda a: a[idx.to(a.device, torch.long)], sub)


def extract_active(params, index: UnitIndex, plan: Plan):
    """Gather the selected (and probe) parameters.

    Returns {"sel": {"stacks": {sid: rows}, "leaves": {name: subtree}},
             "probe": {sid: rows}}.  Every tensor is a copy: the train
    step updates the active tree in place, so it never aliases
    ``params``."""
    sel_stacks, probes = {}, {}
    for sid, k in plan.structure.k_per_stack:
        if k:
            sel_stacks[sid] = _gather(_stage_sub(params, index.stack(sid)),
                                      plan.stack_idx[sid])
    for sid, p in plan.structure.probe_per_stack:
        if p:
            probes[sid] = _gather(_stage_sub(params, index.stack(sid)),
                                  plan.probe_idx[sid])
    leaves = {name: tree_map(lambda a: a.detach().clone(), params[name])
              for name in plan.structure.active_leaves}
    return {"sel": {"stacks": sel_stacks, "leaves": leaves}, "probe": probes}


def merge_active(params, index: UnitIndex, plan: Plan, active):
    """Scatter the active rows into a new tree (``params`` untouched).

    Differentiable in ``active`` only: frozen leaves are detached, so no
    gradient reaches them."""
    out = {k: v for k, v in params.items() if k != "stages"}
    stages = [dict(s) for s in params["stages"]]

    def scatter(sub, rows, idx):
        ix = idx.to(torch.long)
        return tree_map2(lambda f, a: f.detach().index_put(
            (ix.to(f.device),), a.to(f.dtype)), sub, rows)

    for group, idx_of in ((active["sel"]["stacks"], plan.stack_idx),
                          (active.get("probe", {}), plan.probe_idx)):
        for sid, rows in group.items():
            info = index.stack(sid)
            stages[info.si][info.pos] = scatter(
                stages[info.si][info.pos], rows, idx_of[sid])
    out["stages"] = stages
    for name, sub in active["sel"]["leaves"].items():
        out[name] = sub
    return out


@torch.no_grad()
def write_back(params, index: UnitIndex, plan: Plan, active):
    """Scatter the trained rows and leaf units into ``params`` IN PLACE
    and return it (at re-selection and export; ``params`` is consumed).
    Probe rows are never updated, so they are equal to their rows in
    ``params`` already and are not written."""
    for sid, rows in active["sel"]["stacks"].items():
        info = index.stack(sid)
        ix = plan.stack_idx[sid].to(torch.long)
        for f, a in zip(_leaves(_stage_sub(params, info)), _leaves(rows)):
            f[ix.to(f.device)] = a.to(f.dtype)
    for name, sub in active["sel"]["leaves"].items():
        for f, a in zip(_leaves(params[name]), _leaves(sub)):
            f.copy_(a)
    return params


def tree_map2(fn, a: Pytree, b: Pytree) -> Pytree:
    """``fn`` over the paired leaves of two trees of one structure."""
    _, la, td = _flatten_with_names(a)
    return td.unflatten([fn(x, y) for x, y in zip(la, _leaves(b))])


def per_row_sq_norms(rows_tree) -> torch.Tensor:
    """Stacked rows tree [K, ...] -> [K] squared norms (f32)."""
    tot = None
    for l in _leaves(rows_tree):
        s = l.float().square()
        if l.dim() > 1:
            s = s.sum(dim=tuple(range(1, l.dim())))
        tot = s if tot is None else tot + s
    return tot


def subtree_sq_norm(tree) -> torch.Tensor:
    return sum(l.float().square().sum() for l in _leaves(tree))
