"""BlockLLM parameter selection (paper Algorithm 2 + §2.2), a copy of
the JAX package's selection module: host Python over numpy, so the port
selects the same units from the same norms and visits.  Only the
``Plan`` index vectors differ: int32 CPU tensors.

Host-side logic: operates on a dictionary of per-unit gradient norms (the
"norm dict" the paper maintains from probe gradients) and visit counts.

Two policies:

- ``greedy`` (paper-faithful): sort ALL units by ``||G~_l|| / f_l``
  descending, accumulate until the selected parameter count reaches
  ``n_s = (1 - s) * n`` (Algorithm 2).  The per-stack K that falls out is
  data-dependent => the train step recompiles when the K-profile changes.
- ``static`` (TPU-native, beyond paper): a fixed per-stack budget
  ``K = ceil(G * k_frac)``; the greedy ranking picks the top-K *within each
  stack*, so the jitted step never recompiles (indices are traced values).

The within-layer mask fraction ``q = n_s / Sigma_p`` keeps the *stated
objective* of the paper's tau (keep exactly n_s of the Sigma_p selected
parameters); the literal zeta formula is degenerate — see DESIGN.md §2c.

Loss-patience trigger (Algorithm 1): re-select when the current loss is >=
the mean of the last ``m`` recorded losses.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.units import (Plan, PlanStructure, UnitIndex,
                                    index_tensor)

F_EPS = 1e-8  # unvisited units get effectively-infinite priority (paper's f_l)


@dataclass
class SelectorConfig:
    sparsity: float = 0.95           # s: fraction of params NOT updated
    patience: int = 100              # m
    policy: str = "static"           # static | greedy | cyclic (BAdam)
    static_k_frac: float = 0.25     # static policy: fraction of rows per stack
    cyclic_block_rows: int = 1       # cyclic policy: rows per block (BAdam K)
    reselect_every: int = 0          # >0: switch every N steps (BAdam); 0: patience
    probe_rows_per_stack: int = 1    # p (rotating probe set)
    use_visit_frequency: bool = True # the f_l modulation (ablation: off)
    invert: bool = False             # BlockLLM-SubOPT ablation (smallest norms)
    always_active_leaves: Tuple[str, ...] = ("final_norm",)
    selectable_leaves: Tuple[str, ...] = ("embed", "head", "vision_proj",
                                          "encoder")
    mask_updates: bool = True        # within-layer tau mask on updates


class NormTracker:
    """The paper's per-layer gradient-norm dictionary."""

    def __init__(self):
        self.norms: Dict[str, float] = {}
        self.age: Dict[str, int] = {}

    def update(self, new_norms: Dict[str, float], step: int):
        for k, v in new_norms.items():
            self.norms[k] = float(v)
            self.age[k] = step

    def get(self, unit: str, default: float = float("inf")) -> float:
        # unseen units get +inf => explored first (optimistic init)
        return self.norms.get(unit, default)


class VisitTracker:
    """Layer visit frequency f_l = (1/T) sum_t S_t^l."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.total_rounds: int = 0

    def record(self, selected: Sequence[str]):
        self.total_rounds += 1
        for u in selected:
            self.counts[u] = self.counts.get(u, 0) + 1

    def freq(self, unit: str) -> float:
        if self.total_rounds == 0:
            return 0.0
        return self.counts.get(unit, 0) / self.total_rounds


def unit_scores(units: Sequence[str], norms: NormTracker,
                visits: VisitTracker, scfg: SelectorConfig) -> Dict[str, float]:
    out = {}
    for u in units:
        n = norms.get(u)
        if scfg.use_visit_frequency:
            f = max(visits.freq(u), F_EPS)
            score = n / f if math.isfinite(n) else float("inf")
        else:
            score = n
        out[u] = score
    return out


def _rank(units: List[str], scores: Dict[str, float], invert: bool):
    # stable sort: inf-score (never-probed) units first, then by score
    key = (lambda u: scores[u]) if not invert else (lambda u: -scores[u])
    return sorted(units, key=key, reverse=True)


def select(index: UnitIndex, norms: NormTracker, visits: VisitTracker,
           scfg: SelectorConfig, *, rng: Optional[np.random.Generator] = None,
           cursor: int = 0) -> Tuple[Plan, float]:
    """Run selection; returns (Plan, q) with q = n_s / Sigma_p in (0, 1].

    ``cursor`` drives the ``cyclic`` policy (BAdam baseline): the active
    block is the ``cyclic_block_rows`` consecutive layer rows starting at
    ``cursor * block`` in stack order, cycling.
    """
    rng = rng or np.random.default_rng(0)
    sizes = index.unit_sizes()
    always = [l for l in scfg.always_active_leaves if any(
        li.name == l for li in index.leaves)]
    selectable_leaves = [li.name for li in index.leaves
                         if li.name in scfg.selectable_leaves]
    row_units = [f"{s.sid}/g{g}" for s in index.stacks for g in range(s.n_rows)]
    n_total = index.total_params
    n_s = max(1, int(round((1.0 - scfg.sparsity) * n_total)))

    scores = unit_scores(row_units + selectable_leaves, norms, visits, scfg)

    chosen_rows: Dict[str, List[int]] = {s.sid: [] for s in index.stacks}
    chosen_leaves: List[str] = list(always)
    sigma_p = sum(sizes[l] for l in always)

    if scfg.policy == "cyclic":  # BAdam: ordered blocks, no scoring
        all_rows = [(s.sid, g) for s in index.stacks
                    for g in range(s.n_rows)]
        nb = scfg.cyclic_block_rows
        start = (cursor * nb) % len(all_rows)
        take = [all_rows[(start + i) % len(all_rows)] for i in range(nb)]
        for sid, g in take:
            chosen_rows[sid].append(g)
            sigma_p += sizes[f"{sid}/g{g}"]
    elif scfg.policy == "greedy":
        order = _rank(row_units + selectable_leaves, scores, scfg.invert)
        for u in order:
            if sigma_p >= n_s:
                break
            if "/g" in u:
                sid, g = u.rsplit("/g", 1)
                chosen_rows[sid].append(int(g))
            else:
                chosen_leaves.append(u)
            sigma_p += sizes[u]
    else:  # static: fixed K per stack, ranked within stack
        for s in index.stacks:
            k = max(1, int(math.ceil(s.n_rows * scfg.static_k_frac)))
            units = [f"{s.sid}/g{g}" for g in range(s.n_rows)]
            order = _rank(units, scores, scfg.invert)[:k]
            chosen_rows[s.sid] = sorted(int(u.rsplit("/g", 1)[1])
                                        for u in order)
            sigma_p += k * s.params_per_row
        # leaves: keep a leaf active if its score beats the median row score
        finite = [v for v in scores.values() if math.isfinite(v)]
        med = float(np.median(finite)) if finite else 0.0
        for name in selectable_leaves:
            if scores[name] >= med or not math.isfinite(scores[name]):
                chosen_leaves.append(name)
                sigma_p += sizes[name]

    # rotating probe rows: least-recently-probed, excluding chosen rows
    probe_idx, probe_struct = {}, []
    for s in index.stacks:
        p = min(scfg.probe_rows_per_stack, s.n_rows)
        excl = set(chosen_rows[s.sid])
        cands = [g for g in range(s.n_rows) if g not in excl]
        cands.sort(key=lambda g: norms.age.get(f"{s.sid}/g{g}", -1))
        take = cands[:p]
        if not take:  # every row selected: probe row 0 (harmless duplicate-free)
            p = 0
        probe_struct.append((s.sid, len(take)))
        if take:
            probe_idx[s.sid] = np.asarray(take, np.int32)

    q = min(1.0, n_s / max(sigma_p, 1))
    structure = PlanStructure(
        k_per_stack=tuple((sid, len(v)) for sid, v in chosen_rows.items()),
        probe_per_stack=tuple(probe_struct),
        active_leaves=tuple(sorted(set(chosen_leaves))),
    )
    plan = Plan(
        structure=structure,
        stack_idx={sid: index_tensor(sorted(v))
                   for sid, v in chosen_rows.items() if v},
        probe_idx={sid: index_tensor(v.tolist())
                   for sid, v in probe_idx.items()},
    )
    return plan, q


def should_reselect(loss_history: List[float], patience: int) -> bool:
    """Algorithm 1 line 5: phi_t >= mean of last m losses."""
    if len(loss_history) < patience + 1:
        return False
    cur = loss_history[-1]
    window = loss_history[-patience - 1:-1]
    return cur >= (sum(window) / len(window))


# -- selection telemetry (TraceKit) ------------------------------------- #

def plan_units(plan: Plan) -> frozenset:
    """The set of unit names a plan updates (rows + active leaves) —
    the identity used for churn accounting."""
    units = set(plan.structure.active_leaves)
    for sid, idx in plan.stack_idx.items():
        for g in idx.tolist():
            units.add(f"{sid}/g{g}")
    return frozenset(units)


def plan_churn(prev: Optional[Plan], new: Plan) -> float:
    """Jaccard *distance* between consecutive plans' selected-unit sets,
    in [0, 1]: 0 = reselection kept the same blocks, 1 = disjoint.

    This is the "which blocks is BlockLLM actually churning?" signal —
    high churn under the patience trigger means the norm dictionary is
    still exploring; churn ~0 means selection has converged and a longer
    ``reselect_every`` would save probe gradients.
    """
    if prev is None:
        return 1.0
    a, b = plan_units(prev), plan_units(new)
    union = a | b
    if not union:
        return 0.0
    return 1.0 - len(a & b) / len(union)


def norm_concentration(norms: Dict[str, float], top_frac: float) -> float:
    """Share of total squared gradient norm held by the top ``top_frac``
    fraction of units, in (0, 1].

    The AdaRankGrad-style signal: concentration near 1 says gradient
    energy lives in few blocks (aggressive sparsity is safe); near
    ``top_frac`` says energy is spread uniformly.  Non-finite norms
    (optimistic-init +inf for never-probed units) are excluded.
    """
    vals = sorted((v * v for v in norms.values() if math.isfinite(v)),
                  reverse=True)
    if not vals:
        return 0.0
    total = sum(vals)
    if total <= 0.0:
        return 0.0
    k = max(1, int(math.ceil(len(vals) * min(max(top_frac, 0.0), 1.0))))
    return sum(vals[:k]) / total
