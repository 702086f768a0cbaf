"""GaLore baseline (Zhao et al., 2024, arXiv:2403.03507), counterpart of
``repro.baselines.galore``.

Gradient Low-Rank Projection: for every qualifying weight (trailing two
dims both >= ``min_dim``, stacked layers ``[G, m, n]`` batched over G)
the gradient is projected onto a rank-r subspace, the top singular
vectors of the gradient's smaller side, refreshed every
``update_proj_gap`` steps; the Adam moments live in the projected space,
and the update is lifted back with scale alpha.  Other leaves (norms,
biases) take full Adam.  The embedding and the head qualify too.

The refresh is one full SVD (``torch.linalg.svd``, ``full_matrices=
False``, batched over leading dims), the function JAX computes.  The
update is in place on ``params`` and the moments (JAX donates them);
a refresh replaces the projections.

Signs: within one projection window the update does not depend on the
sign of a projector column (P -> -P flips the projected gradient and
moments, not P times the update), but moments carried across a refresh
do, so two SVD libraries that pick other column signs part after the
second refresh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_names, tree_map
from repro_torch.numerics import div_exact, sqrt_exact
from repro_torch.optim.adam import bias_corrections

Pytree = Any


class GaLoreState(NamedTuple):
    count: torch.Tensor   # int32 0-dim, on the CPU
    proj: Pytree          # P per projected leaf (None leaf => full Adam)
    mu: Pytree            # moments: projected shape for projected leaves
    nu: Pytree


@dataclass(frozen=True)
class GaLore:
    rank: int = 8
    update_proj_gap: int = 200
    scale: float = 0.25     # alpha
    lr: Any = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    min_dim: int = 32

    def _qualifies(self, leaf) -> bool:
        return (leaf.dim() >= 2 and leaf.shape[-1] >= self.min_dim
                and leaf.shape[-2] >= self.min_dim)

    def _proj_shapes(self, leaf):
        """Project the smaller of the two trailing dims."""
        m, n = leaf.shape[-2], leaf.shape[-1]
        side = "left" if m <= n else "right"
        r = min(self.rank, m, n)
        batch = tuple(leaf.shape[:-2])
        p_shape = batch + ((m, r) if side == "left" else (n, r))
        mom_shape = batch + ((r, n) if side == "left" else (m, r))
        return side, r, p_shape, mom_shape

    def init(self, params: Pytree) -> GaLoreState:
        def zeros(shape, like):
            return torch.zeros(shape, dtype=torch.float32, device=like.device)

        def pinit(leaf):
            if not self._qualifies(leaf):
                return None
            return zeros(self._proj_shapes(leaf)[2], leaf)

        def minit(leaf):
            if not self._qualifies(leaf):
                return zeros(leaf.shape, leaf)
            return zeros(self._proj_shapes(leaf)[3], leaf)

        return GaLoreState(torch.zeros((), dtype=torch.int32),
                           tree_map(pinit, params), tree_map(minit, params),
                           tree_map(minit, params))

    def _svd_proj(self, g, side, r):
        """Top-r singular subspace of g (batched over leading dims)."""
        u, _, vh = torch.linalg.svd(g.float(), full_matrices=False)
        p = u[..., :, :r] if side == "left" else vh[..., :r, :].mT
        return p.contiguous()

    def _adam(self, m, v, g, bc1, bc2):
        """The moments in place, JAX's expression order; returns the
        Adam direction."""
        m.copy_(self.b1 * m + (1 - self.b1) * g)
        v.copy_(self.b2 * v + (1 - self.b2) * g * g)
        return div_exact(m, bc1) / (sqrt_exact(div_exact(v, bc2))
                                    + self.eps)

    @torch.no_grad()
    def update(self, grads: Pytree, state: GaLoreState, params: Pytree):
        """In place on ``params`` and the moments; returns ``(params,
        state')`` with the refreshed projections on a refresh step."""
        bc1, bc2 = bias_corrections(self.b1, self.b2, state.count)
        count = int(state.count)
        lr = self.lr(count) if callable(self.lr) else self.lr
        lr = float(np.float32(lr))
        refresh = count % self.update_proj_gap == 0
        names, ps, td = _flatten_with_names(params)
        gs = _flatten_with_names(grads)[1]
        ms = _flatten_with_names(state.mu)[1]
        vs = _flatten_with_names(state.nu)[1]
        pnames, pl, _ = _flatten_with_names(state.proj)
        proj = dict(zip(pnames, pl))
        new_proj = []
        for name, p, g, m, v in zip(names, ps, gs, ms, vs):
            gf = g.float()
            P = proj.get(name)
            if P is None:                 # full Adam for this leaf
                upd = self._adam(m, v, gf, bc1, bc2)
                new_proj.append(None)
            else:
                side, r, _, _ = self._proj_shapes(p)
                if refresh:
                    P = self._svd_proj(gf, side, r)
                rg = P.mT @ gf if side == "left" else gf @ P
                upd_r = self._adam(m, v, rg, bc1, bc2)
                upd = P @ upd_r if side == "left" else upd_r @ P.mT
                upd = self.scale * upd
                new_proj.append(P)
            p.copy_((p.float() - lr * upd).to(p.dtype))
        new_state = GaLoreState((state.count + 1).to(torch.int32),
                                td.unflatten(new_proj), state.mu, state.nu)
        return params, new_state

    def state_bytes(self, state: GaLoreState) -> int:
        return sum(a.nbytes for a in _flatten_with_names(
            (state.proj, state.mu, state.nu))[1])
