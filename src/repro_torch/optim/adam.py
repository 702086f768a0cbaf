"""Adam/AdamW over parameter trees (counterpart of ``repro.optim.adam``).

``init(params) -> AdamState``; ``update(grads, state, params) ->
(params, state)``.  Moments are f32 whatever the parameter dtype; the
update is cast back to the parameter dtype.

In place where the JAX step donates: ``update`` overwrites the leaves of
``params`` and the moments of ``state`` one leaf at a time (so only one
leaf's temporaries exist at once) and returns them with ``count + 1``.
``processed_grad`` is pure.  ``count`` is a 0-dim int32 tensor kept on
the CPU: the bias corrections and a scheduled learning rate are host
arithmetic, so reading it never waits for the card.

Numerics follow JAX's weak typing: ``b1 * m + (1 - b1) * g`` multiplies
by ``f32(1 - b1)`` (the Python double rounded to f32, 0.1 for b1 = 0.9),
and the bias corrections are ``1 - b ** count`` in f32.  The fused
kernels (``kernels.masked_adam``) take ``1 - b1`` from the f32 scalar
instead, as the TPU kernel does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_names, tree_map
from repro_torch.numerics import div_exact, sqrt_exact

Pytree = Any
Schedule = Callable[[int], float]


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 0-dim, on the CPU
    mu: Pytree           # first moments (f32)
    nu: Pytree           # second moments (f32)


def _leaves(tree):
    return _flatten_with_names(tree)[1]


def bias_corrections(b1, b2, count) -> tuple:
    """``(1 - b1 ** c, 1 - b2 ** c)`` in f32 for ``c = count + 1``."""
    c = np.float32(int(count) + 1)
    return (float(np.float32(1.0) - np.float32(b1) ** c),
            float(np.float32(1.0) - np.float32(b2) ** c))


@dataclass(frozen=True)
class Adam:
    lr: Union[float, Schedule] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # AdamW-style decoupled decay
    clip_norm: float = 0.0     # global-norm clipping, 0 = off

    def init(self, params: Pytree) -> AdamState:
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        return AdamState(torch.zeros((), dtype=torch.int32), z,
                         tree_map(torch.clone, z))

    def _lr(self, count) -> float:
        lr = self.lr(int(count)) if callable(self.lr) else self.lr
        return float(np.float32(lr))

    def _moments(self, g, m, v, bc1, bc2):
        g = g.float()
        m2 = m * self.b1 + g * (1 - self.b1)
        v2 = v * self.b2 + g.square() * (1 - self.b2)
        u = (div_exact(m2, bc1)
             / (sqrt_exact(div_exact(v2, bc2)) + self.eps))
        return u, m2, v2

    def processed_grad(self, grads, state):
        """Adam-preconditioned gradient G~ = m_hat / (sqrt(v_hat) + eps),
        the quantity BlockLLM scores layers with (paper eq. 1).  Pure:
        returns ``(upds, new_state)`` with new moment tensors."""
        bc1, bc2 = bias_corrections(self.b1, self.b2, state.count)
        names, gs, td = _flatten_with_names(grads)
        out = [self._moments(g, m, v, bc1, bc2) for g, m, v in
               zip(gs, _leaves(state.mu), _leaves(state.nu))]
        count = (state.count + 1).to(torch.int32)
        return (td.unflatten([o[0] for o in out]),
                AdamState(count, td.unflatten([o[1] for o in out]),
                          td.unflatten([o[2] for o in out])))

    @torch.no_grad()
    def update(self, grads: Pytree, state: AdamState, params: Pytree,
               *, update_mask: Optional[Pytree] = None):
        """In place on ``params`` and the moments; returns ``(params,
        state')``.  ``update_mask``: optional tree of {0,1} tensors of the
        grads' structure, multiplied into the *update* — the BlockLLM
        within-layer mask (moments still track the whole selection)."""
        gs = _leaves(grads)
        if self.clip_norm:
            f = np.float32
            scale = min(f(1.0), f(self.clip_norm)
                        / (f(global_norm(grads).item()) + f(1e-9)))
            gs = [g * float(scale) for g in gs]
        bc1, bc2 = bias_corrections(self.b1, self.b2, state.count)
        lr = self._lr(state.count)
        masks = ([None] * len(gs) if update_mask is None
                 else _leaves(update_mask))
        for p, g, m, v, mk in zip(_leaves(params), gs, _leaves(state.mu),
                                  _leaves(state.nu), masks):
            u, m2, v2 = self._moments(g, m, v, bc1, bc2)
            m.copy_(m2)
            v.copy_(v2)
            if mk is not None:
                u = u * mk.to(u.dtype)
            p32 = p.float()
            u = u + p32 * self.weight_decay
            p.copy_(p32 - u * lr)
        count = (state.count + 1).to(torch.int32)
        return params, AdamState(count, state.mu, state.nu)

    def state_bytes(self, state: AdamState) -> int:
        return sum(a.nbytes for a in _leaves((state.mu, state.nu)))


def global_norm(tree: Pytree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in _leaves(tree)]
    return torch.stack(leaves).sum().sqrt() if leaves else torch.zeros(())
