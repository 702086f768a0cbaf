"""Q8State: int8 block-quantized Adam moments (counterpart of
``repro.optim.q8adam``).

Both moments are stored as int8 codes ``[NB, 256]`` with one f32 scale
per 256-element block — the ``runtime/compression.py`` codec — about
25.4% of the f32 moment bytes.  The quantized state is the only
persistent optimizer state: ``update`` dequantizes, runs the unchanged
``Adam`` math and requantizes, in place into the stored codes and
scales.  The fused kernel (``kernels.masked_adam.masked_adam_q8_cuda``)
computes the same transition without f32 moment tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.optim.adam import Adam, AdamState
from repro_torch.runtime.compression import (BLOCK, dequantize_int8,
                                             quantize_int8)

Pytree = Any


class Q8AdamState(NamedTuple):
    """Quantized twin of ``AdamState``: per moment a tree of int8 code
    blocks ``[NB, 256]`` and a tree of f32 scales ``[NB]``."""
    count: torch.Tensor   # int32 0-dim, on the CPU
    mu_q: Pytree
    mu_scale: Pytree
    nu_q: Pytree
    nu_scale: Pytree


def quantize_tree(tree: Pytree) -> Tuple[Pytree, Pytree]:
    """Leaf-wise ``quantize_int8``: tree -> (codes tree, scales tree)."""
    _, flat, td = _flatten_with_names(tree)
    qs = [quantize_int8(l) for l in flat]
    return (td.unflatten([q for q, _ in qs]),
            td.unflatten([s for _, s in qs]))


def dequantize_tree(q_tree: Pytree, scale_tree: Pytree, like: Pytree,
                    dtype=torch.float32) -> Pytree:
    """Inverse of ``quantize_tree``; ``like`` supplies the leaf shapes."""
    _, flat_like, td = _flatten_with_names(like)
    qs = _flatten_with_names(q_tree)[1]
    ss = _flatten_with_names(scale_tree)[1]
    return td.unflatten([dequantize_int8(q, s, l.shape, dtype)
                         for q, s, l in zip(qs, ss, flat_like)])


def to_adam_state(state: Q8AdamState, like: Pytree) -> AdamState:
    """The f32 ``AdamState`` view (``like``: the param-shaped tree)."""
    return AdamState(state.count,
                     dequantize_tree(state.mu_q, state.mu_scale, like),
                     dequantize_tree(state.nu_q, state.nu_scale, like))


def from_adam_state(state: AdamState) -> Q8AdamState:
    mq, ms = quantize_tree(state.mu)
    nq, ns = quantize_tree(state.nu)
    return Q8AdamState(state.count, mq, ms, nq, ns)


@torch.no_grad()
def _requantize_into(state: Q8AdamState, f32: AdamState) -> Q8AdamState:
    new = from_adam_state(f32)
    for dst, src in ((state.mu_q, new.mu_q), (state.mu_scale, new.mu_scale),
                     (state.nu_q, new.nu_q), (state.nu_scale, new.nu_scale)):
        for d, s in zip(_flatten_with_names(dst)[1],
                        _flatten_with_names(src)[1]):
            d.copy_(s)
    return Q8AdamState(f32.count, state.mu_q, state.mu_scale, state.nu_q,
                       state.nu_scale)


@dataclass(frozen=True)
class Q8Adam:
    """Drop-in for ``Adam`` with int8 block-quantized moments; the
    hyperparameters are the wrapped ``base`` Adam's."""
    base: Adam

    @property
    def lr(self):
        return self.base.lr

    @property
    def b1(self) -> float:
        return self.base.b1

    @property
    def b2(self) -> float:
        return self.base.b2

    @property
    def eps(self) -> float:
        return self.base.eps

    @property
    def weight_decay(self) -> float:
        return self.base.weight_decay

    @property
    def clip_norm(self) -> float:
        return self.base.clip_norm

    def _lr(self, count) -> float:
        return self.base._lr(count)

    def init(self, params: Pytree) -> Q8AdamState:
        return from_adam_state(self.base.init(params))

    def processed_grad(self, grads: Pytree, state: Q8AdamState):
        upds, new = self.base.processed_grad(
            grads, to_adam_state(state, grads))
        return upds, from_adam_state(new)

    def update(self, grads: Pytree, state: Q8AdamState, params: Pytree,
               *, update_mask: Optional[Pytree] = None):
        """In place on ``params`` and the stored codes and scales."""
        f32 = to_adam_state(state, params)
        params, f32 = self.base.update(grads, f32, params,
                                       update_mask=update_mask)
        return params, _requantize_into(state, f32)

    def state_bytes(self, state: Q8AdamState) -> int:
        return sum(a.nbytes for a in _flatten_with_names(
            (state.mu_q, state.mu_scale, state.nu_q, state.nu_scale))[1])


def is_quantized(adam) -> bool:
    """True when an optimizer stores Q8 (int8 + scale) moment state."""
    return isinstance(adam, Q8Adam)


__all__ = ["BLOCK", "Q8Adam", "Q8AdamState", "quantize_tree",
           "dequantize_tree", "to_adam_state", "from_adam_state",
           "is_quantized"]
