"""Adam over ZeRO chunks: the gradient hook and the optimizer step of
every Adam-moment trainer under a ``shard_ctx`` mesh.

The f32 moments of each leaf are this rank's chunk along the first
unsharded divisible dim after the stacked-rows axis (``launch.steps.
zero_extend``, JAX's ``_zero_extend``); Q8 moments (int8 ``[NB, 256]``
codes, f32 ``[NB]`` scales) are chunked along NB, codes and scales
alike, so every codec block stays whole and the update is the
single-device one bit for bit.  The gradients are reduce-scattered
(the data mean) into those chunks, the update runs on them — the fused
masked-Adam kernels (``kernels.ops``) or the unfused ``Adam`` — and the
updated parameter chunks are all-gathered back into the full leaves.
Without a context this is the plain single-device update.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.kernels import ops as kernel_ops
from repro_torch.optim.q8adam import Q8AdamState, is_quantized
from repro_torch.optim.adam import AdamState
from repro_torch.runtime.shard_ctx import ZeroUpdate

Pytree = Any


def _leaves(tree):
    return _flatten_with_names(tree)[1]


def adam_step(adam, grads: Pytree, state, params: Pytree, *,
              update_mask: Optional[Pytree] = None, fused: str = "off",
              extra: Sequence[torch.Tensor] = ()):
    """One Adam step of ``params`` (in place) from this rank's unreduced
    ``grads``.  ``fused``: ``off`` runs ``adam.update``; otherwise the
    masked-Adam kernel op in that mode (``kernel`` / ``plain`` /
    ``auto``), with ``update_mask`` as its mask.  ``extra``: more
    gradients without moments (BlockLLM's probe rows), reduced whole in
    the same all-reduce bucket.  Returns ``(params, new_state, zero,
    g_chunks)``: ``zero`` is the ``ZeroUpdate`` layout and ``g_chunks``
    the reduced gradient chunks, leaf for leaf, ``extra``'s last."""
    _, gl, td = _flatten_with_names(grads)
    pl = _leaves(params)
    q8 = is_quantized(adam)
    extra = list(extra)
    zero = ZeroUpdate(gl + extra, _leaves(state.mu_q if q8 else state.mu)
                      + extra, q8=q8)
    gl = gl + extra
    if zero.ctx is not None and adam.clip_norm:
        raise NotImplementedError("global-norm clipping over ZeRO chunks "
                                  "is not ported")
    g_c = zero.reduce(gl)
    gl, g_c = gl[:len(pl)], g_c
    p_c = zero.chunk(pl)
    mask_c = (None if update_mask is None
              else zero.chunk(_leaves(update_mask)))
    if fused == "off":
        _, new_state = adam.update(
            td.unflatten(g_c[:len(pl)]), state, td.unflatten(p_c),
            update_mask=None if mask_c is None else td.unflatten(mask_c))
    else:
        kw = dict(lr=adam._lr(state.count), b1=adam.b1, b2=adam.b2,
                  eps=adam.eps, weight_decay=adam.weight_decay,
                  count=int(state.count), mode=fused)
        count = (state.count + 1).to(state.count.dtype)
        if q8:
            kernel_ops.masked_adam_q8_tree(
                p_c, g_c[:len(pl)], _leaves(state.mu_q), _leaves(state.mu_scale),
                _leaves(state.nu_q), _leaves(state.nu_scale), mask_c, **kw)
            new_state = Q8AdamState(count, *state[1:])
        else:
            kernel_ops.masked_adam_tree(p_c, g_c[:len(pl)],
                                        _leaves(state.mu),
                                        _leaves(state.nu), mask_c, **kw)
            new_state = AdamState(count, state.mu, state.nu)
    zero.gather_into(pl, p_c)
    return params, new_state, zero, g_c
