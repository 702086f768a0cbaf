"""LoRA baseline (Hu et al., 2021), counterpart of ``repro.baselines.lora``.

W_eff = W + (alpha / r) * A @ B for every targeted weight; the base is
frozen and only (A, B) train (full Adam on the factors).  Stacked layer
weights ``[G, m, n]`` get stacked factors ``A [G, m, r]``, ``B [G, r,
n]``.  Targets: the attention, MLP and recurrent projections inside the
block stacks; embeddings and norms stay frozen.

``lora_init`` draws JAX's distributions (A ~ N(0, 1/m), B = 0) from an
explicit generator in leaf-name order.  JAX's values cannot be
reproduced: it folds Python's per-process salted ``hash`` of the leaf
path into its key.  Parity tests carry JAX's factor tree across instead.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_names

Pytree = Any

TARGET_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "in_x", "in_y", "out", "gate_a", "gate_x")


def _is_target(name: str, leaf) -> bool:
    """``name``: the "/"-joined leaf path (``checkpoint`` naming)."""
    keys = name.split("/")
    return ("stages" in keys and keys[-1] in TARGET_KEYS
            and leaf.dim() >= 2 and leaf.shape[-1] >= 8
            and leaf.shape[-2] >= 8)


def lora_init(generator: Optional[torch.Generator], params: Pytree,
              rank: int = 8) -> Pytree:
    """Factor tree of the params' structure: ``{"A", "B"}`` for targeted
    leaves, None elsewhere."""
    names, leaves, td = _flatten_with_names(params)

    def init(name, leaf):
        if not _is_target(name, leaf):
            return None
        m, n = leaf.shape[-2], leaf.shape[-1]
        batch = tuple(leaf.shape[:-2])
        a = torch.randn(batch + (m, rank), generator=generator,
                        device=leaf.device) * (1.0 / math.sqrt(m))
        b = torch.zeros(batch + (rank, n), device=leaf.device)
        return {"A": a, "B": b}

    return td.unflatten([init(n, l) for n, l in zip(names, leaves)])


def lora_merge(params: Pytree, factors: Pytree, *, alpha: float,
               rank: int) -> Pytree:
    """Effective weights W + (alpha / r) A @ B; the base is detached, so
    gradients flow to the factors only."""
    scale = alpha / rank
    fnames, fl, _ = _flatten_with_names(factors)
    fac = {}
    for n, t in zip(fnames, fl):
        leaf, part = n.rsplit("/", 1)
        fac.setdefault(leaf, {})[part] = t
    names, leaves, td = _flatten_with_names(params)
    out = []
    for n, p in zip(names, leaves):
        f = fac.get(n)
        if f is None:
            out.append(p.detach())
        else:
            delta = torch.matmul(f["A"], f["B"]) * scale
            out.append(p.detach() + delta.to(p.dtype))
    return td.unflatten(out)
