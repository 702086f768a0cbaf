"""Synthesize a row-sparse finetune (counterpart of ``repro.adapters.testing``).

Bumps ``rows`` of every per-layer parameter stack with numpy
``RandomState`` noise drawn in the same order as the JAX package (stage
by stage, pattern positions in order, leaves in sorted path order), so
the same seed perturbs the same rows by the same values in both
packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import tree_map


def perturb_rows(params, *, rows=(1, 3), scale=0.5, seed=0, leaf=None):
    """Return a tuned copy of ``params`` with ``rows`` of every layer
    stack perturbed by gaussian noise of ``scale`` (deterministic in
    ``seed``); ``leaf`` names an optional whole top-level leaf to shift
    (exercises whole-leaf delta entries)."""
    rng = np.random.RandomState(seed)
    ix = list(rows)

    def bump(a):
        noise = torch.from_numpy(rng.randn(len(ix), *a.shape[1:]))
        # rows past the stack are dropped, as JAX's scatter drops them
        keep = [i for i, r in enumerate(ix) if r < a.shape[0]]
        out = a.clone()
        out[[ix[i] for i in keep]] += scale * noise[keep].to(
            device=a.device, dtype=a.dtype)
        return out

    out = dict(params)
    out["stages"] = [{pos: tree_map(bump, sub) for pos, sub in stage.items()}
                     for stage in params["stages"]]
    if leaf is not None:
        out[leaf] = tree_map(lambda a: a + scale, out[leaf])
    return out
