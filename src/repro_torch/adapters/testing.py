"""Synthesize a row-sparse finetune (counterpart of ``repro.adapters.testing``).

Bumps ``rows`` of every per-layer parameter stack with numpy
``RandomState`` noise drawn in the same order as the JAX package (stage
by stage, pattern positions in order, leaves in sorted path order), so
the same seed perturbs the same rows by the same values in both
packages.  The draws depend only on the seed, the rows and the leaf
shapes, so the last few draws are kept on the host (``row_noise``): the
serving launcher's demo tenants, built again by every launcher run over
the same architecture, draw them once.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import tree_map


@functools.lru_cache(maxsize=4)
def row_noise(seed, n_rows, leaves):
    """``perturb_rows``'s draws for stacked ``leaves`` ((shape, dtype)
    pairs in its order): one ``[n_rows, *shape[1:]]`` block each from
    ``RandomState(seed).randn``, on the host, cast to an f32 leaf's dtype
    (the same rounding as casting on the device) and otherwise kept in
    f64.  Cached: treat the blocks as read-only."""
    rng = np.random.RandomState(seed)
    out = []
    for shape, dtype in leaves:
        noise = torch.from_numpy(rng.randn(n_rows, *shape[1:]))
        out.append(noise.float() if dtype == torch.float32 else noise)
    return tuple(out)


def perturb_rows(params, *, rows=(1, 3), scale=0.5, seed=0, leaf=None):
    """Return a tuned copy of ``params`` with ``rows`` of every layer
    stack perturbed by gaussian noise of ``scale`` (deterministic in
    ``seed``); ``leaf`` names an optional whole top-level leaf to shift
    (exercises whole-leaf delta entries)."""
    ix = list(rows)
    stacked = []
    for stage in params["stages"]:
        for sub in stage.values():
            tree_map(stacked.append, sub)
    noise = iter(row_noise(seed, len(ix), tuple(
        (tuple(a.shape), a.dtype) for a in stacked)))

    def bump(a):
        block = next(noise)
        # rows past the stack are dropped, as JAX's scatter drops them
        keep = [i for i, r in enumerate(ix) if r < a.shape[0]]
        out = a.clone()
        out[[ix[i] for i in keep]] += scale * block[keep].to(
            device=a.device, dtype=a.dtype)
        return out

    out = dict(params)
    out["stages"] = [{pos: tree_map(bump, sub) for pos, sub in stage.items()}
                     for stage in params["stages"]]
    if leaf is not None:
        out[leaf] = tree_map(lambda a: a + scale, out[leaf])
    return out
