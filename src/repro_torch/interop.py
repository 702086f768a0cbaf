"""Parameter trees between the JAX package and the port, bit-exact.

The JAX side hands over its tree as numpy arrays (``jax.tree.map(
np.asarray, params)``; bfloat16 leaves arrive as ml_dtypes arrays); the
port works on nested dicts of tensors with the same layout.  Leaves are
matched by ``checkpoint._flatten_with_names`` — "/"-joined paths, dict
keys sorted, list indices as ints — which is how the tests give both
packages the same weights.  This module does not import ml_dtypes: it
reads such arrays through their raw bits, and hands bfloat16 back as a
``bfloat16`` numpy array only where that dtype is already registered
with numpy (otherwise as its raw uint16 bits).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import (_flatten_with_names,
                                                 from_numpy, to_numpy)

Pytree = Any


def tree_to_torch(tree: Pytree, device=None) -> Pytree:
    """Numpy tree -> tensor tree (same structure, bit-exact leaves)."""
    names, leaves, td = _flatten_with_names(tree)
    return td.unflatten([from_numpy(np.asarray(a)).to(device)
                         for a in leaves])


def _numpy_leaf(t) -> np.ndarray:
    arr, name = to_numpy(t)
    if str(arr.dtype) != name:
        try:                      # registered only when ml_dtypes is loaded
            arr = arr.view(np.dtype(name))
        except TypeError:
            pass                  # keep the raw bits
    return arr


def tree_to_numpy(tree: Pytree) -> Pytree:
    """Tensor tree -> numpy tree (same structure, bit-exact leaves)."""
    names, leaves, td = _flatten_with_names(tree)
    return td.unflatten([_numpy_leaf(t) for t in leaves])


def named_numpy(tree: Pytree) -> Dict[str, np.ndarray]:
    """``{leaf path: numpy array}`` keyed like the JAX checkpointer."""
    names, leaves, _ = _flatten_with_names(tree)
    return {n: _numpy_leaf(t) if isinstance(t, torch.Tensor) else
            np.asarray(t) for n, t in zip(names, leaves)}
