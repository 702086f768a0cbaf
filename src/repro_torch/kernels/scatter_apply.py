"""Row scatter-swap: the adapter hot-swap (counterpart of
``repro.kernels.scatter_apply``).

Applying a BlockDelta adapter touches only the K delta rows of each
[G, ...] parameter stack.  One pass over only those rows, in place:

    displaced[k] = full[idx[k]];  full[idx[k]] = rows[k]

- ``scatter_swap_cuda`` launches the Hopper kernel
  (``csrc/scatter_swap.cu``): bitwise, 2 row reads + 2 row writes per
  delta row, untouched rows never read;
- ``scatter_swap_plain`` is the same function in plain PyTorch, used
  for CPU tensors and as the kernel's reference on the card.

Both update ``full`` in place (where the JAX package donates the
buffer) and view a ``[G, ...]`` leaf as ``[G, C]`` without copying, so
the leaf must be contiguous.  The swap is an involution: swapping the
displaced rows back restores ``full`` bit-exactly.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build


def _rows_view(full: torch.Tensor) -> torch.Tensor:
    if not full.is_contiguous():
        raise ValueError("scatter_swap updates the leaf in place through a "
                         "[G, C] view: the leaf must be contiguous")
    return full.view(full.shape[0], -1)


def _host_idx(idx, G: int) -> np.ndarray:
    """idx as a host int32 array, checked unique and in [0, G)."""
    if isinstance(idx, torch.Tensor):
        idx = idx.detach().cpu().numpy()
    idx = np.asarray(idx)
    if idx.ndim != 1 or not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(f"idx must be a 1-D integer array, got "
                         f"{idx.dtype} {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= G):
        raise ValueError(f"idx out of range [0, {G}): {idx.tolist()}")
    if len(np.unique(idx)) != len(idx):
        raise ValueError(f"idx must be unique: {idx.tolist()}")
    return idx.astype(np.int32)


def scatter_swap_plain(full, idx, rows):
    """Plain PyTorch version: ``full[idx] = rows`` in place; returns
    ``(full, displaced)`` with ``displaced`` [K, ...] = old ``full[idx]``."""
    f2 = _rows_view(full)
    ix = torch.as_tensor(_host_idx(idx, f2.shape[0]), dtype=torch.long,
                         device=full.device)
    r2 = rows.reshape(rows.shape[0], -1).to(device=full.device,
                                            dtype=full.dtype)
    displaced = f2[ix]                 # advanced indexing gathers a copy
    f2[ix] = r2
    return full, displaced.reshape((len(ix),) + tuple(full.shape[1:]))


def scatter_swap_cuda(full, idx, rows):
    """Launch the Hopper kernel (``csrc/scatter_swap.cu``) in place on
    ``full``; returns ``(full, displaced)``.  Rows in another dtype are
    cast first (a [K, C] copy), as ``astype`` does in the TPU kernel."""
    if not full.is_cuda:
        raise ValueError("scatter_swap_cuda needs a CUDA tensor")
    f2 = _rows_view(full)
    G, C = f2.shape
    host_idx = _host_idx(idx, G)
    K = len(host_idx)
    if rows.device != full.device:
        raise ValueError(f"rows on {rows.device}, leaf on {full.device}")
    if rows.shape[0] != K or rows[0].numel() != C:
        raise ValueError(f"rows {tuple(rows.shape)} do not match idx [{K}] "
                         f"and leaf rows of {C} elements")
    if K == 0 or K > 65535:
        raise ValueError(f"kernel takes 1..65535 rows, got {K}")
    r2 = rows.reshape(K, C).to(full.dtype).contiguous()
    displaced = torch.empty((K, C), dtype=full.dtype, device=full.device)
    # pinned, so the small copy is queued on the stream without
    # waiting for the work before it
    idx_dev = torch.from_numpy(host_idx).pin_memory().to(
        full.device, non_blocking=True)
    for t in (f2, r2, displaced):
        if t.data_ptr() % 16:
            raise ValueError("kernel takes 16-byte aligned tensors")
    lib = build.library("scatter_swap")
    stream = torch.cuda.current_stream(full.device).cuda_stream
    rc = lib.scatter_swap_launch(
        f2.data_ptr(), idx_dev.data_ptr(), r2.data_ptr(),
        displaced.data_ptr(), K, C * full.element_size(),
        ctypes.c_void_p(stream))
    build.check("scatter_swap", rc)
    build.LAUNCHES["scatter_swap"] += 1
    return full, displaced.reshape((K,) + tuple(full.shape[1:]))
