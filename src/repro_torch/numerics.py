"""Correctly rounded f32 arithmetic where PyTorch's fast paths are not.

The JAX package's elementwise math (XLA on the CPU, the TPU kernels) uses
IEEE division and square root.  Two PyTorch fast paths differ from it in
the last bit, which then moves a BlockLLM mask element at its threshold
or an int8 code of the Q8 state:

- CUDA division by a Python scalar multiplies by the reciprocal;
- the CPU's vectorized ``sqrt`` (SLEEF) is not correctly rounded.
"""
from __future__ import annotations

import torch


def div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def sqrt_exact(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 ``sqrt``: the CUDA ``sqrtf`` is; on the CPU
    the square root is taken in f64 and rounded once to f32 (exact: 53
    bits >= 2 * 24 + 2)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)
