"""The int8 block codec of ``repro.runtime.compression`` (Q8 state).

Each 256-element block of a flattened tensor is stored as int8 codes with
one f32 scale:

    scale = max(max|x| / 127, 1e-12);  codes = clip(round(x / scale), +-127)

``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes
are bit-identical to the JAX package's for the same f32 input.  The last
block is zero padded.  Only the codec is ported; the error-feedback
all-reduce waits for distributed training (ROADMAP queue A10).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.numerics import div_exact

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., N] -> (int8 codes [NB, BLOCK], f32 scales [NB])."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    scale = div_exact(blocks.abs().amax(dim=1, keepdim=True), 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q, scale, shape, dtype=torch.float32) -> torch.Tensor:
    vals = q.float() * scale[:, None]
    n = 1
    for d in shape:
        n *= d
    return vals.reshape(-1)[:n].reshape(shape).to(dtype)
