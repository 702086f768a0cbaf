"""PyTorch counterparts of the oracles in ``repro.kernels.ref`` (the test
ground truth for the serving slice's kernels)."""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import decode_valid


def decode_attention_ref(q, k_cache, v_cache, pos, *, window=0, ring=False,
                         softcap=0.0, scale=None):
    """Oracle for ``decode_attention``: q [B, 1, H, hd]; caches
    [B, C, KV, hd]; pos [B] (or scalar) is the index of the new token.
    Repeated kv heads, one full softmax, all arithmetic in f32."""
    B, C, KV, hd = k_cache.shape
    H = q.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    pos_b = torch.as_tensor(pos, dtype=torch.int32,
                            device=q.device).reshape(-1).expand(B)
    k = k_cache.repeat_interleave(H // KV, dim=2).float()
    v = v_cache.repeat_interleave(H // KV, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = decode_valid(pos_b, C, window=window, ring=ring)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -math.inf))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isfinite(s).any(-1, keepdim=True), p,
                    torch.zeros_like(p))
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def scatter_swap_ref(full, idx, rows):
    """Oracle for ``scatter_swap``: full [G, C]; idx [K] unique; rows
    [K, C].  Returns (a copy of full with rows written at idx, the
    displaced rows); the inputs are not modified."""
    idx = torch.as_tensor(idx, dtype=torch.long, device=full.device)
    out = full.clone()
    out[idx] = rows.to(full.dtype)
    return out, full[idx]
