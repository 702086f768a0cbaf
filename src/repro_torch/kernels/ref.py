"""PyTorch counterparts of the oracles in ``repro.kernels.ref`` (the test
ground truth of the ported kernels)."""
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


def masked_adam_ref(p, g, m, v, mask, scalars, *, use_tau=False):
    """Oracle for ``masked_adam``: ``scalars`` = [lr, b1, b2, eps, wd,
    bc1, bc2, tau] (f32 tensor); returns ``(p', m', v')``, inputs intact.
    ``1 - b1`` in f32 from the f32 scalar, as the TPU kernel."""
    lr, b1, b2, eps, wd, bc1, bc2, tau = [scalars[i] for i in range(8)]
    g = g.float()
    m2 = b1 * m + (1 - b1) * g
    v2 = b2 * v + (1 - b2) * g * g
    u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    gate = ((u.abs() >= tau).float() if use_tau else mask.float())
    p32 = p.float()
    u = u * gate + wd * p32
    return (p32 - lr * u).to(p.dtype), m2, v2


def masked_adam_q8_ref(p, g, mq, ms, vq, vs, mask, scalars, *,
                       use_tau=False):
    """Oracle for ``masked_adam_q8``: p/g/mask [NB, 256] codec views;
    mq/vq int8 [NB, 256]; ms/vs f32 [NB, 1].  Dequant -> masked_adam_ref
    -> requant with the runtime/compression.py formula."""
    m = mq.float() * ms
    v = vq.float() * vs
    p2, m2, v2 = masked_adam_ref(p, g, m, v, mask, scalars,
                                 use_tau=use_tau)

    def requant(x):
        s = torch.clamp(x.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
        return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s

    mq2, ms2 = requant(m2)
    vq2, vs2 = requant(v2)
    return p2, mq2, ms2, vq2, vs2
