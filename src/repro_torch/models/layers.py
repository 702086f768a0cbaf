"""Core layers of the dense decoder (counterparts of ``repro.models.layers``).

Plain functions on tensors over dict parameters with the JAX layout.
Numerics follow the JAX package step for step: norm and rotary
internals in float32, attention logits and softmax in float32 with the
probabilities cast to q's dtype before the PV product, and the same
``-1e30`` additive mask bias.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(params, x, eps=1e-6):
    """RMSNorm in the ``(1 + scale)`` parameterization, f32 internals."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(dt)


def rope_freqs(head_dim, theta, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                     # [hd/2]


def apply_rope(x, positions, theta):
    """Split-half rotary embedding.  x [..., S, n, hd]; positions [..., S]."""
    if not theta:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs        # [..., S, hd/2]
    sin = torch.sin(angles)[..., None, :]                # over heads
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k, n_rep):
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def _mask_bias(q_pos, k_pos, *, causal, window):
    """[.., Sq, Sk] additive f32 bias (0 or -1e30) from position ids."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        ok &= diff >= 0
    if window:
        ok &= diff < window
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def attention_full(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                   softcap=0.0):
    """q [B,Sq,H,hd] k/v [B,Sk,KV,hd] -> [B,Sq,H,hd]."""
    hd = q.shape[-1]
    H, KV = q.shape[2], k.shape[2]
    k = _repeat_kv(k, H // KV)
    v = _repeat_kv(v, H // KV)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits * (1.0 / math.sqrt(hd))
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits + _mask_bias(q_pos, k_pos, causal=causal,
                                 window=window)[:, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def decode_valid(pos_b, S, *, window=0, ring=False):
    """[B, S] bool: which cache rows a one-token query at ``pos_b`` sees."""
    idx = torch.arange(S, device=pos_b.device)[None, :]
    pb = pos_b.long()[:, None]
    if ring:
        # slot i holds the token with absolute position p, p % S == i
        age = torch.remainder(pb - idx, S)
        valid = age < (window if window else S)
        valid &= pb >= age            # slot not yet written on early steps
    else:
        valid = idx <= pb
        if window:
            valid &= idx > pb - window
    return valid


def attention_decode(q, k_cache, v_cache, cur_pos, *, window=0, softcap=0.0,
                     ring=False):
    """One-token attention (the ``full`` decode path).  q [B,1,H,hd];
    caches [B,S,KV,hd]; ``cur_pos`` [B] is the index of the new token
    (already written).  GQA as a grouped einsum, probabilities cast to
    q's dtype before the PV product, as ``repro.models.layers``."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    k = k_cache.to(q.dtype)
    v = v_cache.to(q.dtype)
    qg = q.reshape(B, q.shape[1], KV, H // KV, hd)       # head h = kv*G + g
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    s = s * (1.0 / math.sqrt(hd))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = decode_valid(cur_pos.expand(B), S, window=window, ring=ring)
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(B, q.shape[1], H, hd)


def mlp_apply(params, x, mlp_type):
    """SwiGLU / GeGLU / plain GELU MLP; f32 weights cast to x's dtype."""
    wu = params["w_up"].to(x.dtype)
    wd = params["w_down"].to(x.dtype)
    if mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"].to(x.dtype)) * (x @ wu)
    elif mlp_type == "geglu":
        h = F.gelu(x @ params["w_gate"].to(x.dtype),
                   approximate="tanh") * (x @ wu)
    else:
        h = F.gelu(x @ wu, approximate="tanh")
    return h @ wd
