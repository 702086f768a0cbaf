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


def sinusoid(pos, d):
    """f32 ``[..., d]`` absolute-position rows at the f32 positions
    ``pos [...]``: sin on the even columns, cos on the odd, each at
    ``pos * exp(-2i ln(10000) / d)`` (JAX's ``sinusoidal_positions`` and
    the inline rows of its ``decode_step``)."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=pos.device)
                    * (-math.log(10000.0) / d))
    ang = pos[..., None] * div
    pe = torch.empty(pos.shape + (d,), dtype=torch.float32,
                     device=pos.device)
    pe[..., 0::2] = torch.sin(ang)
    pe[..., 1::2] = torch.cos(ang)
    return pe


def sinusoidal_positions(S, d, dtype=torch.float32, device=None):
    """``[S, d]`` rows of positions ``0 .. S - 1``, in f32, then cast."""
    return sinusoid(torch.arange(S, dtype=torch.float32, device=device),
                    d).to(dtype)


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


def attention_chunked(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                      q_chunk=1024, kv_chunk=1024, softcap=0.0):
    """Blockwise online-softmax attention (``repro.models.layers.
    attention_chunked``): equal to ``attention_full`` up to the order of
    the sums, with live memory O(q_chunk * kv_chunk) per head.

    A static loop over q-chunks; q-chunk ``i`` visits only the kv-chunks
    in ``[lo, hi)`` (``hi`` the causal limit, ``lo`` the window's).  Each
    q-chunk keeps (m, l, acc) in f32 with the ``-1e30`` fully-masked-row
    guard; the scores are cast to f32 after the product and the
    probabilities to q's dtype before P·V, so bf16 rounds where JAX
    rounds.  With gradients on, each q-chunk runs under
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``): the backward
    recomputes the block probabilities instead of saving [B, H, qc, kc]
    per block pair."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    n_rep = H // KV
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Sk)
    assert Sq % q_chunk == 0 and Sk % kv_chunk == 0
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    scale = 1.0 / math.sqrt(hd)

    def q_block(qi, qp, ks, vs, kps):
        # qi [B, qc, H, hd], qp [B, qc]; ks/vs [B, n * kc, KV, hd]
        m = torch.full((B, H, q_chunk), float("-inf"), dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, H, q_chunk, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(0, ks.shape[1], kv_chunk):
            kif = _repeat_kv(ks[:, j:j + kv_chunk], n_rep)
            vif = _repeat_kv(vs[:, j:j + kv_chunk], n_rep)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kif).float() * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            s = s + _mask_bias(qp, kps[:, j:j + kv_chunk], causal=causal,
                               window=window)[:, None]
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.clamp(m_new, min=NEG_INF)   # fully-masked rows
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.clamp(m, min=NEG_INF) - m_safe)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(qi.dtype), vif).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.transpose(1, 2).to(q.dtype)            # [B, qc, H, hd]

    outs = []
    for i in range(nq):
        lo, hi = 0, nk
        if causal:
            hi = min(nk, ((i + 1) * q_chunk + kv_chunk - 1) // kv_chunk)
        if window:
            lo = max(0, (i * q_chunk - window) // kv_chunk)
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        ksl = slice(lo * kv_chunk, hi * kv_chunk)
        args = (q[:, qs], q_pos[:, qs], k[:, ksl], v[:, ksl], k_pos[:, ksl])
        outs.append(torch.utils.checkpoint.checkpoint(
            q_block, *args, use_reentrant=False)
            if torch.is_grad_enabled() else q_block(*args))
    return torch.cat(outs, dim=1)                         # [B, Sq, H, hd]


def decode_valid(pos_b, S, *, window=0, ring=False, offset=0, total=None):
    """[B, S] bool: which cache rows a one-token query at ``pos_b`` sees.
    A shard of a longer cache: its ``S`` rows are the whole cache's rows
    ``offset ..`` of ``total`` (the masks are the whole cache's)."""
    T = S if total is None else total
    idx = offset + torch.arange(S, device=pos_b.device)[None, :]
    pb = pos_b.long()[:, None]
    if ring:
        # slot i holds the token with absolute position p, p % T == i
        age = torch.remainder(pb - idx, T)
        valid = age < (window if window else T)
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


def attention_decode_shard(q, k_cache, v_cache, cur_pos, *, offset, total,
                           window=0, softcap=0.0, ring=False):
    """``attention_decode`` over a shard of a longer cache (rows
    ``offset ..`` of ``total``): ``(o [B,1,H,hd] f32, lse [B,H] f32)``,
    the shard's normalized output and each head's log-sum-exp of its
    scores, for a softmax merge across shards
    (``shard_ctx.merge_softmax``).  Scores, masks and probabilities in
    f32; a shard with no visible row gives o = 0 and lse = -inf."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    qg = q.float().reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float())
    s = s * (1.0 / math.sqrt(hd))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = decode_valid(cur_pos.expand(B), S, window=window, ring=ring,
                         offset=offset, total=total)[:, None, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -math.inf))
    lse = torch.logsumexp(s, dim=-1)                      # [B, KV, G, 1]
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse,
                                  torch.zeros_like(lse))[..., None])
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return o.reshape(B, 1, H, hd), lse.reshape(B, H)


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


# ---------------------------------------------------------------------------
# conv1d (depthwise, causal): the recurrent block's temporal conv
# ---------------------------------------------------------------------------


def conv1d_init(width, channels, *, generator, device, groups):
    """N(0, 0.1^2) taps ``w`` [groups, width, C] and zero bias ``b``
    [groups, C] (JAX's distributions, one row per layer)."""
    return {"w": torch.randn(groups, width, channels, generator=generator,
                             device=device) * 0.1,
            "b": torch.zeros(groups, channels, device=device)}


def causal_conv1d(params, x, *, state=None):
    """Depthwise causal conv.  x [B, S, C]; ``state`` [B, W - 1, C], the
    previous W - 1 inputs (decode; None: zeros).  Returns ``(y, new_state)``
    with ``new_state`` the last W - 1 inputs in x's dtype.  The taps are
    contracted as one einsum over the W shifted windows, as JAX's."""
    w = params["w"]
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros(x.shape[:1] + (W - 1,) + x.shape[2:])
        xp = torch.cat([pad, x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    windows = torch.stack([xp[:, i:i + S] for i in range(W)], dim=0)
    y = torch.einsum("wbsc,wc->bsc", windows, w.to(x.dtype))
    y = y + params["b"].to(x.dtype)
    return y, xp[:, -(W - 1):]
