"""Dense decoder: ``ModelConfig`` -> init / forward / loss / serving steps.

Counterpart of ``repro.models.model`` for dense, attention-only
architectures (global and local attention blocks).  The
parameter tree keeps the JAX layout — ``stages[i]["posJ"][...]`` leaves
stacked ``[G, ...]``, one row per layer — because adapters index those
rows and the delta fingerprint hashes the leaf paths.  ``_stack_apply``
is a Python loop over the rows where JAX scans.

Weights are held in f32 and cast to the compute dtype at each matmul,
as in the JAX package (the delta fingerprint and the bit-exact revert
depend on the f32 leaves).

Training: ``loss_fn`` (next-token cross entropy, chunked over the
sequence when ``S * V`` is large) takes BlockLLM's ``overlay`` of
selected and probe rows, which replace their frozen rows layer by layer.

Serving caches are updated in place (the JAX package donates them):
the decode step writes row ``pos[b]`` of each slot only where
``active[b]``, which for attention-only blocks is equivalent to the
JAX server's whole-cache blend under its active mask.

Other families (MoE, recurrent, SSM, VLM, audio) and the paged and
speculative-verify branches are not ported yet (ROADMAP queue A) and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint.checkpointer import _flatten_with_names, tree_map
from repro_torch.configs.base import (BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN,
                                      ModelConfig)
from repro_torch.kernels import ops
from repro_torch.models import layers

Pytree = Any

ATTN_BLOCKS = (BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN)
ATTN_IMPLS = ("full", "kernel")


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; without one, raise (no silent CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass "
            "device='cpu' to run on the CPU explicitly")
    return dev


def check_supported(cfg: ModelConfig) -> None:
    """Raise for architectures the port does not serve yet."""
    why = None
    if cfg.family != "dense" or cfg.num_experts:
        why = f"family {cfg.family!r} (ROADMAP queue A: other families)"
    elif cfg.is_encoder_decoder or cfg.vision_embed_dim:
        why = "encoder-decoder / vision frontends (ROADMAP queue A)"
    elif any(t not in ATTN_BLOCKS for t in cfg.layer_types()):
        why = "non-attention blocks (ROADMAP queue A: other families)"
    elif not cfg.rope_theta:
        why = "absolute positions (ROADMAP queue A: other families)"
    if why:
        raise NotImplementedError(f"{cfg.name}: {why} not ported yet")


def _cdtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator]
                = None, device=None, dtype=torch.float32) -> Pytree:
    """Random weights with the JAX package's distributions (not its
    values: JAX's PRNG is not reproduced).  Normal(0, 1) * 0.02
    embeddings and head, normal / sqrt(fan_in) projections with the
    depth-scaled output projections, zero norm scales."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = generator or torch.Generator(dev).manual_seed(0)
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    H, KV, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    def block(G):
        out_scale = 1.0 / math.sqrt(H * hd) / math.sqrt(2 * L)
        p = {"ln1": {"scale": torch.zeros(G, d, device=dev)},
             "attn": {"wq": normal((G, d, H * hd), 1 / math.sqrt(d)),
                      "wk": normal((G, d, KV * hd), 1 / math.sqrt(d)),
                      "wv": normal((G, d, KV * hd), 1 / math.sqrt(d)),
                      "wo": normal((G, H * hd, d), out_scale)},
             "ln2": {"scale": torch.zeros(G, d, device=dev)}}
        if f:
            down = 1.0 / math.sqrt(f) / math.sqrt(2 * L)
            mlp = {"w_up": normal((G, d, f), 1 / math.sqrt(d)),
                   "w_down": normal((G, f, d), down)}
            if cfg.mlp_type in ("swiglu", "geglu"):
                mlp["w_gate"] = normal((G, d, f), 1 / math.sqrt(d))
            p["mlp"] = mlp
        return p

    params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "final_norm": {"scale": torch.zeros(d, device=dev)},
        "stages": [{f"pos{j}": block(groups) for j in range(len(pattern))}
                   for pattern, groups in cfg.stages()],
    }
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab_size), 0.02)
    if dtype != torch.float32:
        params = tree_map(lambda a: a.to(dtype), params)
    return params


def _attn_cache_len(cfg, btype, seq_len):
    if btype == BLOCK_LOCAL_ATTN:
        return min(cfg.window_size or seq_len, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None) -> Pytree:
    """Slot-batched decode cache mirroring the stage layout: per stage
    and pattern position ``{"k", "v"}`` of ``[G, batch, C, KV, hd]``."""
    check_supported(cfg)
    dev = resolve_device(device)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    stages = []
    for pattern, groups in cfg.stages():
        st = {}
        for j, btype in enumerate(pattern):
            C = _attn_cache_len(cfg, btype, seq_len)
            st[f"pos{j}"] = {
                "k": torch.zeros(groups, batch, C, KV, hd, dtype=dtype,
                                 device=dev),
                "v": torch.zeros(groups, batch, C, KV, hd, dtype=dtype,
                                 device=dev)}
        stages.append(st)
    return {"stages": stages}


def supports_slot_prefill(cfg: ModelConfig) -> bool:
    """Chunked batched prefill needs every block to be attention and a
    token-only frontend (all the port serves)."""
    return (not cfg.is_encoder_decoder and not cfg.vision_embed_dim
            and all(t in ATTN_BLOCKS for t in cfg.layer_types()))


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------


def _decode_attend(cfg, btype, q, k, v, cache, pos_b, active, attn_impl):
    """Write the new token's K/V row into the cache in place, then attend.

    Only slots with ``active[b]`` change: every slot's row at its write
    index is rewritten, inactive ones with their own old value, so their
    rows stay bit-exact with no host sync and no whole-cache blend."""
    ring = btype == BLOCK_LOCAL_ATTN
    window = cfg.window_size if ring else 0
    ck, cv = cache["k"], cache["v"]
    B, C = ck.shape[0], ck.shape[1]
    slot = (torch.remainder(pos_b, C) if ring else pos_b).long()
    bidx = torch.arange(B, device=ck.device)
    nk, nv = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
    if active is not None:
        keep = ~active[:, None, None]
        nk = torch.where(keep, ck[bidx, slot], nk)
        nv = torch.where(keep, cv[bidx, slot], nv)
    ck[bidx, slot] = nk
    cv[bidx, slot] = nv
    if attn_impl == "kernel":
        return ops.decode_attention(q, ck, cv, pos_b, window=window,
                                    softcap=cfg.attn_softcap, ring=ring)
    return layers.attention_decode(q, ck, cv, pos_b, window=window,
                                   softcap=cfg.attn_softcap, ring=ring)


class PrefillRows:
    """Row indices of one prefill chunk, computed on the host from the
    prompt lengths once per cache shape and shared by every layer (one
    host-to-device copy per chunk, not per layer).

    ``lengths`` [B]: each slot's full prompt length (0 for slots not
    being primed).  For a cache of ``C`` rows (``ring``: a ring buffer
    of the last ``C`` positions) ``get`` returns ``(hist_rows, hist_pos,
    b, s, dst)``: the cache rows and positions of the history before the
    chunk, and the valid chunk rows ``(b, s)`` with their cache rows
    ``dst`` — rows past a prompt's end (and, ring, rows the chunk
    itself overwrites) are dropped, so ``dst`` is unique per slot."""

    def __init__(self, lengths, chunk_start: int, S: int, device):
        self.lengths = np.asarray(lengths, np.int64)
        self.chunk_start, self.S, self.device = chunk_start, S, device
        self._by_shape = {}

    def get(self, C: int, ring: bool):
        key = (C, ring)
        if key not in self._by_shape:
            cs, S = self.chunk_start, self.S
            hist = min(cs, C)
            hp = np.arange(cs - hist, cs)
            pos_h = cs + np.arange(S)[None, :]
            last = np.minimum(self.lengths, cs + S)[:, None]
            valid = pos_h < last
            if ring:
                valid &= pos_h + C >= last
            bi, si = np.nonzero(valid)
            dst = pos_h[0, si] % C if ring else pos_h[0, si]
            t = [torch.as_tensor(a, device=self.device) for a in
                 (hp % C if ring else hp, hp, bi, si, dst)]
            self._by_shape[key] = t
        return self._by_shape[key]


def _prefill_attend(cfg, btype, q, k, v, cache, positions, rows: PrefillRows):
    """Chunked batched prefill of one block: scatter the chunk's valid
    K/V rows into the slot cache (in place) and attend causally over the
    already written history plus the chunk."""
    ring = btype == BLOCK_LOCAL_ATTN
    window = cfg.window_size if ring else 0
    ck, cv = cache["k"], cache["v"]
    B = positions.shape[0]
    hidx, hpos, b_t, s_t, dst = rows.get(ck.shape[1], ring)
    # history first: ring writes of this chunk may land on history rows
    kh = ck[:, hidx].to(q.dtype)
    vh = cv[:, hidx].to(q.dtype)
    ck[b_t, dst] = k[b_t, s_t].to(ck.dtype)
    cv[b_t, dst] = v[b_t, s_t].to(cv.dtype)
    # the chunk's own k/v round-trip through the cache dtype, so scores
    # match what the per-token path reads back
    kc = k.to(ck.dtype).to(q.dtype)
    vc = v.to(cv.dtype).to(q.dtype)
    kp = hpos.to(positions.dtype)[None].expand(B, len(hpos))
    return layers.attention_full(
        q, torch.cat([kh, kc], dim=1), torch.cat([vh, vc], dim=1),
        positions, torch.cat([kp, positions], dim=1),
        causal=True, window=window, softcap=cfg.attn_softcap)


def _block_apply(cfg, btype, params, x, *, positions, mode, cache=None,
                 pos=None, attn_impl="full", active=None):
    """One attention block.  ``mode``: ``train`` (full sequence, no
    cache), ``decode`` (one token, ``pos`` [B] write index) or
    ``prefill_slots`` (``pos`` = the chunk's ``PrefillRows``)."""
    window = cfg.window_size if btype == BLOCK_LOCAL_ATTN else 0
    h = layers.rms_norm(params["ln1"], x, cfg.norm_eps)
    B, S, D = h.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (h @ params["attn"]["wq"].to(h.dtype)).reshape(B, S, H, hd)
    k = (h @ params["attn"]["wk"].to(h.dtype)).reshape(B, S, KV, hd)
    v = (h @ params["attn"]["wv"].to(h.dtype)).reshape(B, S, KV, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    if mode == "decode":
        o = _decode_attend(cfg, btype, q, k, v, cache, pos, active,
                           attn_impl)
    elif mode == "prefill_slots":
        o = _prefill_attend(cfg, btype, q, k, v, cache, positions, pos)
    elif mode == "train":
        o = layers.attention_full(q, k, v, positions, positions, causal=True,
                                  window=window, softcap=cfg.attn_softcap)
    else:
        raise NotImplementedError(
            f"mode {mode!r} not ported yet (ROADMAP queue A: paged KV, "
            f"speculative verify)")
    x = x + o.reshape(B, S, H * hd) @ params["attn"]["wo"].to(x.dtype)
    h = layers.rms_norm(params["ln2"], x, cfg.norm_eps)
    if cfg.d_ff:
        return x + layers.mlp_apply(params["mlp"], h, cfg.mlp_type)
    return x


def _resolve_overlay(bp, g, ov):
    """BlockLLM's per-layer merge (``repro.models.model._resolve_overlay``).

    ``ov`` = {"idx": host list of the K selected rows, "rows": tree
    [K, ...], "pidx"/"probe": the probe rows likewise}.  A selected or
    probe row replaces the frozen row ``g`` (cast to its dtype), so the
    gradient lands directly on the [K, ...] rows; frozen rows carry no
    gradient (their tensors do not require one)."""
    for ikey, rkey in (("idx", "rows"), ("pidx", "probe")):
        rows = ov.get(rkey)
        if rows is None or g not in ov[ikey]:
            continue
        k = ov[ikey].index(g)
        _, base, td = _flatten_with_names(bp)
        picked = _flatten_with_names(rows)[1]
        bp = td.unflatten([a[k].to(f.dtype) for f, a in zip(base, picked)])
    return bp


def _stack_apply(cfg, stage_params, x, *, positions, mode, caches=None,
                 pos=None, attn_impl="full", active=None, overlay=None):
    """Apply the stacked blocks in order: a Python loop over the ``[G]``
    rows of each stage (JAX scans them).  ``overlay``: optional
    {"s{si}/pos{j}": ov} of BlockLLM active and probe rows (see
    ``_resolve_overlay``).  In train mode with ``cfg.remat`` each block
    is recomputed in the backward pass (``torch.utils.checkpoint``,
    where JAX wraps the scan body in ``jax.checkpoint``)."""
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for si, (pattern, groups) in enumerate(cfg.stages()):
        sp = stage_params[si]
        for g in range(groups):
            for j, btype in enumerate(pattern):
                bp = tree_map(lambda a: a[g], sp[f"pos{j}"])
                ov = (overlay or {}).get(f"s{si}/pos{j}")
                if ov is not None:
                    bp = _resolve_overlay(bp, g, ov)
                cj = None
                if caches is not None:
                    c = caches[si][f"pos{j}"]
                    cj = {"k": c["k"][g], "v": c["v"][g]}
                kw = dict(positions=positions, mode=mode, cache=cj, pos=pos,
                          attn_impl=attn_impl, active=active)
                if remat:
                    x = torch.utils.checkpoint.checkpoint(
                        lambda h, bp=bp, btype=btype, kw=kw: _block_apply(
                            cfg, btype, bp, h, **kw), x,
                        use_reentrant=False)
                else:
                    x = _block_apply(cfg, btype, bp, x, **kw)
    return x


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def _embed(params, cfg, tokens):
    emb = params["embed"]
    if emb.requires_grad:
        # training the table: JAX's cast-then-gather, so the gradient
        # accumulates over repeated tokens in the compute dtype as in JAX;
        # F.embedding's backward is deterministic, where the CPU backward
        # of advanced indexing accumulates in parallel in no fixed order
        return F.embedding(tokens, emb.to(_cdtype(cfg)))
    # gather, then cast: the same values without casting the whole table
    return emb[tokens].to(_cdtype(cfg))


def _unembed(params, cfg, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["head"].to(x.dtype)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _hidden(params, cfg, tokens, *, overlay=None):
    """Final-norm hidden states [B, S, D] of a full-sequence pass."""
    check_supported(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    x = _embed(params, cfg, tokens)
    x = _stack_apply(cfg, params["stages"], x, positions=positions,
                     mode="train", overlay=overlay)
    return layers.rms_norm(params["final_norm"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens, *, overlay=None):
    """Full-sequence teacher-forced logits [B, S, vocab] (``full``
    attention)."""
    return _unembed(params, cfg, _hidden(params, cfg, tokens,
                                         overlay=overlay))


def _labels_mask(batch):
    tokens = batch["tokens"]
    labels = batch.get("labels")
    if labels is None:
        labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                           dim=1)
        mask = torch.cat([torch.ones_like(tokens[:, 1:]),
                          torch.zeros_like(tokens[:, :1])], dim=1).float()
    else:
        mask = (labels >= 0).float()
        labels = labels.clamp(min=0)
    return labels, mask


def _xent_from_logits(logits, labels, mask):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return ((logz - gold) * mask).sum()


def _chunked_xent(params, cfg, hidden, labels, mask, chunk):
    """Cross entropy without materializing [B, S, V] logits: the sequence
    in chunks, each chunk's logits recomputed in the backward pass
    (``torch.utils.checkpoint``, where JAX uses ``jax.checkpoint``), the
    chunk sums added in order as JAX's scan carry does."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1

    def piece(xc, lc, mc):
        return _xent_from_logits(_unembed(params, cfg, xc), lc, mc)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, S, chunk):
        args = (hidden[:, s:s + chunk], labels[:, s:s + chunk],
                mask[:, s:s + chunk])
        total = total + (torch.utils.checkpoint.checkpoint(
            piece, *args, use_reentrant=False)
            if torch.is_grad_enabled() else piece(*args))
    return total


def loss_fn(params, cfg: ModelConfig, batch, *, attn_impl="full",
            loss_chunk=None, overlay=None):
    """Next-token cross entropy.  Returns ``(loss, metrics)``.

    ``loss_chunk``: None => auto (chunked when S * V > 2**27, as JAX);
    0 => direct.  Attention is ``full`` (JAX's ``chunked`` attention only
    differs for S > 2048, which the port does not train yet)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if attn_impl not in ("full", "chunked"):
        raise ValueError(f"attn_impl {attn_impl!r}: training attention is "
                         f"'full'")
    if attn_impl == "chunked" and S > 2048:
        raise NotImplementedError(
            "attention_chunked (S > 2048) is not ported yet (ROADMAP "
            "queue A)")
    labels, mask = _labels_mask(batch)
    if loss_chunk is None:
        loss_chunk = 512 if S * cfg.vocab_size > (1 << 27) else 0
    hidden = _hidden(params, cfg, tokens, overlay=overlay)
    if loss_chunk:
        nll_sum = _chunked_xent(params, cfg, hidden, labels, mask,
                                loss_chunk)
    else:
        nll_sum = _xent_from_logits(_unembed(params, cfg, hidden), labels,
                                    mask)
    denom = torch.clamp(mask.sum(), min=1.0)
    nll = nll_sum / denom
    aux = torch.zeros((), dtype=torch.float32, device=nll.device)
    loss = nll + aux
    return loss, {"nll": nll, "aux": aux, "tokens": mask.sum()}


def prefill_into_slots(params, cfg: ModelConfig, cache, tokens, lengths, *,
                       chunk_start=0, attn_impl="full"):
    """Chunked batched prefill into a slot-batched decode cache.

    ``tokens`` [B, K] (device): positions ``[chunk_start, chunk_start +
    K)`` of each slot's prompt, right-padded; ``lengths`` [B] (host
    array): each slot's full prompt length (0 for slots not being
    primed — their cache rows are not touched).  Writes the chunk's K/V
    rows into ``cache`` in place and returns ``(logits [B, vocab] at
    each slot's last valid position of this chunk, cache)``.
    """
    B, K = tokens.shape
    dev = tokens.device
    lengths = np.asarray(lengths, np.int64)
    positions = (chunk_start + torch.arange(K, dtype=torch.int32,
                                            device=dev))[None].expand(B, K)
    x = _embed(params, cfg, tokens)
    x = _stack_apply(cfg, params["stages"], x, positions=positions,
                     mode="prefill_slots", caches=cache["stages"],
                     pos=PrefillRows(lengths, chunk_start, K, dev),
                     attn_impl=attn_impl)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    # unembed only each slot's last valid row of this chunk, through the
    # same [B, 1, D] matmul shape the decode path uses
    li = np.clip(np.minimum(lengths, chunk_start + K) - 1 - chunk_start,
                 0, K - 1)
    xg = x[torch.arange(B, device=dev), torch.as_tensor(li, device=dev)]
    return _unembed(params, cfg, xg[:, None])[:, 0], cache


def decode_step(params, cfg: ModelConfig, cache, token, pos, *,
                attn_impl="full", active=None):
    """One decode step.  token [B, 1]; pos [B] int32 per-slot write
    index; ``active`` [B] bool (None = all slots) masks the in-place
    cache writes.  Returns ``(logits [B, vocab], cache)``."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {attn_impl!r}")
    B = token.shape[0]
    pos_b = torch.as_tensor(pos, dtype=torch.int32,
                            device=token.device).reshape(-1).expand(B)
    x = _embed(params, cfg, token)
    x = _stack_apply(cfg, params["stages"], x, positions=pos_b[:, None],
                     mode="decode", caches=cache["stages"], pos=pos_b,
                     attn_impl=attn_impl, active=active)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x)[:, 0], cache
