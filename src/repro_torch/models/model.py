"""Decoder: ``ModelConfig`` -> init / forward / loss / serving steps.

Counterpart of ``repro.models.model`` for dense architectures (global
and local attention blocks), the hybrid RG-LRU family (recurrent
blocks beside local attention, ``models/rglru.py``) and the MoE family
(attention blocks whose feed-forward is ``models/moe.py``).  The
parameter tree keeps the JAX layout — ``stages[i]["posJ"][...]`` leaves
stacked ``[G, ...]``, one row per layer — because adapters index those
rows and the delta fingerprint hashes the leaf paths.  ``_stack_apply``
is a Python loop over the rows where JAX scans.

Weights are held in f32 and cast to the compute dtype at each matmul,
as in the JAX package (the delta fingerprint and the bit-exact revert
depend on the f32 leaves).

Training: ``loss_fn`` (next-token cross entropy, chunked over the
sequence when ``S * V`` is large, plus the MoE router's aux loss summed
over the layers) takes BlockLLM's ``overlay`` of selected and probe
rows, which replace their frozen rows layer by layer.

MoE blocks route every row they are given, in every mode: the padding
and idle slots of a prefill chunk or a decode step take expert capacity
as in the JAX package.

Serving caches are updated in place (the JAX package donates them):
the decode step writes row ``pos[b]`` of each slot, and a recurrent
block's state ``{"h", "conv"}``, only where ``active[b]``, which is
equivalent to the JAX server's whole-cache blend under its active mask.
Recurrent blocks take no chunked slot prefill (their state would
advance on the padding of shorter prompts): the server primes them token
by token.

Paged KV (``init_paged_cache``): global-attention blocks keep pools
``[P, page_size, KV, hd]`` addressed through a per-slot page table
(``runtime/paged_kv.py``); the decode step writes and attends through
the table in one op (``ops.paged_decode_attention``, the fused kernel
on the card), chunked prefill scatters its rows through it.  Row
indices of a prefill chunk are computed on the host once per chunk and
shared by every layer; the decode step copies the page table to the
device once.

xLSTM (family ``ssm``, ``models/xlstm.py``): an mLSTM or sLSTM block
is its own residual branch (``x + block(x)``, no outer norm or MLP); its
decode state (``{"C", "n", "m"}`` / ``{"c", "n", "m", "h"}``, f32 under
any cache dtype) is written like the RG-LRU's, only where ``active[b]``,
and the server primes it token by token.

Encoder-decoder (whisper, family ``audio``): ``_encode`` maps the stub
frame embeddings ``frames`` [B, Se, F] through ``encoder.frontend``,
adds absolute sinusoidal positions and runs the encoder's own
non-causal MHA blocks; ``_cross_kv`` projects its output once per
forward into each decoder row's cross k/v, and every decoder block
cross-attends (``lnx``, ``xattn``) after its self-attention.  Decoder
tokens take absolute positions too (``rope_theta == 0``).  Decoding is
model-level: ``init_cache`` holds a ``cross_kv`` per decoder row, filled
from ``prefill``'s; slot prefill, paged KV and speculation are refused
as JAX's predicates refuse them, and so is the ``DecodeServer``.  As in
JAX, ``_cross_kv`` reads the frozen ``params["stages"]``, not BlockLLM's
overlay, so a selected row's ``xattn.wk`` / ``xattn.wv`` get no gradient
through the overlay (ROADMAP C, "Faults of the reference").

VLM (pixtral, family ``vlm``): ``_embed`` projects the stub patch
embeddings ``patch_embeds`` [B, P, E] through ``vision_proj`` in the
compute dtype and puts them in place of the first P token positions
(multimodal packing); the text backbone is the dense one.  Slot prefill,
paged KV and speculation are refused, as JAX's predicates refuse them.

Whole-sequence prefill (``forward(mode="prefill")``, ``prefill``) fills
a cache in ``init_cache``'s layout: each attention block's K/V rows, and
each recurrent block's final state (RG-LRU ``{"h", "conv"}``, mLSTM
``{"C", "n", "m"}``, sLSTM ``{"c", "n", "m", "h"}``).  ``prefill``
unembeds the last position only.

Sharded decode (``launch.steps.build_decode_setup``): under a
``shard_ctx`` whose rules carry ``cache_specs``, ``decode_step`` runs on
this rank's cache shards as the specs lay them out.  Batch over the data
axes and KV heads over the model axis need nothing more; where the
cache's sequence dim is split, the rank whose rows hold a slot's write
index writes its new row (every other rank's rows keep their bits), each
rank attends over its rows with the whole cache's masks (the decode
kernel's shard variant, or ``attention_decode_shard``) and
``shard_ctx.softmax_merge`` combines the ranks' outputs; q (and the new
K/V row) are all-gathered over the model axis first where the cache
holds every KV head and the projections gave this rank only its own.  A
recurrent or xLSTM state split on a feature dim, and an encoder's cross
k/v split on its sequence, are all-gathered for the block, which then
keeps its slice.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint.checkpointer import _flatten_with_names, tree_map
from repro_torch.configs.base import (BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN,
                                      BLOCK_MLSTM, BLOCK_RECURRENT,
                                      BLOCK_SLSTM, ModelConfig)
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.models import layers, moe, rglru, xlstm
from repro_torch.runtime import shard_ctx
from repro_torch.runtime.moe_parallel import moe_apply_maybe_sharded

Pytree = Any

ATTN_BLOCKS = (BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN)
XLSTM_BLOCKS = (BLOCK_MLSTM, BLOCK_SLSTM)
# blocks with a recurrent decode state: no chunked prefill, no rollback
RECURRENT_BLOCKS = (BLOCK_RECURRENT,) + XLSTM_BLOCKS
ATTN_IMPLS = ("full", "kernel")


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; without one, raise (no silent CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass "
            "device='cpu' to run on the CPU explicitly")
    return dev


FAMILIES = ("dense", "hybrid", "moe", "ssm", "audio", "vlm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for an architecture the port does not run: a family outside
    ``FAMILIES`` (dense, hybrid RG-LRU, MoE, xLSTM ``ssm``, the ``audio``
    encoder-decoder and the ``vlm`` patch embeds, with every block type
    and absolute or rotary positions), or experts outside ``moe``."""
    if cfg.family not in FAMILIES:
        why = f"family {cfg.family!r} (the port runs {', '.join(FAMILIES)})"
    elif cfg.num_experts and cfg.family != "moe":
        why = f"experts in family {cfg.family!r} (only moe has experts)"
    else:
        return
    raise NotImplementedError(f"{cfg.name}: {why} is not supported")


def check_tensor_parallel(cfg: ModelConfig, tp_size=None) -> None:
    """Raise where tensor parallelism (a model axis above 1, from the
    installed ``shard_ctx`` unless ``tp_size`` is given) meets a block
    the port does not split yet: RG-LRU, encoder-decoder, VLM."""
    if tp_size is None:
        ctx = shard_ctx.get()
        tp_size = ctx.tp_size if ctx is not None else 1
    if tp_size <= 1:
        return
    if BLOCK_RECURRENT in cfg.layer_types():
        what = "RG-LRU blocks"
    elif cfg.is_encoder_decoder:
        what = "the encoder-decoder"
    elif cfg.vision_embed_dim:
        what = "the VLM's vision projection"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: tensor parallelism over {what} is not ported (ROADMAP "
        f"queue A, item 4b: TP for the RG-LRU, encoder-decoder and VLM "
        f"blocks); data parallelism runs")


def _cdtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's shape (JAX's ``enc_cfg``): global MHA blocks,
    ``num_encoder_layers`` of them, no experts, absolute positions."""
    return cfg.replace(num_layers=cfg.num_encoder_layers,
                       pattern=(BLOCK_GLOBAL_ATTN,), num_experts=0,
                       is_encoder_decoder=False, rope_theta=0.0,
                       num_kv_heads=cfg.num_heads)


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator]
                = None, device=None, dtype=torch.float32) -> Pytree:
    """Random weights with the JAX package's distributions (not its
    values: JAX's PRNG is not reproduced).  Normal(0, 1) * 0.02
    embeddings and head, normal / sqrt(fan_in) projections with the
    depth-scaled output projections, zero norm scales; recurrent blocks
    as ``rglru.rglru_init``, an MoE block's ``moe`` leaf (in place of
    ``mlp``) as ``moe.moe_init``; an mLSTM / sLSTM block's row is
    ``xlstm.mlstm_init`` / ``slstm_init`` itself (no ``ln1`` / ``ln2``),
    as JAX's ``_block_init``.  An encoder-decoder model's decoder rows
    add ``lnx`` and an MHA ``xattn``, and its ``encoder`` holds the
    ``frontend`` map, the encoder's own stages (their output scales from
    ``num_encoder_layers``) and its ``final_norm``.  A VLM adds
    ``vision_proj`` [vision_embed_dim, d_model], normal / sqrt(fan_in).
    The dense leaves are cast to ``dtype`` as they are drawn (the same
    values as casting the tree at the end, without an f32 copy of it)."""
    check_supported(cfg)
    dev = resolve_device(device)
    # the meta device (``launch.specs.params_abstract``) has no
    # generator: a CPU one stands in, and meta tensors draw nothing
    gen = generator or torch.Generator(
        "cpu" if dev.type == "meta" else dev).manual_seed(0)
    d, hd, H = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def mlp(c, G):
        f = c.d_ff
        down = 1.0 / math.sqrt(f) / math.sqrt(2 * c.num_layers)
        p = {"w_up": normal((G, d, f), 1 / math.sqrt(d)),
             "w_down": normal((G, f, d), down)}
        if c.mlp_type in ("swiglu", "geglu"):
            p["w_gate"] = normal((G, d, f), 1 / math.sqrt(d))
        return p

    def attn(c, G, KV):
        out_scale = 1.0 / math.sqrt(H * hd) / math.sqrt(2 * c.num_layers)
        return {"wq": normal((G, d, H * hd), 1 / math.sqrt(d)),
                "wk": normal((G, d, KV * hd), 1 / math.sqrt(d)),
                "wv": normal((G, d, KV * hd), 1 / math.sqrt(d)),
                "wo": normal((G, H * hd, d), out_scale)}

    def block(c, G, btype):
        if btype in XLSTM_BLOCKS:
            init = (xlstm.mlstm_init if btype == BLOCK_MLSTM
                    else xlstm.slstm_init)
            return init(c, generator=gen, device=dev, groups=G)
        p = {"ln1": {"scale": zeros(G, d)}, "ln2": {"scale": zeros(G, d)}}
        if btype == BLOCK_RECURRENT:
            p["rec"] = rglru.rglru_init(c, generator=gen, device=dev,
                                        groups=G)
            p["mlp"] = mlp(c, G)
            return p
        p["attn"] = attn(c, G, c.num_kv_heads)
        if c.num_experts:
            p["moe"] = moe.moe_init(c, generator=gen, device=dev, groups=G)
        elif c.d_ff:
            p["mlp"] = mlp(c, G)
        if c.is_encoder_decoder:             # cross attention is MHA
            p["lnx"] = {"scale": zeros(G, d)}
            p["xattn"] = attn(c, G, H)
        return p

    def stages(c):
        return [{f"pos{j}": block(c, groups, btype)
                 for j, btype in enumerate(pattern)}
                for pattern, groups in c.stages()]

    params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "final_norm": {"scale": zeros(d)},
        "stages": stages(cfg),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab_size), 0.02)
    if cfg.vision_embed_dim:
        params["vision_proj"] = normal((cfg.vision_embed_dim, d),
                                       1 / math.sqrt(cfg.vision_embed_dim))
    if cfg.is_encoder_decoder:
        feat = cfg.encoder_feature_dim or d
        params["encoder"] = {
            "frontend": normal((feat, d), 1 / math.sqrt(feat)),
            "stages": stages(_encoder_cfg(cfg)),
            "final_norm": {"scale": zeros(d)}}
    if dtype != torch.float32:   # the family inits' f32 leaves
        params = tree_map(lambda a: a.to(dtype), params)
    return params


def _attn_cache_len(cfg, btype, seq_len):
    if btype == BLOCK_LOCAL_ATTN:
        return min(cfg.window_size or seq_len, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None) -> Pytree:
    """Slot-batched decode cache mirroring the stage layout: per stage
    and pattern position ``{"k", "v"}`` of ``[G, batch, C, KV, hd]``, or
    for a recurrent block ``{"h": [G, batch, W] f32, "conv": [G, batch,
    cw - 1, W]}``, or an xLSTM block's state (``xlstm.*_init_cache``:
    f32 whatever ``dtype``, as in JAX).  An encoder-decoder model's
    cache adds ``cross_kv``: per stage and position ``{"k", "v"}`` of
    ``[G, batch, encoder_seq_len, H, hd]`` (zeros; ``prefill`` gives the
    values)."""
    check_supported(cfg)
    dev = resolve_device(device)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    stages = []
    for pattern, groups in cfg.stages():
        st = {}
        for j, btype in enumerate(pattern):
            if btype == BLOCK_RECURRENT:
                st[f"pos{j}"] = rglru.init_cache(cfg, batch, groups=groups,
                                                 dtype=dtype, device=dev)
                continue
            if btype in XLSTM_BLOCKS:
                init = (xlstm.mlstm_init_cache if btype == BLOCK_MLSTM
                        else xlstm.slstm_init_cache)
                st[f"pos{j}"] = init(cfg, batch, groups=groups, device=dev)
                continue
            C = _attn_cache_len(cfg, btype, seq_len)
            st[f"pos{j}"] = {
                "k": torch.zeros(groups, batch, C, KV, hd, dtype=dtype,
                                 device=dev),
                "v": torch.zeros(groups, batch, C, KV, hd, dtype=dtype,
                                 device=dev)}
        stages.append(st)
    cache = {"stages": stages}
    if cfg.is_encoder_decoder:
        shape = (batch, cfg.encoder_seq_len, cfg.num_heads, hd)
        cache["cross_kv"] = [
            {f"pos{j}": {n: torch.zeros((groups,) + shape, dtype=dtype,
                                        device=dev) for n in ("k", "v")}
             for j in range(len(pattern))}
            for pattern, groups in cfg.stages()]
    return cache


def init_paged_cache(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, seq_len: int, dtype=torch.bfloat16,
                     device=None) -> Pytree:
    """Paged decode cache: global-attention blocks get pools ``{"pk",
    "pv"}`` of ``[G, num_pages, page_size, KV, hd]`` (page 0 is the null
    page of unmapped table entries); local-attention blocks keep their
    dense ring ``{"k", "v"}`` of ``[G, batch, C, KV, hd]``."""
    check_supported(cfg)
    if not supports_paged_kv(cfg):
        raise ValueError("paged KV supports attention blocks only "
                         "(see supports_paged_kv)")
    dev = resolve_device(device)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    stages = []
    for pattern, groups in cfg.stages():
        st = {}
        for j, btype in enumerate(pattern):
            if btype == BLOCK_GLOBAL_ATTN:
                shape, names = (groups, num_pages, page_size, KV, hd), \
                    ("pk", "pv")
            else:
                C = _attn_cache_len(cfg, btype, seq_len)
                shape, names = (groups, batch, C, KV, hd), ("k", "v")
            st[f"pos{j}"] = {n: torch.zeros(shape, dtype=dtype, device=dev)
                             for n in names}
        stages.append(st)
    return {"stages": stages}


# each recurrent state's leaves -> the value a fresh cache holds there
_FRESH_STATES = {frozenset(f): f for f in (
    {"h": 0.0, "conv": 0.0}, xlstm.MLSTM_FRESH, xlstm.SLSTM_FRESH)}


def reset_recurrent_state(cache, slots):
    """Give ``slots`` the state a fresh cache has in every recurrent
    block (RG-LRU ``h`` and ``conv`` 0; mLSTM ``m = -inf``; sLSTM ``n =
    1e-6``, ``m = -1e30``; the rest 0), in place on the device: a slot's
    next request then starts as on a fresh server.  Attention rows need
    no reset (they are masked by position)."""
    states = [(a, _FRESH_STATES[frozenset(blk)][name])
              for st in cache["stages"] for blk in st.values()
              if frozenset(blk) in _FRESH_STATES
              for name, a in blk.items()]
    if states:
        idx = torch.as_tensor(slots, dtype=torch.long,
                              device=states[0][0].device)
        for a, value in states:
            a.index_fill_(1, idx, value)
    return cache


def copy_cache_pages(cache, src, dst):
    """Copy physical pages ``src -> dst`` in every pooled leaf, in place:
    the device half of a copy-on-write split.  ``src``/``dst`` are equal-
    length int sequences (host or device)."""
    pools = [a for st in cache["stages"] for blk in st.values()
             if "pk" in blk for a in blk.values()]
    if pools:
        d = torch.as_tensor(dst, dtype=torch.long, device=pools[0].device)
        s = torch.as_tensor(src, dtype=torch.long, device=pools[0].device)
        for a in pools:
            a[:, d] = a[:, s]
    return cache


def supports_slot_prefill(cfg: ModelConfig) -> bool:
    """Chunked batched prefill needs every block to be attention and a
    token-only frontend (all the port serves)."""
    return (not cfg.is_encoder_decoder and not cfg.vision_embed_dim
            and all(t in ATTN_BLOCKS for t in cfg.layer_types()))


def supports_paged_kv(cfg: ModelConfig) -> bool:
    """Paged KV needs position-addressable K/V rows in every block and a
    token-only frontend: the bar of chunked slot prefill."""
    return supports_slot_prefill(cfg)


def supports_spec_decode(cfg: ModelConfig) -> bool:
    """Self-speculative serving needs slot prefill and every block
    global: rejected draft rows roll back by position masking, which
    ring-buffer local-attention rows do not allow (a write at p clobbers
    the live row at p - C)."""
    return (supports_slot_prefill(cfg)
            and all(t == BLOCK_GLOBAL_ATTN for t in cfg.layer_types()))


def supports_prefix_share(cfg: ModelConfig) -> bool:
    """Prefix sharing covers the pooled caches only, so every block must
    be global (local blocks keep per-slot ring rows)."""
    return (supports_paged_kv(cfg)
            and all(t == BLOCK_GLOBAL_ATTN for t in cfg.layer_types()))


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------


def _paged_decode_attend(cfg, q, k, v, cache, pos_b, page_table, active,
                         attn_impl):
    """Paged decode of a global block: write each active slot's new row
    into its page and attend through the page table.  ``kernel`` is the
    fused write+attend op; ``full`` writes, gathers the dense view and
    runs the same ``attention_decode`` as the dense path (the JAX
    package's XLA fallback), so both equal their dense counterparts."""
    B = q.shape[0]
    act = (torch.ones(B, dtype=torch.bool, device=q.device)
           if active is None else active)
    if attn_impl == "kernel":
        o, _, _ = ops.paged_decode_attention(
            q, k[:, 0], v[:, 0], cache["pk"], cache["pv"], pos_b,
            page_table, act, softcap=cfg.attn_softcap)
        return o
    ck, cv = da.paged_write_gather(k[:, 0], v[:, 0], cache["pk"],
                                   cache["pv"], pos_b, page_table, act)
    return layers.attention_decode(q, ck, cv, pos_b,
                                   softcap=cfg.attn_softcap)


def _decode_attend(cfg, btype, q, k, v, cache, pos_b, active, attn_impl,
                   spec=None):
    """Write the new token's K/V row into the cache in place, then attend.

    Only slots with ``active[b]`` change: every slot's row at its write
    index is rewritten, inactive ones with their own old value, so their
    rows stay bit-exact with no host sync and no whole-cache blend.

    ``spec``: the spec of the K leaf ``[G, B, C, KV, hd]`` of a sharded
    decode (``sharding.cache_specs``; None, or no context: the whole
    cache).  Where its sequence dim is split, this rank holds rows
    ``offset ..`` of the whole cache: it writes a slot's row only where
    the write index falls in its rows, attends over them with the whole
    cache's masks and merges with the other ranks
    (``shard_ctx.softmax_merge``).  Where the cache holds every KV head
    and this rank's projections only its own, q and the new K/V row are
    all-gathered over the model axis first and o keeps its own heads."""
    ctx = shard_ctx.get() if spec is not None else None
    ring = btype == BLOCK_LOCAL_ATTN
    window = cfg.window_size if ring else 0
    ck, cv = cache["k"], cache["v"]
    B, C = ck.shape[0], ck.shape[1]
    seq = ctx.split_axes(spec[2]) if ctx is not None else ()
    offset = ctx.coord(seq) * C if seq else 0
    total = C * ctx.axis_size(seq) if seq else C
    H_local = q.shape[2]
    if ctx is not None and ck.shape[2] == cfg.num_kv_heads:
        tp = ctx.tp_axis
        if k.shape[2] < cfg.num_kv_heads:
            k, v = (shard_ctx.all_gather(t.movedim(2, 0).contiguous(), tp,
                                         "decode/kv_all_gather").movedim(0, 2)
                    for t in (k, v))
        if H_local < cfg.num_heads:
            q = shard_ctx.all_gather(q.movedim(2, 0).contiguous(), tp,
                                     "decode/q_all_gather").movedim(0, 2)
    slot = (torch.remainder(pos_b, total) if ring else pos_b).long()
    keep = None if active is None else ~active
    if seq:
        slot = slot - offset
        mine = (slot >= 0) & (slot < C)
        keep = ~mine if keep is None else keep | ~mine
        slot = slot.clamp(0, C - 1)
    bidx = torch.arange(B, device=ck.device)
    nk, nv = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
    if keep is not None:
        nk = torch.where(keep[:, None, None], ck[bidx, slot], nk)
        nv = torch.where(keep[:, None, None], cv[bidx, slot], nv)
    ck[bidx, slot] = nk
    cv[bidx, slot] = nv
    kw = dict(window=window, softcap=cfg.attn_softcap, ring=ring)
    if not seq:
        if attn_impl == "kernel":
            o = ops.decode_attention(q, ck, cv, pos_b, **kw)
        else:
            o = layers.attention_decode(q, ck, cv, pos_b, **kw)
    else:
        if attn_impl == "kernel":
            o, lse = ops.decode_attention(q.float(), ck, cv, pos_b,
                                          offset=offset, total=total,
                                          return_lse=True, **kw)
        else:
            o, lse = layers.attention_decode_shard(
                q, ck, cv, pos_b, offset=offset, total=total, **kw)
        o, _ = shard_ctx.softmax_merge(o, lse, seq)
        o = o.to(q.dtype)
    if q.shape[2] != H_local:
        o = o.narrow(2, ctx.coord(ctx.tp_axis) * H_local, H_local)
    return o


def _gather_split(tensors, specs, kind):
    """Whole copies of one row's cache leaves (``{name: [B, ...]}``, row
    ``g`` of leaves ``[G, B, ...]`` whose ``specs`` split a dim past the
    batch) and, per gathered name, ``(dim, index, size)`` of this rank's
    slice (``_scatter_split`` writes it back)."""
    ctx = shard_ctx.get()
    out, cuts = dict(tensors), {}
    for name, t in tensors.items():
        for d, entry in enumerate(specs[name]):
            axes = ctx.split_axes(entry)
            if d < 2 or not axes:
                continue
            out[name] = shard_ctx.all_gather(
                t.movedim(d - 1, 0).contiguous(), axes, kind).movedim(0, d - 1)
            cuts[name] = (d - 1, ctx.coord(axes), t.shape[d - 1])
    return out, cuts


def _scatter_split(local, full, cuts):
    """Copy this rank's slices of the updated whole leaves back into its
    local cache rows (``_gather_split``'s ``cuts``)."""
    for name, (d, i, size) in cuts.items():
        local[name].copy_(full[name].narrow(d, i * size, size))


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

    def __init__(self, lengths, chunk_start: int, S: int, device,
                 table=None, begin=None):
        self.lengths = np.asarray(lengths, np.int64)
        self.chunk_start, self.S, self.device = chunk_start, S, device
        self.table, self.begin = table, begin
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

    def get_paged(self, ps: int):
        """Paged pools (global blocks): ``(hist_rows, hist_pos, b, s,
        dst)`` as ``get``, with rows of the flattened pool through the
        host page ``table`` [B, NP]; chunk rows below a slot's ``begin``
        (its shared-prefix match) are not written."""
        key = ("paged", ps)
        if key not in self._by_shape:
            cs, S = self.chunk_start, self.S
            tbl = np.asarray(self.table, np.int64)
            begin = (np.zeros(len(tbl), np.int64) if self.begin is None
                     else self.begin)
            hp = np.arange(cs)
            hist = tbl[:, hp // ps] * ps + hp % ps               # [B, cs]
            pos_h = cs + np.arange(S)[None, :]
            last = np.minimum(self.lengths, cs + S)[:, None]
            valid = (pos_h < last) & (
                pos_h >= np.asarray(begin, np.int64)[:, None])
            bi, si = np.nonzero(valid)
            p = pos_h[0, si]
            dst = tbl[bi, p // ps] * ps + p % ps
            self._by_shape[key] = [torch.as_tensor(a, device=self.device)
                                   for a in (hist, hp, bi, si, dst)]
        return self._by_shape[key]


def _attend_chunk(cfg, window, q, k, v, kh, vh, kp, positions, store_dtype):
    """Causal attention of a chunk over ``[history, the chunk]``; the
    chunk's own k/v round-trip through the cache dtype, so scores match
    what the per-token path reads back."""
    kc = k.to(store_dtype).to(q.dtype)
    vc = v.to(store_dtype).to(q.dtype)
    return layers.attention_full(
        q, torch.cat([kh, kc], dim=1), torch.cat([vh, vc], dim=1),
        positions, torch.cat([kp, positions], dim=1),
        causal=True, window=window, softcap=cfg.attn_softcap)


def _paged_prefill_attend(cfg, q, k, v, cache, positions, rows: PrefillRows):
    """Paged chunked prefill of a global block: history rows gathered
    through the page table, the chunk's rows from ``begin`` on scattered
    into their pages (in place) — the dense concat's shapes and values,
    so paged prefill equals dense prefill."""
    pk, pv = cache["pk"], cache["pv"]
    P, ps, KV, hd = pk.shape
    hist, hpos, b_t, s_t, dst = rows.get_paged(ps)
    pkf, pvf = pk.view(P * ps, KV, hd), pv.view(P * ps, KV, hd)
    kh = pkf[hist].to(q.dtype)
    vh = pvf[hist].to(q.dtype)
    pkf[dst] = k[b_t, s_t].to(pk.dtype)
    pvf[dst] = v[b_t, s_t].to(pv.dtype)
    B = positions.shape[0]
    kp = hpos.to(positions.dtype)[None].expand(B, len(hpos))
    return _attend_chunk(cfg, 0, q, k, v, kh, vh, kp, positions, pk.dtype)


def _prefill_attend(cfg, btype, q, k, v, cache, positions, rows: PrefillRows):
    """Chunked batched prefill of one block: scatter the chunk's valid
    K/V rows into the slot cache (in place) and attend causally over the
    already written history plus the chunk."""
    if "pk" in cache:
        return _paged_prefill_attend(cfg, q, k, v, cache, positions, rows)
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
    kp = hpos.to(positions.dtype)[None].expand(B, len(hpos))
    return _attend_chunk(cfg, window, q, k, v, kh, vh, kp, positions,
                         ck.dtype)


def _write_state(cache, new, active):
    """Write a recurrent block's new state into ``cache`` in place, only
    for slots with ``active[b]`` (None: all): inactive slots keep their
    bits.  The conv state keeps the cache's dtype (JAX's decode replaces
    the leaf with the compute dtype; the two agree when the dtypes do)."""
    for name, v in new.items():
        dst = cache[name]
        v = v.to(dst.dtype)
        if active is not None:
            keep = ~active.view((-1,) + (1,) * (v.dim() - 1))
            v = torch.where(keep, dst, v)
        dst.copy_(v)


def _keep_state(cache, new, mode, active):
    """A recurrent block's new state: ``prefill`` fills the empty dict
    ``cache`` with the final state, ``decode`` writes it in place."""
    if mode == "prefill":
        cache.update(new)
    elif new is not None:
        _write_state(cache, new, active)


def _recurrent_block_apply(cfg, params, x, *, mode, cache, active):
    """The Griffin residual block: RG-LRU temporal mixing, then the MLP."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"{mode} does not support {BLOCK_RECURRENT} "
                         f"blocks")
    h = layers.rms_norm(params["ln1"], x, cfg.norm_eps)
    y, new_cache = rglru.block_apply(params["rec"], h, mode=mode,
                                     cache=cache)
    _keep_state(cache, new_cache, mode, active)
    x = x + y
    h = layers.rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + layers.mlp_apply(params["mlp"], h, cfg.mlp_type)


def _xlstm_block_apply(cfg, btype, params, x, *, mode, cache, active):
    """An mLSTM or sLSTM block and its residual (JAX adds no outer norm);
    decode writes the new state for active slots only, prefill starts
    from a fresh state and keeps the final one."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"{mode} does not support {btype} blocks")
    state = cache if mode == "decode" else None
    if btype == BLOCK_MLSTM:
        y, new_cache = xlstm.mlstm_block_apply(params, x, mode=mode,
                                               cache=state)
    else:
        y, new_cache = xlstm.slstm_block_apply(params, x, cfg, mode=mode,
                                               cache=state)
    _keep_state(cache, new_cache, mode, active)
    return x + y


def _cross_attend(cfg, params, x, xkv):
    """The decoder's cross-attention branch (JAX ``_block_apply``): the
    ``lnx``-normed residual's queries over the encoder's k/v ``xkv``
    ([B, Se, H, hd] each), non-causal (every query at position 0, key j
    at j), added to the residual."""
    h = layers.rms_norm(params["lnx"], x, cfg.norm_eps)
    B, S, _ = h.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    xq = (h @ params["xattn"]["wq"].to(h.dtype)).reshape(B, S, H, hd)
    xk, xv = xkv
    # a cache of another dtype than the compute dtype: JAX's einsum
    # promotes
    dt = torch.promote_types(xq.dtype, xk.dtype)
    Se = xk.shape[1]
    kp = torch.arange(Se, dtype=torch.int32, device=x.device)[None]
    qp = torch.zeros(1, S, dtype=torch.int32, device=x.device)
    o = layers.attention_full(xq.to(dt), xk.to(dt), xv.to(dt), qp.expand(
        B, S), kp.expand(B, Se), causal=False)
    wo = params["xattn"]["wo"].to(x.dtype).to(o.dtype)
    return x + o.reshape(B, S, H * hd) @ wo


def _prefill_rows(cfg, btype, k, v):
    """The cache ``forward(mode="prefill")`` returns for one attention
    block: its last ``C`` rows (``C`` = the window of a local block), a
    local block's in the ring layout slot(p) = p % C that decode writes."""
    S = k.shape[1]
    C = _attn_cache_len(cfg, btype, S)
    if btype == BLOCK_LOCAL_ATTN and C < S:
        slots = torch.arange(S - C, S, device=k.device) % C
        ck, cv = k.new_zeros(k[:, :C].shape), v.new_zeros(v[:, :C].shape)
        ck[:, slots], cv[:, slots] = k[:, -C:], v[:, -C:]
        return {"k": ck, "v": cv}
    return {"k": k[:, -C:], "v": v[:, -C:]}


def _block_apply(cfg, btype, params, x, *, positions, mode, cache=None,
                 pos=None, attn_impl="full", active=None, page_table=None,
                 xkv=None, spec=None):
    """One block: ``(x, aux)``, ``aux`` the MoE router's aux loss (None
    for other blocks).  ``mode``: ``train`` (full sequence, no cache),
    ``prefill`` (``train``'s attention, the block's K/V rows written into
    the empty dict ``cache``), ``decode`` (one token, ``pos`` [B] write
    index; paged pools go through ``page_table`` [B, NP] on the device)
    or ``prefill_slots`` (``pos`` = the chunk's ``PrefillRows``;
    attention blocks only).  ``xkv``: an encoder-decoder row's cross k/v,
    attended after self-attention.  ``spec``: the decode cache's spec of
    this block's K leaf under a sharded decode (see ``_decode_attend``)."""
    if btype == BLOCK_RECURRENT:
        return _recurrent_block_apply(cfg, params, x, mode=mode,
                                      cache=cache, active=active), None
    if btype in XLSTM_BLOCKS:
        return _xlstm_block_apply(cfg, btype, params, x, mode=mode,
                                  cache=cache, active=active), None
    window = cfg.window_size if btype == BLOCK_LOCAL_ATTN else 0
    h = layers.rms_norm(params["ln1"], x, cfg.norm_eps)
    B, S, D = h.shape
    q, k, v, tp_heads, kv_idx = _qkv(cfg, params["attn"], h, mode)
    H, hd = q.shape[2], cfg.resolved_head_dim
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    if kv_idx is not None and mode != "prefill" and (
            mode != "decode" or spec is None or "pk" in cache):
        raise NotImplementedError(
            f"{mode} with K/V heads that do not divide the model axis "
            f"needs a sharded decode cache (launch.steps.build_setup)")
    if mode == "decode" and "pk" in cache:
        o = _paged_decode_attend(cfg, q, k, v, cache, pos, page_table,
                                 active, attn_impl)
    elif mode == "decode":
        o = _decode_attend(cfg, btype, q, k, v, cache, pos, active,
                           attn_impl, spec=spec)
    elif mode == "prefill_slots":
        o = _prefill_attend(cfg, btype, q, k, v, cache, positions, pos)
    elif mode in ("train", "prefill"):
        # JAX's branch: chunked attention only past 2048 tokens
        attend = (layers.attention_chunked
                  if attn_impl == "chunked" and S > 2048
                  else layers.attention_full)
        ka, va = (k, v) if kv_idx is None else (k.index_select(2, kv_idx),
                                                v.index_select(2, kv_idx))
        o = attend(q, ka, va, positions, positions, causal=True,
                   window=window, softcap=cfg.attn_softcap)
        if mode == "prefill":
            cache.update(_prefill_rows(cfg, btype, k, v))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    y = o.reshape(B, S, H * hd) @ params["attn"]["wo"].to(x.dtype)
    if tp_heads:
        y = shard_ctx.constrain(y, "residual")    # row-parallel wo: g
    x = x + y
    if xkv is not None and "xattn" in params:
        x = _cross_attend(cfg, params, x, xkv)
    h = layers.rms_norm(params["ln2"], x, cfg.norm_eps)
    if "moe" in params:
        # the aux loss only where a loss is taken: serving drops it
        y, aux = moe_apply_maybe_sharded(params["moe"], h, cfg,
                                         with_aux=mode == "train")
        return x + y, aux
    if cfg.d_ff:
        mlp = params["mlp"]
        tp = shard_ctx.tp_split(mlp["w_down"].shape[-2], cfg.d_ff)
        if tp:
            h = shard_ctx.constrain(h, "block_in")     # f
        y = layers.mlp_apply(mlp, h, cfg.mlp_type)
        if tp:
            y = shard_ctx.constrain(y, "residual")     # g
        return x + y, None
    return x, None


def _qkv(cfg, attn, h, mode="train"):
    """The block's q [B,S,H,hd] and k / v [B,S,KV,hd] from the normed
    residual, whether the heads are split over the model axis, and the
    K/V head of each local query head (None, or an index over the K/V
    heads for the caller to take outside ``train`` mode).

    Under tensor parallelism the projections are this rank's column
    shards (the local head counts come from their widths), ``h`` passes
    Megatron's f, and the caller's ``wo`` product its g.  Where the
    query heads divide the model axis and the K/V heads do not, K/V stay
    replicated: each rank takes the K/V head of each of its query heads
    (query head i reads K/V head i // (H / KV)), and the replicated
    weights' partial gradients are summed over the model group.  In
    ``train`` mode the heads are taken here; the other modes keep every
    K/V head for the cache and get the index back."""
    B, S, _ = h.shape
    hd = cfg.resolved_head_dim
    wq, wk, wv = attn["wq"], attn["wk"], attn["wv"]
    H = wq.shape[-1] // hd
    tp = shard_ctx.tp_split(H, cfg.num_heads)
    if tp:
        h = shard_ctx.constrain(h, "block_in")
    kv_whole = tp and wk.shape[-1] // hd == cfg.num_kv_heads
    if kv_whole:
        wk = shard_ctx.tp_replicated_weight(wk)
        wv = shard_ctx.tp_replicated_weight(wv)
    q = (h @ wq.to(h.dtype)).reshape(B, S, H, hd)
    k = (h @ wk.to(h.dtype)).reshape(B, S, -1, hd)
    v = (h @ wv.to(h.dtype)).reshape(B, S, -1, hd)
    idx = None
    if kv_whole:
        group = cfg.num_heads // cfg.num_kv_heads
        first = shard_ctx.tp_rank() * H
        idx = torch.tensor([(first + i) // group for i in range(H)],
                           device=h.device)
        if mode == "train":
            k, v, idx = k.index_select(2, idx), v.index_select(2, idx), None
    return q, k, v, tp, idx


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
                 pos=None, attn_impl="full", active=None, overlay=None,
                 page_table=None, cross_kv=None):
    """Apply the stacked blocks in order: a Python loop over the ``[G]``
    rows of each stage (JAX scans them).  Returns ``(x, aux)``, the MoE
    blocks' aux losses added in layer order (an f32 zero without MoE
    blocks).  ``overlay``: optional {"s{si}/pos{j}": ov} of BlockLLM
    active and probe rows (see ``_resolve_overlay``).  ``cross_kv``: an
    encoder-decoder model's per-row cross k/v (``_cross_kv``'s layout).
    ``prefill`` mode fills ``caches`` (one empty dict per stage) with
    each position's rows stacked ``[G, ...]``.  In train mode with
    ``cfg.remat`` each block is recomputed in the backward pass
    (``torch.utils.checkpoint``, where JAX wraps the scan body in
    ``jax.checkpoint``)."""
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ctx = shard_ctx.get()
    specs = (ctx.cache_specs if mode == "decode" and ctx is not None
             else None)
    for si, (pattern, groups) in enumerate(cfg.stages()):
        sp = stage_params[si]
        filled = {f"pos{j}": [] for j in range(len(pattern))}
        for g in range(groups):
            for j, btype in enumerate(pattern):
                bp = tree_map(lambda a: a[g], sp[f"pos{j}"])
                ov = (overlay or {}).get(f"s{si}/pos{j}")
                if ov is not None:
                    bp = _resolve_overlay(bp, g, ov)
                cj, local, cuts, spec = None, None, {}, None
                if mode == "prefill":
                    cj = {}
                    filled[f"pos{j}"].append(cj)
                elif caches is not None:
                    cj = {n: a[g] for n, a in caches[si][f"pos{j}"].items()}
                if specs is not None:
                    sj = specs["stages"][si][f"pos{j}"]
                    if btype in ATTN_BLOCKS:
                        spec = sj["k"]
                    else:       # a recurrent state split on a feature dim
                        local = cj
                        cj, cuts = _gather_split(cj, sj,
                                                 "decode/state_all_gather")
                xkv = None
                if cross_kv is not None and btype in ATTN_BLOCKS:
                    xkv = {n: cross_kv[si][f"pos{j}"][n][g]
                           for n in ("k", "v")}
                    if specs is not None:
                        xkv, _ = _gather_split(
                            xkv, specs["cross_kv"][si][f"pos{j}"],
                            "decode/cross_kv_all_gather")
                    xkv = (xkv["k"], xkv["v"])
                kw = dict(positions=positions, mode=mode, cache=cj, pos=pos,
                          attn_impl=attn_impl, active=active,
                          page_table=page_table, xkv=xkv, spec=spec)
                if remat:
                    x, aux = torch.utils.checkpoint.checkpoint(
                        lambda h, bp=bp, btype=btype, kw=kw: _block_apply(
                            cfg, btype, bp, h, **kw), x,
                        use_reentrant=False)
                else:
                    x, aux = _block_apply(cfg, btype, bp, x, **kw)
                if cuts:
                    _scatter_split(local, cj, cuts)
                if aux is not None:
                    aux_total = aux_total + aux
        if mode == "prefill":
            caches[si].update({p: {n: torch.stack([c[n] for c in rows])
                                   for n in rows[0]}
                               for p, rows in filled.items()})
    return x, aux_total


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def _embed(params, cfg, tokens, *, patch_embeds=None, base_pos=0,
           pos_b=None):
    """Token embeddings in the compute dtype; ``patch_embeds`` [B, P, E]
    (a VLM) projected through ``vision_proj`` in the compute dtype and
    put in place of the first P positions, JAX's ``concatenate([proj,
    x[:, P:]])`` (a sequence shorter than P raises: JAX would lengthen
    it); with absolute positions
    (``rope_theta == 0``) plus the sinusoid of positions ``base_pos ..``
    (or, for a decode step, of each slot's ``pos_b`` [B]), computed in
    f32 and cast to the compute dtype before the add, as in JAX."""
    emb = params["embed"]
    vocab_tp = shard_ctx.tp_split(emb.shape[0], cfg.vocab_size)
    if vocab_tp:
        # vocab-parallel rows: each rank looks up the tokens it owns
        # (zeros elsewhere) and the model group sums the rows (g)
        local = tokens - shard_ctx.tp_rank() * emb.shape[0]
        own = (local >= 0) & (local < emb.shape[0])
        tokens = torch.where(own, local, torch.zeros_like(local))
    if emb.requires_grad:
        # training the table: JAX's cast-then-gather, so the gradient
        # accumulates over repeated tokens in the compute dtype as in JAX;
        # F.embedding's backward is deterministic, where the CPU backward
        # of advanced indexing accumulates in parallel in no fixed order
        x = F.embedding(tokens, emb.to(_cdtype(cfg)))
    else:
        # gather, then cast: the same values without casting the whole
        # table
        x = emb[tokens].to(_cdtype(cfg))
    if vocab_tp:
        x = shard_ctx.constrain(x * own[..., None].to(x.dtype), "residual")
    if patch_embeds is not None:
        P, S = patch_embeds.shape[1], x.shape[1]
        if S < P:
            raise ValueError(f"{cfg.name}: {P} patch embeddings do not fit "
                             f"in {S} positions")
        proj = patch_embeds.to(x.dtype) @ params["vision_proj"].to(x.dtype)
        x = torch.cat([proj, x[:, P:]], dim=1)
    if not cfg.rope_theta:
        if pos_b is None:
            S = x.shape[1]
            pe = layers.sinusoidal_positions(S + base_pos, cfg.d_model,
                                             x.dtype, x.device)[base_pos:]
        else:
            pe = layers.sinusoid(pos_b.float(), cfg.d_model)[:, None]
        x = x + pe.to(x.dtype)
    return x


def _vocab_tp(params, cfg) -> bool:
    """True iff the output vocab is split over the model axis here."""
    w = params["embed"] if cfg.tie_embeddings else params["head"].T
    return shard_ctx.tp_split(w.shape[0], cfg.vocab_size)


def _unembed(params, cfg, x):
    """Logits in x's dtype; under vocab parallelism this rank's columns
    (x passes Megatron's f first)."""
    if _vocab_tp(params, cfg):
        x = shard_ctx.constrain(x, "block_in")
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["head"].to(x.dtype)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# encoder (whisper)
# ---------------------------------------------------------------------------


def _encoder_block(cfg, bp, h, positions):
    """One encoder block: non-causal MHA through ``attention_full``, then
    the MLP, each on its pre-norm residual."""
    hn = layers.rms_norm(bp["ln1"], h, cfg.norm_eps)
    B, S, _ = hn.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    a = bp["attn"]
    q, k, v = ((hn @ a[w].to(hn.dtype)).reshape(B, S, H, hd)
               for w in ("wq", "wk", "wv"))
    o = layers.attention_full(q, k, v, positions, positions, causal=False)
    h = h + o.reshape(B, S, H * hd) @ a["wo"].to(h.dtype)
    hn = layers.rms_norm(bp["ln2"], h, cfg.norm_eps)
    return h + layers.mlp_apply(bp["mlp"], hn, cfg.mlp_type)


def _encode(params, cfg, frames):
    """The encoder's output [B, Se, D]: ``frames @ frontend`` in the
    compute dtype, plus the sinusoid, through the encoder's blocks (each
    recomputed in the backward pass with ``cfg.remat``, as JAX wraps the
    body in ``jax.checkpoint``), then its ``final_norm``."""
    enc = params["encoder"]
    cd = _cdtype(cfg)
    x = frames.to(cd) @ enc["frontend"].to(cd)
    B, S, _ = x.shape
    x = x + layers.sinusoidal_positions(S, cfg.d_model, x.dtype, x.device)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    for si, (_, groups) in enumerate(_encoder_cfg(cfg).stages()):
        sp = enc["stages"][si]["pos0"]
        for g in range(groups):
            bp = tree_map(lambda a: a[g], sp)
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    lambda h, bp=bp: _encoder_block(cfg, bp, h, positions),
                    x, use_reentrant=False)
            else:
                x = _encoder_block(cfg, bp, x, positions)
    return layers.rms_norm(enc["final_norm"], x, cfg.norm_eps)


def _cross_kv(params, cfg, enc_out):
    """Each decoder row's cross k/v from the encoder output: per stage
    and position ``{"k", "v"}`` of ``[G, B, Se, H, hd]`` (JAX's einsum
    ``bsd,gde->gbse`` as one matmul per row).  Reads ``params["stages"]``
    itself, never an overlay, as JAX does."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    B, Se, _ = enc_out.shape
    out = []
    for si, (pattern, groups) in enumerate(cfg.stages()):
        st = {}
        for j in range(len(pattern)):
            xa = params["stages"][si][f"pos{j}"]["xattn"]
            st[f"pos{j}"] = {n: torch.stack(
                [enc_out @ xa[w][g].to(enc_out.dtype) for g in range(groups)]
            ).reshape(groups, B, Se, H, hd)
                for n, w in (("k", "wk"), ("v", "wv"))}
        out.append(st)
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


TRAIN_ATTN_IMPLS = ("full", "chunked")


def _hidden(params, cfg, tokens, *, attn_impl, overlay=None, frames=None,
            patch_embeds=None, mode="train", caches=None):
    """Final-norm hidden states [B, S, D] of a full-sequence pass, the
    MoE aux loss, and an encoder-decoder model's cross k/v (else None).
    ``frames`` [B, Se, F]: the encoder's input, required by (and only
    by) an encoder-decoder model.  ``patch_embeds`` [B, P, E]: a VLM's
    stub patch embeddings (see ``_embed``)."""
    check_supported(cfg)
    check_tensor_parallel(cfg)
    if attn_impl not in TRAIN_ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}: full-sequence attention "
                         f"is one of {TRAIN_ATTN_IMPLS}")
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    x = _embed(params, cfg, tokens, patch_embeds=patch_embeds)
    cross_kv = None
    if cfg.is_encoder_decoder:
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                             f"the encoder's frames")
        cross_kv = _cross_kv(params, cfg, _encode(params, cfg, frames))
    x, aux = _stack_apply(cfg, params["stages"], x, positions=positions,
                          mode=mode, overlay=overlay, attn_impl=attn_impl,
                          caches=caches, cross_kv=cross_kv)
    return layers.rms_norm(params["final_norm"], x, cfg.norm_eps), aux, \
        cross_kv


def forward(params, cfg: ModelConfig, tokens, *, frames=None,
            patch_embeds=None, mode="train", overlay=None,
            attn_impl="chunked"):
    """Full-sequence teacher-forced logits [B, S, vocab].  ``attn_impl``
    ``chunked`` (the default, as JAX's ``forward``) runs
    ``layers.attention_chunked`` past 2048 tokens, ``full`` always
    ``attention_full``.  ``frames``: an encoder-decoder model's encoder
    input [B, Se, F]; ``patch_embeds``: a VLM's [B, P, E].
    ``mode="prefill"`` returns ``(logits, cache)``, the cache holding
    each attention block's K/V rows ([G, B, C, KV, hd] in the compute
    dtype, C the sequence or a local block's window), each recurrent
    block's final state (``init_cache``'s leaves, the RG-LRU conv state
    in the compute dtype) and, for an encoder-decoder model,
    ``cross_kv``."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward mode is train or prefill, got {mode!r}")
    caches = [{} for _ in cfg.stages()] if mode == "prefill" else None
    hidden, _, cross_kv = _hidden(params, cfg, tokens, overlay=overlay,
                                  attn_impl=attn_impl, frames=frames,
                                  patch_embeds=patch_embeds, mode=mode,
                                  caches=caches)
    logits = _unembed(params, cfg, hidden)
    if mode == "train":
        return logits
    cache = {"stages": caches}
    if cross_kv is not None:
        cache["cross_kv"] = cross_kv
    return logits, cache


def prefill(params, cfg: ModelConfig, batch, *, attn_impl="chunked"):
    """Whole-sequence prefill: ``(logits [B, vocab] at the last position,
    cache)`` (JAX's ``prefill``; the route to a filled ``cross_kv`` and,
    for a VLM, to decoding after the patches).  ``batch``: ``tokens`` and
    the optional ``frames`` / ``patch_embeds``.  Only the last position
    is unembedded (JAX unembeds every position and keeps the last): a
    [B, S, vocab] logits tensor is never made."""
    caches = [{} for _ in cfg.stages()]
    hidden, _, cross_kv = _hidden(params, cfg, batch["tokens"],
                                  attn_impl=attn_impl,
                                  frames=batch.get("frames"),
                                  patch_embeds=batch.get("patch_embeds"),
                                  mode="prefill", caches=caches)
    cache = {"stages": caches}
    if cross_kv is not None:
        cache["cross_kv"] = cross_kv
    return _unembed(params, cfg, hidden[:, -1:])[:, 0], cache


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


def _xent_from_logits(logits, labels, mask, vocab_tp=False):
    """Summed masked cross entropy.  ``vocab_tp``: ``logits`` are this
    rank's vocab columns; the max and the sum of exponentials are reduced
    over the model group and the target logit comes from its owner."""
    logits = logits.float()
    if not vocab_tp:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
        return ((logz - gold) * mask).sum()
    Vl = logits.shape[-1]
    m = shard_ctx.tp_max(logits.detach().amax(dim=-1))
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    logz = m + torch.log(shard_ctx.constrain(se, "residual"))
    local = labels.long() - shard_ctx.tp_rank() * Vl
    own = (local >= 0) & (local < Vl)
    gold = logits.gather(-1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = shard_ctx.constrain(torch.where(own, gold, torch.zeros_like(gold)),
                               "residual")
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

    vocab_tp = _vocab_tp(params, cfg)

    def piece(xc, lc, mc):
        return _xent_from_logits(_unembed(params, cfg, xc), lc, mc,
                                 vocab_tp)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, S, chunk):
        args = (hidden[:, s:s + chunk], labels[:, s:s + chunk],
                mask[:, s:s + chunk])
        total = total + (torch.utils.checkpoint.checkpoint(
            piece, *args, use_reentrant=False)
            if torch.is_grad_enabled() else piece(*args))
    return total


def loss_fn(params, cfg: ModelConfig, batch, *, attn_impl="chunked",
            loss_chunk=None, overlay=None):
    """Next-token cross entropy plus the MoE aux loss (zero for other
    families).  Returns ``(loss, metrics)``.  An encoder-decoder model
    reads its encoder input from ``batch["frames"]``, a VLM its patch
    embeddings from ``batch["patch_embeds"]`` (whose positions keep their
    labels, as JAX's ``_labels_mask`` keeps them).

    ``loss_chunk``: None => auto (chunked when S * V > 2**27, as JAX);
    0 => direct.  ``attn_impl``: ``full`` or ``chunked`` (blockwise
    attention past 2048 tokens), as ``forward``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    labels, mask = _labels_mask(batch)
    if loss_chunk is None:
        loss_chunk = 512 if S * cfg.vocab_size > (1 << 27) else 0
    hidden, aux, _ = _hidden(params, cfg, tokens, overlay=overlay,
                             attn_impl=attn_impl, frames=batch.get("frames"),
                             patch_embeds=batch.get("patch_embeds"))
    if loss_chunk:
        nll_sum = _chunked_xent(params, cfg, hidden, labels, mask,
                                loss_chunk)
    else:
        nll_sum = _xent_from_logits(_unembed(params, cfg, hidden), labels,
                                    mask, _vocab_tp(params, cfg))
    tokens = mask.sum()
    ctx = shard_ctx.get()
    if ctx is not None:
        # data parallel: the global token count over the data ranks, so
        # the ranks' mean loss is the global batch's (equal shards give
        # each rank's own mean)
        tokens = shard_ctx.data_sum(tokens)
        denom = torch.clamp(tokens, min=1.0) / ctx.dp_size
    else:
        denom = torch.clamp(tokens, min=1.0)
    nll = nll_sum / denom
    loss = nll + aux
    return loss, {"nll": nll, "aux": aux, "tokens": tokens}


def prefill_into_slots(params, cfg: ModelConfig, cache, tokens, lengths, *,
                       chunk_start=0, attn_impl="full", page_table=None,
                       begin=None):
    """Chunked batched prefill into a slot-batched decode cache.

    ``tokens`` [B, K] (device): positions ``[chunk_start, chunk_start +
    K)`` of each slot's prompt, right-padded; ``lengths`` [B] (host
    array): each slot's full prompt length (0 for slots not being
    primed — their cache rows are not touched).  Writes the chunk's K/V
    rows into ``cache`` in place and returns ``(logits [B, vocab] at
    each slot's last valid position of this chunk, cache)``.

    Paged caches (``init_paged_cache``) take the host ``page_table``
    [B, NP] and ``begin`` [B], each slot's first self-computed position
    (rows below it live in shared prefix pages and are not written).
    """
    B, K = tokens.shape
    dev = tokens.device
    lengths = np.asarray(lengths, np.int64)
    positions = (chunk_start + torch.arange(K, dtype=torch.int32,
                                            device=dev))[None].expand(B, K)
    rows = PrefillRows(lengths, chunk_start, K, dev,
                       table=None if page_table is None
                       else _host(page_table),
                       begin=None if begin is None else _host(begin))
    x = _embed(params, cfg, tokens, base_pos=chunk_start)
    x, _ = _stack_apply(cfg, params["stages"], x, positions=positions,
                        mode="prefill_slots", caches=cache["stages"],
                        pos=rows, attn_impl=attn_impl)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    # unembed only each slot's last valid row of this chunk, through the
    # same [B, 1, D] matmul shape the decode path uses
    li = np.clip(np.minimum(lengths, chunk_start + K) - 1 - chunk_start,
                 0, K - 1)
    xg = x[torch.arange(B, device=dev), torch.as_tensor(li, device=dev)]
    return _unembed(params, cfg, xg[:, None])[:, 0], cache


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def verify_into_slots(params, cfg: ModelConfig, cache, tokens, starts,
                      active, *, page_table=None, attn_impl="full"):
    """Score K candidate positions per slot: the verifier half of
    self-speculative serving.

    ``tokens`` [B, K] (device): position ``starts[b] + j`` holds
    ``tokens[b, j]``, each slot's last emitted token followed by the
    K - 1 draft tokens; ``starts`` [B] (host) is each slot's next write
    index; ``active`` [B] (host bool) selects the slots that write.
    Paged caches take the host ``page_table`` [B, NP] (the pages of rows
    ``starts .. starts + K`` already writable).  Writes the chunk's K/V
    rows under the current params, in place, over the draft rows, and
    returns ``(logits [B, K, vocab], cache)`` where ``logits[b, j]``
    scores the token after ``tokens[b, j]``.

    The K positions run through the decode step itself (``attn_impl``
    attention; inactive slots stay at ``starts`` and write nothing), so
    logits and rows are bitwise those of plain decoding, which the
    server's stream guarantee needs.  The JAX package scores the chunk
    in one pass, which there equals per-token decoding bit for bit; in
    PyTorch a [B, K, D] pass rounds differently from [B, 1, D] steps,
    so the one-pass verify is not ported (ROADMAP C) and a round costs
    K decode passes."""
    if any(t in RECURRENT_BLOCKS for t in cfg.layer_types()):
        raise ValueError("verify does not support recurrent blocks: their "
                         "state cannot roll back (see supports_spec_decode)")
    dev = tokens.device
    st = _host(starts).astype(np.int64)
    act = _host(active).astype(bool)
    act_t = torch.as_tensor(act, device=dev)
    tbl = (None if page_table is None else torch.as_tensor(
        _host(page_table), dtype=torch.int32, device=dev))
    out = []
    for j in range(tokens.shape[1]):
        pos = np.where(act, st + j, st).astype(np.int32)
        lg, _ = decode_step(params, cfg, cache, tokens[:, j:j + 1], pos,
                            attn_impl=attn_impl, active=act_t,
                            page_table=tbl)
        out.append(lg)
    return torch.stack(out, dim=1), cache


def decode_step(params, cfg: ModelConfig, cache, token, pos, *,
                attn_impl="full", active=None, page_table=None):
    """One decode step.  token [B, 1]; pos [B] int32 per-slot write
    index; ``active`` [B] bool (None = all slots) masks the in-place
    cache writes.  An encoder-decoder model attends to the cache's
    ``cross_kv``.  Paged caches take ``page_table`` [B, NP] int32, copied
    to the device here once for every layer.  Returns ``(logits [B,
    vocab], cache)``."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {attn_impl!r}")
    B = token.shape[0]
    dev = token.device
    pos_b = torch.as_tensor(pos, dtype=torch.int32,
                            device=dev).reshape(-1).expand(B)
    if active is not None:
        active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    if page_table is not None:
        page_table = torch.as_tensor(page_table, dtype=torch.int32,
                                     device=dev)
    x = _embed(params, cfg, token, pos_b=pos_b)
    x, _ = _stack_apply(cfg, params["stages"], x, positions=pos_b[:, None],
                        mode="decode", caches=cache["stages"], pos=pos_b,
                        attn_impl=attn_impl, active=active,
                        page_table=page_table,
                        cross_kv=cache.get("cross_kv"))
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x)[:, 0], cache
