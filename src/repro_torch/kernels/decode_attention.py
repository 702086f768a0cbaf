"""Decode attention: one query token per slot against its KV rows.

The serving hot path calls this once per decode step per layer: q is a
single token per slot ([B, 1, H, hd]), k/v are the slot-batched cache
([B, C, KV, hd]) and ``pos`` [B] is the per-slot index of the token just
written.  Counterpart of ``repro.kernels.decode_attention``:

- ``decode_attention_cuda`` launches the hand-written Hopper kernel
  (``csrc/decode_attention.cu``), whose reads scale with each slot's
  context: it walks only the k-blocks ``block_bounds`` gives;
- ``decode_attention_plain`` is the same function in plain PyTorch and
  the same arithmetic (f32 online softmax over ``block_k`` blocks with
  the ``-1e30`` guards), used for CPU tensors and as the kernel's
  reference on the card;
- ``block_bounds``, ``cache_read_bytes`` and ``paged_cache_read_bytes``
  are the host-side traffic model, equal to the JAX package's.

Paged KV (``runtime/paged_kv.py``): the fused write+attend step over
page pools ``[P, ps, KV, hd]`` addressed through a page table
``[B, NP]``.  ``paged_decode_attention_cuda`` launches
``csrc/paged_decode_attention.cu`` (the dense kernel's body with the
row-to-address map of the table); ``paged_decode_attention_plain``
takes the same steps in plain PyTorch: write each active slot's new row
into its page, gather the dense view through the table, then
``decode_attention_plain``.  Both update the pools in place and return
``(o, k_pool, v_pool)``.  The k-block (``block_k`` rows) does not
depend on the page size, so with equal ``block_k`` paged and dense give
the same bits.

Dispatch (kernel on CUDA tensors, plain on CPU tensors) lives in
``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.models.layers import decode_valid

_KERNEL_HEAD_DIMS = (32, 64, 128, 256)
_KERNEL_GROUPS = (1, 2, 4, 8)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def block_bounds(pos, *, seq_len, window=0, ring=False, block_k=128):
    """Per-slot [lo, hi] k-block range a decode step must read."""
    pos = torch.as_tensor(pos, dtype=torch.int32)
    bk = min(block_k, seq_len)
    hi = torch.div(pos.clamp(max=seq_len - 1), bk, rounding_mode="floor")
    if window and not ring:
        lo = torch.div((pos - window + 1).clamp(min=0), bk,
                       rounding_mode="floor")
    else:
        # ring: early steps only fill slots [0, pos]; after the wrap the
        # whole C = min(window, max_seq) buffer is the window
        lo = torch.zeros_like(hi)
    return lo, hi


def cache_read_bytes(pos, *, seq_len, kv_heads, head_dim, window=0,
                     ring=False, block_k=128, dtype_bytes=2):
    """K+V bytes one fused decode step reads at ``pos`` (every slot)."""
    lo, hi = block_bounds(pos, seq_len=seq_len, window=window, ring=ring,
                          block_k=block_k)
    bk = min(block_k, seq_len)
    per_block = 2 * bk * kv_heads * head_dim * dtype_bytes   # k + v tiles
    return int(torch.sum(hi - lo + 1)) * per_block


def paged_cache_read_bytes(pos, *, num_pages_per_slot, page_size, kv_heads,
                           head_dim, window=0, dtype_bytes=2):
    """K+V bytes one fused paged decode step moves at ``pos``, as the JAX
    package counts them: page reads (the ``[lo, hi]`` sweep with
    ``block_k = page_size``) plus one page written back per slot."""
    reads = cache_read_bytes(pos, seq_len=num_pages_per_slot * page_size,
                             kv_heads=kv_heads, head_dim=head_dim,
                             window=window, ring=False, block_k=page_size,
                             dtype_bytes=dtype_bytes)
    n = int(torch.as_tensor(pos).reshape(-1).shape[0])
    writes = n * 2 * page_size * kv_heads * head_dim * dtype_bytes
    return reads + writes


def _pos_vector(pos, B, device):
    return torch.as_tensor(pos, dtype=torch.int32,
                           device=device).reshape(-1).expand(B)


def decode_attention_plain(q, k_cache, v_cache, pos, *, window=0, ring=False,
                           softcap=0.0, scale=None, block_k=128):
    """Plain PyTorch version of the kernel: the same blockwise f32 online
    softmax, block by block over ``block_k`` rows, each slot restricted
    to its ``block_bounds`` range.  Returns o [B, 1, H, hd] in q's dtype."""
    B, C, KV, hd = k_cache.shape
    H = q.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    bk = min(block_k, C)
    pos_b = _pos_vector(pos, B, q.device)
    lo, hi = block_bounds(pos_b, seq_len=C, window=window, ring=ring,
                          block_k=bk)
    qg = q.reshape(B, KV, G, hd).float()
    m = torch.full((B, KV, G), -math.inf, device=q.device)
    den = torch.zeros((B, KV, G), device=q.device)
    acc = torch.zeros((B, KV, G, hd), device=q.device)
    valid = decode_valid(pos_b, C, window=window, ring=ring)      # [B, C]
    for j in range((C + bk - 1) // bk):
        rows = slice(j * bk, min((j + 1) * bk, C))
        kb = k_cache[:, rows].float()                             # [B,bk,KV,hd]
        vb = v_cache[:, rows].float()
        s = torch.einsum("bhgd,bkhd->bhgk", qg, kb) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        ok = valid[:, rows] & ((lo <= j) & (j <= hi))[:, None]
        s = torch.where(ok[:, None, None, :], s,
                        torch.full_like(s, -math.inf))
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = m_new.clamp(min=-1e30)            # fully-masked guard
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(m.clamp(min=-1e30) - m_safe)
        den = den * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vb)
        m = m_new
    o = acc / den.clamp(min=1e-30)[..., None]
    return o.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_cuda(q, k_cache, v_cache, pos, *, window=0, ring=False,
                          softcap=0.0, scale=None, block_k=128):
    """Launch the Hopper kernel (``csrc/decode_attention.cu``).  Raises on
    anything it does not take; allocates the output and the kernel's f32
    workspace of per-k-block partials."""
    if not (q.is_cuda and k_cache.is_cuda and v_cache.is_cuda):
        raise ValueError("decode_attention_cuda needs CUDA tensors")
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4:
        raise ValueError(f"q must be [B, 1, H, hd] and the caches "
                         f"[B, C, KV, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    B, C, KV, hd = k_cache.shape
    H = q.shape[2]
    if (v_cache.shape != k_cache.shape or q.shape[0] != B
            or q.shape[3] != hd or H % KV):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    G = H // KV
    if hd not in _KERNEL_HEAD_DIMS or G not in _KERNEL_GROUPS:
        raise ValueError(f"kernel takes head_dim in {_KERNEL_HEAD_DIMS} and "
                         f"query heads per kv head in {_KERNEL_GROUPS}; got "
                         f"head_dim {hd}, group {G}")
    if (q.dtype not in _KERNEL_DTYPES or k_cache.dtype not in _KERNEL_DTYPES
            or v_cache.dtype != k_cache.dtype):
        raise ValueError(f"kernel takes f32/bf16 q and one f32/bf16 cache "
                         f"dtype; got {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    for t in (q, k_cache, v_cache):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel takes contiguous, 16-byte aligned "
                             "tensors")
    if B > 65535 or KV > 65535 or -(-C // max(1, min(block_k, C))) > 65535 \
            or block_k < 1:
        raise ValueError("grid or block_k out of range")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    pos_b = _pos_vector(pos, B, q.device).contiguous()
    o = torch.empty_like(q)
    # per (slot, kv head, k-block): G maxima, G denominators, G x hd sums
    nk = -(-C // min(block_k, C))
    ws = torch.empty(B * KV * nk * G * (hd + 2), dtype=torch.float32,
                     device=q.device)
    lib = build.library("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos_b.data_ptr(), o.data_ptr(), ws.data_ptr(), B, C, KV, G, hd,
        int(q.dtype == torch.bfloat16), int(k_cache.dtype == torch.bfloat16),
        int(window), int(bool(ring)), ctypes.c_float(softcap),
        ctypes.c_float(scale), int(block_k), ctypes.c_void_p(stream))
    build.check("decode_attention", rc)
    build.LAUNCHES["decode_attention"] += 1
    return o


# --------------------------------------------------------------------- #
# paged KV: fused write + attend
# --------------------------------------------------------------------- #


def paged_write_gather(new_k, new_v, k_pool, v_pool, pos, page_table,
                       active):
    """Write each active slot's new K/V row (cast to the pool dtype) into
    its page, in place, and gather every slot's dense view ``[B, NP * ps,
    KV, hd]`` through the page table (unmapped entries read the null
    page; the decode masks never let those rows through).

    Inactive slots rewrite their row with its own old value, so no host
    sync picks the active rows out; their rows never collide with an
    active slot's, whose write page no other entry maps (copy-on-write)."""
    P, ps, KV, hd = k_pool.shape
    B, NP = page_table.shape
    tbl = page_table.long()
    pos_l = pos.long()
    keep = ~active.bool()[:, None, None]
    kf = k_pool.view(P * ps, KV, hd)
    vf = v_pool.view(P * ps, KV, hd)
    phys = tbl.gather(1, (pos_l // ps)[:, None])[:, 0]
    widx = phys * ps + pos_l % ps
    kf[widx] = torch.where(keep, kf[widx], new_k.to(k_pool.dtype))
    vf[widx] = torch.where(keep, vf[widx], new_v.to(v_pool.dtype))
    ridx = (tbl[:, :, None] * ps + torch.arange(ps, device=tbl.device)
            ).reshape(B, NP * ps)
    return kf[ridx], vf[ridx]


def _check_private_write_pages(page_table, pos, active, ps):
    """The allocator's copy-on-write invariant, checked where it is free
    (host tensors): every active slot writes a mapped page that no other
    page-table entry maps."""
    tbl = page_table.numpy().astype(np.int64)
    act = active.numpy().astype(bool)
    w = tbl[np.arange(tbl.shape[0]), pos.numpy().astype(np.int64) // ps][act]
    counts = np.bincount(tbl.ravel(), minlength=int(tbl.max()) + 1)
    if (w == 0).any() or (counts[w] > 1).any():
        raise RuntimeError(
            f"paged decode: an active slot writes the null page or a page "
            f"mapped more than once (write pages {w.tolist()}): the "
            f"copy-on-write split was not applied")


def paged_decode_attention_plain(q, new_k, new_v, k_pool, v_pool, pos,
                                 page_table, active, *, window=0,
                                 softcap=0.0, scale=None, block_k=128):
    """Plain PyTorch version of the fused paged kernel, the same steps:
    the row write, the gather through the table, then the blockwise
    online softmax of ``decode_attention_plain``.  Pools are updated in
    place; returns ``(o, k_pool, v_pool)``."""
    B = page_table.shape[0]
    pos_b = _pos_vector(pos, B, q.device)
    if not k_pool.is_cuda:
        _check_private_write_pages(page_table, pos_b, active,
                                   k_pool.shape[1])
    ck, cv = paged_write_gather(new_k, new_v, k_pool, v_pool, pos_b,
                                page_table, active)
    o = decode_attention_plain(q, ck, cv, pos_b, window=window,
                               softcap=softcap, scale=scale, block_k=block_k)
    return o, k_pool, v_pool


def paged_decode_attention_cuda(q, new_k, new_v, k_pool, v_pool, pos,
                                page_table, active, *, window=0, softcap=0.0,
                                scale=None, block_k=128):
    """Launch the fused paged kernel (``csrc/paged_decode_attention.cu``).
    Raises on anything it does not take; the pools, ``pos``, the page
    table and ``active`` must already be on the card (nothing is copied
    from the host here).  Updates the pools in place; returns ``(o,
    k_pool, v_pool)``."""
    ts = (q, new_k, new_v, k_pool, v_pool, pos, page_table, active)
    if not all(torch.is_tensor(t) and t.is_cuda for t in ts):
        raise ValueError("paged_decode_attention_cuda needs CUDA tensors "
                         "(q, new rows, pools, pos, page table, active)")
    if q.dim() != 4 or q.shape[1] != 1 or k_pool.dim() != 4 \
            or page_table.dim() != 2:
        raise ValueError(f"q must be [B, 1, H, hd], the pools [P, ps, KV, "
                         f"hd], the page table [B, NP]; got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(page_table.shape)}")
    P, ps, KV, hd = k_pool.shape
    B, NP = page_table.shape
    H = q.shape[2]
    if (v_pool.shape != k_pool.shape or q.shape[0] != B or q.shape[3] != hd
            or H % KV or tuple(new_k.shape) != (B, KV, hd)
            or new_v.shape != new_k.shape or pos.numel() not in (1, B)
            or active.shape != (B,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, new_k "
                         f"{tuple(new_k.shape)}, pools {tuple(k_pool.shape)}"
                         f", table {tuple(page_table.shape)}, active "
                         f"{tuple(active.shape)}")
    G = H // KV
    if hd not in _KERNEL_HEAD_DIMS or G not in _KERNEL_GROUPS:
        raise ValueError(f"kernel takes head_dim in {_KERNEL_HEAD_DIMS} and "
                         f"query heads per kv head in {_KERNEL_GROUPS}; got "
                         f"head_dim {hd}, group {G}")
    if (q.dtype not in _KERNEL_DTYPES or k_pool.dtype not in _KERNEL_DTYPES
            or v_pool.dtype != k_pool.dtype):
        raise ValueError(f"kernel takes f32/bf16 q and one f32/bf16 pool "
                         f"dtype; got {q.dtype}, {k_pool.dtype}, "
                         f"{v_pool.dtype}")
    if page_table.dtype != torch.int32 or active.dtype != torch.bool:
        raise ValueError(f"page table must be int32 and active bool; got "
                         f"{page_table.dtype}, {active.dtype}")
    nk = new_k.to(k_pool.dtype).contiguous()
    nv = new_v.to(v_pool.dtype).contiguous()
    for t in (q, nk, nv, k_pool, v_pool):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel takes contiguous, 16-byte aligned "
                             "tensors")
    C = NP * ps
    if B > 65535 or KV > 65535 or block_k < 1 \
            or -(-C // min(block_k, C)) > 65535:
        raise ValueError("grid or block_k out of range")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    pos_b = _pos_vector(pos, B, q.device).contiguous()
    tbl = page_table.contiguous()
    act = active.contiguous()
    o = torch.empty_like(q)
    nkb = -(-C // min(block_k, C))
    ws = torch.empty(B * KV * nkb * G * (hd + 2), dtype=torch.float32,
                     device=q.device)
    lib = build.library("paged_decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_decode_attention_launch(
        q.data_ptr(), nk.data_ptr(), nv.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), pos_b.data_ptr(), tbl.data_ptr(), act.data_ptr(),
        o.data_ptr(), ws.data_ptr(), B, NP, ps, KV, G, hd,
        int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
        int(window), ctypes.c_float(softcap), ctypes.c_float(scale),
        int(block_k), ctypes.c_void_p(stream))
    build.check("paged_decode_attention", rc)
    build.LAUNCHES["paged_decode_attention"] += 1
    return o, k_pool, v_pool
