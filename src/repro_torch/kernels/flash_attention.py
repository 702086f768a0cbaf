"""Flash attention forward (counterpart of ``repro.kernels.flash_attention``).

Blockwise online-softmax attention, causal and sliding-window masks, GQA:
q ``[B, Sq, H, hd]``, k/v ``[B, Sk, KV, hd]`` (bf16 or f32, one dtype)
-> o ``[B, Sq, H, hd]`` in q's dtype.  Query head h reads kv head
``h // (H / KV)``.  Positions are the row indices: row ``qp`` sees key
``kp < Sk`` when ``qp >= kp`` (causal) and ``qp - kp < window``
(window > 0).

- ``flash_attention_cuda`` launches the Hopper kernel
  (``csrc/flash_attention.cu``): one thread block per (b, h, q-tile).
  bf16 inputs run on the tensor cores: Q·Kᵀ in bf16 ``mma`` (products
  exact in f32), and P·V with p split exactly into three bf16 pieces
  (``split_bf16x3``), so p keeps its f32 value as in the TPU kernel
  (which casts q, k and v to f32).  f32 inputs run both products as f32
  FMAs on the CUDA cores;
- ``split_bf16x3`` is the split the bf16 kernel does in registers;
- ``flash_attention_plain`` is the same function in plain PyTorch, the
  counterpart of ``repro.kernels.ref.flash_attention_ref``: f32 full
  attention, fully-masked rows zeroed.  The CPU tests use it, and on the
  card it is the kernel's reference;
- ``flash_bytes`` and ``flash_flops`` give the bound of one call.

The differentiable op (kernel forward, backward through
``layers.attention_chunked``) lives in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128, 256)


def visible_pairs(Sq: int, Sk: int, *, causal=True, window=0) -> int:
    """(query, key) pairs the mask lets through, per (batch, head)."""
    qp = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qp + 1, Sk) if causal else np.full(Sq, Sk, np.int64)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_flops(B, Sq, Sk, H, hd, *, causal=True, window=0) -> int:
    """Operations of one call: Q·Kᵀ and P·V, 2 flops per multiply-add,
    over the visible pairs only."""
    return 4 * B * H * hd * visible_pairs(Sq, Sk, causal=causal,
                                          window=window)


def flash_bytes(q, k, v) -> int:
    """Bytes one call must move: q, k and v read once, o written once."""
    return 2 * q.nbytes + k.nbytes + v.nbytes


def split_bf16x3(p):
    """The bf16 kernel's split of f32 p into three bf16 pieces:
    ``p1 = bf16(p)``, ``p2 = bf16(p - p1)``, ``p3 = bf16(p - p1 - p2)``.
    Each subtraction is exact in f32, so ``p1 + p2 + p3 == p`` bitwise for
    every p >= 2^-100 (below that the error stays under 2^-120)."""
    p = p.float()
    p1 = p.bfloat16()
    r1 = p - p1.float()
    p2 = r1.bfloat16()
    p3 = (r1 - p2.float()).bfloat16()
    return p1, p2, p3


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None):
    """Plain PyTorch version (``flash_attention_ref``): f32 full attention,
    GQA by ``repeat_interleave``, rows with no visible key give 0."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window:
        ok &= qp - kp < window
    s = torch.where(ok, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isfinite(s).any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal=True, window=0, scale=None):
    """Launch the Hopper kernel (``csrc/flash_attention.cu``): the
    tensor-core kernel for bf16 q, k and v, the CUDA-core kernel for f32.
    Raises on anything it does not take: q, k and v contiguous, 16-byte
    aligned CUDA tensors of one dtype (bf16 or f32) on one device,
    head_dim in ``HEAD_DIMS``, H a multiple of KV, window >= 0.  Counts
    ``flash_attention``."""
    ts = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("flash_attention_cuda needs CUDA tensors on one "
                         "device")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, Sq, H, hd], k and v [B, Sk, KV, "
                         f"hd] of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, KV, hdk = k.shape
    if k.shape[0] != B or hdk != hd or KV == 0 or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (batch, head_dim, H % KV)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"kernel takes q, k, v of one dtype, float32 or "
                         f"bfloat16; got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("kernel takes contiguous, 16-byte aligned tensors")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")
    if max(B, H) > 65535:
        raise ValueError(f"B and H must be at most 65535; got B {B}, H {H}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    o = torch.empty_like(q)
    if B * Sq * H == 0:
        return o
    if Sk == 0:
        return o.zero_()
    lib = build.library("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk,
        H, KV, hd, int(q.dtype == torch.bfloat16), int(bool(causal)),
        int(window), float(scale), ctypes.c_void_p(stream))
    build.check("flash_attention", rc)
    build.LAUNCHES["flash_attention"] += 1
    return o
