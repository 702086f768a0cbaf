"""Masked Adam: the BlockLLM optimizer step (counterpart of
``repro.kernels.masked_adam``), in f32 and Q8 moment storage.

One fused pass over each leaf of the active selection:

    m' = b1*m + (1-b1)*g;  v' = b2*v + ((1-b2)*g)*g
    u  = (m'/bc1) / (sqrt(v'/bc2) + eps);  gate = mask or |u| >= tau
    p' = p - lr*(u*gate + wd*p)

``scal`` is the TPU kernel's scalar vector ``[lr, b1, b2, eps, wd, bc1,
bc2, tau]`` as f32 values (``scalars``).  ``1 - b1`` and ``1 - b2`` are
taken from the f32 scalars (``1 - f32(0.9) = 0.100000024``), as the TPU
kernel does; the unfused ``optim.Adam`` uses ``f32(1 - 0.9) = 0.1``, as
JAX's weakly typed constants do.

- ``masked_adam_cuda`` / ``masked_adam_q8_cuda`` launch the Hopper
  kernels (``csrc/masked_adam.cu``) on flat contiguous leaves: no
  padded copy, the ragged tail is masked in the kernel;
- ``masked_adam_plain`` / ``masked_adam_q8_plain`` are the same
  functions in plain PyTorch (one elementwise op per step of the
  formula, so nothing is contracted into an FMA), used for CPU tensors
  and as the kernels' reference on the card.  The Q8 version pads the
  last 256-element codec block with zeros (gate 0) as the JAX wrapper
  does.

All four update their operands in place (the JAX step donates them):
``p``, ``m``, ``v`` (or ``p``, ``mq``, ``ms``, ``vq``, ``vs``).  ``mask``
may be None, meaning gate 1 (no ones tensor is made).  Q8 moments are
int8 ``[NB, 256]`` codes with f32 ``[NB]`` scales, NB = ceil(n / 256).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.numerics import div_exact, sqrt_exact
from repro_torch.runtime.compression import BLOCK

N_SCALARS = 8


def scalars(*, lr, b1, b2, eps, weight_decay, count, tau=0.0):
    """The f32 scalar vector of one step, as ``ops.masked_adam_tree``
    builds it in JAX: ``bc = 1 - b ** (f32(count) + 1)`` in f32."""
    f = np.float32
    cf = f(count) + f(1.0)
    return tuple(float(x) for x in (
        f(lr), f(b1), f(b2), f(eps), f(weight_decay),
        f(1.0) - f(b1) ** cf, f(1.0) - f(b2) ** cf, f(tau)))


def _check_scal(scal) -> Sequence[float]:
    scal = [float(np.float32(x)) for x in scal]
    if len(scal) != N_SCALARS:
        raise ValueError(f"scal holds {N_SCALARS} values "
                         f"[lr, b1, b2, eps, wd, bc1, bc2, tau]")
    return scal


def _update(p32, g, m, v, gate_mask, scal, use_tau):
    """The step in plain PyTorch, op for op as the kernel (f32 math)."""
    lr, b1, b2, eps, wd, bc1, bc2, tau = scal
    omb1 = float(np.float32(1.0) - np.float32(b1))
    omb2 = float(np.float32(1.0) - np.float32(b2))
    m2 = (m * b1) + (g * omb1)
    v2 = (v * b2) + ((g * omb2) * g)
    u = div_exact(m2, bc1) / (sqrt_exact(div_exact(v2, bc2)) + eps)
    if use_tau:
        gate = (u.abs() >= tau).float()
    elif gate_mask is None:
        gate = None
    else:
        gate = gate_mask.float()
    ug = u if gate is None else u * gate
    p2 = p32 - (ug + (p32 * wd)) * lr
    return p2, m2, v2


def masked_adam_plain(p, g, m, v, mask, scal, *, use_tau=False):
    """Plain PyTorch version, in place on ``p``, ``m``, ``v``."""
    scal = _check_scal(scal)
    p2, m2, v2 = _update(p.float(), g.float(), m, v, mask, scal, use_tau)
    p.copy_(p2)
    m.copy_(m2)
    v.copy_(v2)
    return p, m, v


def _requant(x):
    """runtime/compression.py's block formula over [NB, 256] rows."""
    s = torch.clamp(div_exact(x.abs().amax(dim=1, keepdim=True), 127.0),
                    min=1e-12)
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s[:, 0]


def _q8_view(a, n_blocks, fill=0):
    flat = a.reshape(-1)
    pad = n_blocks * BLOCK - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), fill)])
    return flat.reshape(n_blocks, BLOCK)


def masked_adam_q8_plain(p, g, mq, ms, vq, vs, mask, scal, *,
                         use_tau=False):
    """Plain PyTorch version of the Q8 step, in place on ``p``, ``mq``,
    ``ms``, ``vq``, ``vs``.  The last codec block is zero padded (mask
    padded with False) as the JAX wrapper pads its [NB, 256] views."""
    scal = _check_scal(scal)
    n, nb = p.numel(), mq.shape[0]
    pv = _q8_view(p.float(), nb)
    gv = _q8_view(g.float(), nb)
    mk = _q8_view(mask if mask is not None
                  else torch.ones(p.shape, dtype=torch.bool,
                                  device=p.device), nb, False)
    m = mq.float() * ms[:, None]
    v = vq.float() * vs[:, None]
    p2, m2, v2 = _update(pv, gv, m, v, mk, scal, use_tau)
    p.copy_(p2.reshape(-1)[:n].reshape(p.shape))
    for q, s, x in ((mq, ms, m2), (vq, vs, v2)):
        q2, s2 = _requant(x)
        q.copy_(q2)
        s.copy_(s2)
    return p, mq, ms, vq, vs


# --------------------------------------------------------------------- #
# the Hopper kernels
# --------------------------------------------------------------------- #


def _check_leaf(name, t, dtype, device, numel=None):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (the kernel updates "
                         f"flat leaves in place)")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected "
                         f"{numel}")


def _common(p, g, mask):
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"p must be float32 or bfloat16, got {p.dtype}")
    _check_leaf("p", p, None, p.device)
    _check_leaf("g", g, p.dtype, p.device, p.numel())
    if mask is not None:
        _check_leaf("mask", mask, torch.bool, p.device, p.numel())
    return torch.cuda.current_stream(p.device).cuda_stream


def _aligned(tensors, width) -> bool:
    return all(t is None or t.data_ptr() % width == 0 for t in tensors)


def masked_adam_cuda(p, g, m, v, mask: Optional[torch.Tensor], scal, *,
                     use_tau=False):
    """Launch ``masked_adam`` in place on ``p``, ``m``, ``v``."""
    stream = _common(p, g, mask)
    n = p.numel()
    _check_leaf("m", m, torch.float32, p.device, n)
    _check_leaf("v", v, torch.float32, p.device, n)
    scal = _check_scal(scal)
    if n == 0:
        return p, m, v
    vec = (_aligned((p, g), 4 * p.element_size()) and _aligned((m, v), 16)
           and _aligned((mask,), 4))
    lib = build.library("masked_adam")
    mp = mask.data_ptr() if mask is not None else None
    rc = lib.masked_adam_launch(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), mp, n,
        int(p.dtype == torch.bfloat16), int(use_tau), *scal, int(vec),
        ctypes.c_void_p(stream))
    build.check("masked_adam", rc)
    build.LAUNCHES["masked_adam"] += 1
    return p, m, v


def masked_adam_q8_cuda(p, g, mq, ms, vq, vs, mask: Optional[torch.Tensor],
                        scal, *, use_tau=False):
    """Launch ``masked_adam_q8`` in place on ``p``, ``mq``, ``ms``,
    ``vq``, ``vs``."""
    stream = _common(p, g, mask)
    n = p.numel()
    nb = -(-n // BLOCK)
    for name, q in (("mq", mq), ("vq", vq)):
        _check_leaf(name, q, torch.int8, p.device, nb * BLOCK)
    for name, s in (("ms", ms), ("vs", vs)):
        _check_leaf(name, s, torch.float32, p.device, nb)
    scal = _check_scal(scal)
    if n == 0:
        return p, mq, ms, vq, vs
    if not _aligned((mq, vq), 4):
        raise ValueError("mq / vq must be 4-byte aligned")
    vec = _aligned((p, g), 4 * p.element_size()) and _aligned((mask,), 4)
    lib = build.library("masked_adam")
    mp = mask.data_ptr() if mask is not None else None
    rc = lib.masked_adam_q8_launch(
        p.data_ptr(), g.data_ptr(), mq.data_ptr(), ms.data_ptr(),
        vq.data_ptr(), vs.data_ptr(), mp, n,
        int(p.dtype == torch.bfloat16), int(use_tau), *scal, int(vec),
        ctypes.c_void_p(stream))
    build.check("masked_adam", rc)
    build.LAUNCHES["masked_adam_q8"] += 1
    return p, mq, ms, vq, vs
