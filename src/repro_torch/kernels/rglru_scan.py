"""RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t`` (counterpart of
``repro.kernels.rglru_scan``).

Elementwise over the width, sequential over time: a, b ``[B, S, W]`` f32,
h0 ``[B, W]`` f32 (None: zeros) -> y ``[B, S, W]`` f32 (every h_t) and
h_last ``[B, W]`` f32.  ``reverse=True`` runs the same recurrence from
t = S - 1 down to 0 (``h_t = a_t * h_{t+1} + b_t``, h_last is then the
state after t = 0): the adjoint scan of the backward pass, without
flipped copies.

- ``rglru_scan_cuda`` launches the Hopper kernel (``csrc/rglru_scan.cu``):
  one thread per (b, w) channel, h in a register;
- ``rglru_scan_plain`` is the same function in plain PyTorch, a loop over
  t with the multiply and the add as two ops (each rounded on its own,
  as the kernel, which contracts nothing into an FMA), used for CPU
  tensors and as the kernel's reference on the card.  The two are
  bitwise equal.
- ``scan_bytes`` is the traffic of one call: a and b read, y written
  once, h0 read and h_last written.

Dispatch (kernel on CUDA tensors, plain on CPU tensors) and the autograd
Function live in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def scan_bytes(B: int, S: int, W: int) -> int:
    """Bytes one call moves: a, b read and y written (f32), h0 read and
    h_last written."""
    return 4 * (3 * B * S * W + 2 * B * W)


def rglru_scan_plain(a, b, h0=None, *, reverse=False):
    """Plain PyTorch version of the kernel.  Returns ``(y, h_last)``."""
    B, S, W = a.shape
    h = (torch.zeros(B, W, dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    y = torch.empty(B, S, W, dtype=torch.float32, device=a.device)
    for t in (range(S - 1, -1, -1) if reverse else range(S)):
        h = a[:, t] * h
        h = h + b[:, t]
        y[:, t] = h
    return y, h


def rglru_scan_cuda(a, b, h0=None, *, reverse=False):
    """Launch the Hopper kernel (``csrc/rglru_scan.cu``).  Raises on
    anything it does not take: a, b must be contiguous f32 ``[B, S, W]``
    CUDA tensors, h0 a contiguous f32 ``[B, W]`` one or None.  The
    forward scan counts as ``rglru_scan``, the reversed one (the
    backward pass) as ``rglru_scan_bwd``."""
    ts = (a, b) if h0 is None else (a, b, h0)
    if not all(t.is_cuda and t.device == a.device for t in ts):
        raise ValueError("rglru_scan_cuda needs CUDA tensors on one device")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a and b must be [B, S, W] of one shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    B, S, W = a.shape
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 must be [B, W] = [{B}, {W}]; got "
                         f"{tuple(h0.shape)}")
    if not all(t.dtype == torch.float32 for t in ts):
        raise ValueError(f"kernel takes f32 a, b, h0; got "
                         f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("kernel takes contiguous tensors")
    if B * W >= 2 ** 31 or S >= 2 ** 31:
        raise ValueError(f"B * W and S must be below 2**31; got B {B}, "
                         f"S {S}, W {W}")
    y = torch.empty(B, S, W, dtype=torch.float32, device=a.device)
    h_last = torch.empty(B, W, dtype=torch.float32, device=a.device)
    if B * S * W == 0:
        return y, (h_last.zero_() if h0 is None else h_last.copy_(h0))
    lib = build.library("rglru_scan")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), B, S, W, int(bool(reverse)),
        ctypes.c_void_p(stream))
    build.check("rglru_scan", rc)
    build.LAUNCHES["rglru_scan_bwd" if reverse else "rglru_scan"] += 1
    return y, h_last
