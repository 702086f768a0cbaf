"""RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t`` (counterpart of
``repro.kernels.rglru_scan``) and its VJP.

Elementwise over the width, sequential over time: a, b ``[B, S, W]`` f32,
h0 ``[B, W]`` f32 (None: zeros) -> y ``[B, S, W]`` f32 (every h_t) and
h_last ``[B, W]`` f32.

The function is a chunked scan with one fixed chunk length,
``SCAN_CHUNK``: time is cut into chunks of that many steps, counted from
the scan's first step.  For chunk k, P_k is the product of its a's in
scan order and H_k its scan from a -0 state; the carries are
c_0 = h0 and c_{k+1} = P_k * c_k + H_k; each chunk is run again from c_k,
writing y.  Every multiply and every add is rounded on its own (no FMA).
At S <= SCAN_CHUNK this is the sequential scan bit for bit; longer, it
rounds otherwise than ``kernels/ref.py:rglru_ref`` (the sequential
oracle), within 1e-6 at the tests' shapes.

- ``rglru_scan_cuda`` / ``rglru_scan_bwd_cuda`` launch the Hopper kernels
  (``csrc/rglru_scan.cu``): 32 channels by 8 chunks a block;
- ``rglru_scan_plain`` / ``rglru_scan_bwd_plain`` are the same functions
  in plain PyTorch, vectorised across chunks (2 * SCAN_CHUNK + n steps
  over n chunks), used for CPU tensors and as the kernels' reference on
  the card.  Kernel and plain version are bitwise equal.
- The backward (``_rg_bwd`` of ``repro.kernels.ops``): from a, the
  forward's y, h0, dy and dh_last, lam_t = a_{t+1} * lam_{t+1} + dy_t
  from t = S - 1 down (a_S = 0, dy_{S-1} + dh_last), db = lam,
  da = lam * y_{t-1} (h0 at t = 0), dh0 = lam_0 * a_0.
- ``scan_bytes`` / ``scan_bwd_bytes`` are the traffic of one call.

Dispatch (kernel on CUDA tensors, plain on CPU tensors) and the autograd
Function live in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# the kernels' chunk length is kChunk of csrc/rglru_scan.cu, fixed when
# they are built; their entries reject any other SCAN_CHUNK
SCAN_CHUNK = 16


def scan_bytes(B: int, S: int, W: int) -> int:
    """Bytes one forward call moves: a, b read and y written (f32), h0
    read and h_last written."""
    return 4 * (3 * B * S * W + 2 * B * W)


def scan_bwd_bytes(B: int, S: int, W: int) -> int:
    """Bytes one backward call moves: a, y, dy read and da, db written
    (f32), h0, dh_last read and dh0 written."""
    return 4 * (5 * B * S * W + 3 * B * W)


def _chunked_scan(a, b, h0):
    """The chunked scan forward in time; a, b [B, S, W], h0 [B, W]."""
    B, S, W = a.shape
    L = SCAN_CHUNK
    n = -(-S // L)
    pad = n * L - S
    if pad:
        # identity steps (a = 1, b = -0) leave every h bit for bit
        a = torch.cat([a, a.new_ones(B, pad, W)], dim=1)
        b = torch.cat([b, b.new_full((B, pad, W), -0.0)], dim=1)
    a = a.reshape(B, n, L, W)
    b = b.reshape(B, n, L, W)
    P = torch.ones(B, n, W, dtype=torch.float32, device=a.device)
    # H from -0: a run of -0 states stays -0 across chunks, as it does
    # in the sequential scan
    H = torch.full((B, n, W), -0.0, dtype=torch.float32, device=a.device)
    for i in range(L):
        P = a[:, :, i] * P
        H = a[:, :, i] * H
        H = H + b[:, :, i]
    c = torch.empty(B, n, W, dtype=torch.float32, device=a.device)
    c[:, 0] = h0
    for k in range(n - 1):
        c[:, k + 1] = P[:, k] * c[:, k]
        c[:, k + 1] += H[:, k]
    y = torch.empty(B, n, L, W, dtype=torch.float32, device=a.device)
    h = c
    for i in range(L):
        h = a[:, :, i] * h
        h = h + b[:, :, i]
        y[:, :, i] = h
    return y.reshape(B, n * L, W)[:, :S].contiguous()


def rglru_scan_plain(a, b, h0=None, *, reverse=False):
    """Plain PyTorch version of the forward kernel.  ``reverse=True`` runs
    the recurrence from t = S - 1 down to 0 (chunks counted from there):
    the flipped scan of the flipped inputs, bit for bit.  Returns
    ``(y, h_last)``; h_last is the last step's h."""
    B, S, W = a.shape
    h0 = (torch.zeros(B, W, dtype=torch.float32, device=a.device)
          if h0 is None else h0.float())
    if S == 0:
        return torch.empty(B, 0, W, dtype=torch.float32,
                           device=a.device), h0.clone()
    if reverse:
        y = _chunked_scan(a.flip(1), b.flip(1), h0).flip(1)
        return y, y[:, 0].clone()
    y = _chunked_scan(a, b, h0)
    return y, y[:, -1].clone()


def rglru_scan_bwd_plain(a, y, h0, dy, dh_last, *, need_dh0=True):
    """Plain PyTorch version of the backward kernel: the reversed scan of
    ``a`` shifted one step and ``dy`` (with dh_last added at the end),
    then the products.  h0 may be None (zeros).  Returns ``(da, db,
    dh0)``, dh0 None unless ``need_dh0``."""
    B, S, W = a.shape
    h0 = (torch.zeros(B, W, dtype=torch.float32, device=a.device)
          if h0 is None else h0)
    a_next = torch.cat([a[:, 1:], a.new_zeros(B, 1, W)], dim=1)
    dy = dy.clone(memory_format=torch.contiguous_format)
    dy[:, -1] += dh_last
    lam, _ = rglru_scan_plain(a_next, dy, None, reverse=True)
    y_prev = torch.cat([h0[:, None], y[:, :-1]], dim=1)
    dh0 = lam[:, 0] * a[:, 0] if need_dh0 else None
    return lam * y_prev, lam, dh0


def _check(name, ts, shapes):
    """Raise on what the kernels do not take: contiguous f32 CUDA tensors
    on one device, of the given shapes."""
    dev = ts[0].device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(f"{name} needs CUDA tensors on one device")
    for t, shape, what in shapes:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} must be {list(shape)}; got "
                             f"{list(t.shape)}")
    if not all(t.dtype == torch.float32 for t in ts):
        raise ValueError(f"kernel takes f32 tensors; got "
                         f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("kernel takes contiguous tensors")


def _dims(a):
    if a.dim() != 3:
        raise ValueError(f"a must be [B, S, W]; got {tuple(a.shape)}")
    B, S, W = a.shape
    if B * W >= 2 ** 31 or S >= 2 ** 31:
        raise ValueError(f"B * W and S must be below 2**31; got B {B}, "
                         f"S {S}, W {W}")
    return B, S, W


def rglru_scan_cuda(a, b, h0=None):
    """Launch the forward kernel (``csrc/rglru_scan.cu``); counts as
    ``rglru_scan``.  Raises on anything it does not take: a, b must be
    contiguous f32 ``[B, S, W]`` CUDA tensors, h0 a contiguous f32
    ``[B, W]`` one or None."""
    B, S, W = _dims(a)
    shapes = [(b, a.shape, "b")] + ([] if h0 is None else
                                    [(h0, (B, W), "h0")])
    _check("rglru_scan_cuda", [a] + [t for t, _, _ in shapes], shapes)
    y = torch.empty(B, S, W, dtype=torch.float32, device=a.device)
    h_last = torch.empty(B, W, dtype=torch.float32, device=a.device)
    if B * S * W == 0:
        return y, (h_last.zero_() if h0 is None else h_last.copy_(h0))
    lib = build.library("rglru_scan")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), B, S, W, SCAN_CHUNK,
        ctypes.c_void_p(stream))
    build.check("rglru_scan", rc)
    build.LAUNCHES["rglru_scan"] += 1
    return y, h_last


def rglru_scan_bwd_cuda(a, y, h0, dy, dh_last, *, need_dh0=True):
    """Launch the backward kernel (``csrc/rglru_scan.cu``); counts as
    ``rglru_scan_bwd``.  a, y, dy contiguous f32 ``[B, S, W]``, h0 (or
    None: zeros) and dh_last contiguous f32 ``[B, W]``, all CUDA tensors
    on one device; raises on anything else.  Returns ``(da, db, dh0)``,
    dh0 None unless ``need_dh0``."""
    B, S, W = _dims(a)
    shapes = [(y, a.shape, "y"), (dy, a.shape, "dy"),
              (dh_last, (B, W), "dh_last")] + ([] if h0 is None else
                                                [(h0, (B, W), "h0")])
    _check("rglru_scan_bwd_cuda", [a] + [t for t, _, _ in shapes], shapes)
    da = torch.empty(B, S, W, dtype=torch.float32, device=a.device)
    db = torch.empty(B, S, W, dtype=torch.float32, device=a.device)
    dh0 = (torch.empty(B, W, dtype=torch.float32, device=a.device)
           if need_dh0 else None)
    if B * S * W == 0:
        return da, db, (None if dh0 is None else dh0.zero_())
    lib = build.library("rglru_scan")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.rglru_scan_bwd_launch(
        a.data_ptr(), y.data_ptr(), None if h0 is None else h0.data_ptr(),
        dy.data_ptr(), dh_last.data_ptr(), da.data_ptr(), db.data_ptr(),
        None if dh0 is None else dh0.data_ptr(), B, S, W, SCAN_CHUNK,
        ctypes.c_void_p(stream))
    build.check("rglru_scan", rc)
    build.LAUNCHES["rglru_scan_bwd"] += 1
    return da, db, dh0
