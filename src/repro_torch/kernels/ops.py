"""Public kernel entry points: dispatch, launch counters, profiling.

Counterpart of ``repro.kernels.ops`` for the ported kernels: decode
attention (dense and the fused paged write+attend), the row
scatter-swap, masked Adam (f32 and Q8 moments), the RG-LRU scan (a
``torch.autograd.Function``: the kernel forward and backward) and flash
attention (a ``torch.autograd.Function``: the kernel forward, the
backward recomputed through ``layers.attention_chunked``).
Every op takes ``mode``:

- ``auto``: the Hopper kernel for a CUDA tensor, the plain PyTorch
  version for a CPU tensor;
- ``kernel``: the Hopper kernel; raises for a CPU tensor;
- ``plain``: the plain version on any device (the reference the
  kernels are held against on the card; never the serving path's
  choice).

There is no fallback: a CUDA tensor goes through the kernel or raises.
The kernels are built at first use (``kernels/build.py``), whose
``LAUNCHES`` counters and ``reset_launches`` are re-exported here.

``enable_kernel_profiling()`` times every op (CUDA events on the card,
the host clock on the CPU) next to the bytes it must move, under the
``kernels/<op>_calls`` / ``kernels/<op>_ms`` metric names and the
``kernels`` trace lane of the JAX package.
"""
from __future__ import annotations

import time

import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import masked_adam as ma
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels import scatter_apply as sa
from repro_torch.kernels.build import (LAUNCHES, builds,  # noqa: F401
                                       reset_launches)
from repro_torch.models import layers

MODES = ("auto", "kernel", "plain")


def route(mode: str, t: torch.Tensor) -> str:
    """Resolve ``mode`` for tensor ``t`` to ``kernel`` or ``plain``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "auto":
        return "kernel" if t.is_cuda else "plain"
    if mode == "kernel" and not t.is_cuda:
        raise ValueError("mode='kernel' needs a CUDA tensor (the kernels "
                         "run on the card only); use 'auto' or 'plain'")
    return mode


# --------------------------------------------------------------------- #
# opt-in kernel profiling (TraceKit)
# --------------------------------------------------------------------- #


class KernelProfiler:
    """Collects per-op timing records; optionally forwards them to a
    tracer (lane ``kernels``) and a metrics registry."""

    def __init__(self, tracer=None, metrics=None):
        self.tracer = tracer
        self.metrics = metrics
        self.records = []

    def record(self, op: str, t0_ns: int, dt_ms: float, nbytes):
        rec = {"op": op, "ms": dt_ms, "bytes": nbytes,
               "gbps": (nbytes / (dt_ms / 1e3) / 1e9
                        if nbytes and dt_ms > 0 else None)}
        self.records.append(rec)
        if self.tracer is not None:
            args = {"bytes": nbytes} if nbytes else {}
            if rec["gbps"] is not None:
                args["gbps"] = round(rec["gbps"], 3)
            self.tracer.add_span(op, t0_ns, t0_ns + int(dt_ms * 1e6),
                                 lane="kernels", **args)
        if self.metrics is not None:
            self.metrics.counter(f"kernels/{op}_calls").inc()
            self.metrics.histogram(f"kernels/{op}_ms").observe(dt_ms)

    def summary(self):
        out = {}
        for r in self.records:
            s = out.setdefault(r["op"], {"calls": 0, "ms": 0.0, "bytes": 0})
            s["calls"] += 1
            s["ms"] += r["ms"]
            s["bytes"] += r["bytes"] or 0
        return out


_PROFILER: "KernelProfiler | None" = None


def enable_kernel_profiling(tracer=None, metrics=None) -> KernelProfiler:
    global _PROFILER
    _PROFILER = KernelProfiler(tracer=tracer, metrics=metrics)
    return _PROFILER


def disable_kernel_profiling() -> None:
    global _PROFILER
    _PROFILER = None


def _profiled_call(op, fn, args, kwargs, nbytes, device):
    prof = _PROFILER
    t0 = time.monotonic_ns()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        dt_ms = start.elapsed_time(end)
    else:
        out = fn(*args, **kwargs)
        dt_ms = (time.monotonic_ns() - t0) / 1e6
    prof.record(op, t0, dt_ms, nbytes)
    return out


# --------------------------------------------------------------------- #
# decode attention (serving hot path; inference only)
# --------------------------------------------------------------------- #


def decode_attention(q, k_cache, v_cache, pos, *, window=0, ring=False,
                     softcap=0.0, mode: str = "auto", block_k: int = 128,
                     offset: int = 0, total=None, return_lse: bool = False):
    """One-token attention against a slot-batched KV cache.

    q [B, 1, H, hd]; caches [B, C, KV, hd]; pos [B] int32.  The kernel's
    cache reads scale with ``pos`` (see kernels/decode_attention.py).
    The shard variant: the caches hold rows ``offset ..`` of a cache of
    ``total`` rows, and ``return_lse`` returns ``(o, lse [B, H] f32)``
    for a softmax merge across shards."""
    fn = (da.decode_attention_cuda if route(mode, q) == "kernel"
          else da.decode_attention_plain)
    kw = dict(window=window, ring=ring, softcap=softcap, block_k=block_k,
              offset=offset, total=total, return_lse=return_lse)
    if _PROFILER is None:
        return fn(q, k_cache, v_cache, pos, **kw)
    nb = 2 * q.nbytes + da.cache_read_bytes(
        pos.cpu(), seq_len=k_cache.shape[1], kv_heads=k_cache.shape[2],
        head_dim=k_cache.shape[3], window=window, ring=ring,
        block_k=block_k, dtype_bytes=k_cache.element_size(), offset=offset,
        total=total)
    return _profiled_call("decode_attention", fn, (q, k_cache, v_cache, pos),
                          kw, nb, q.device)


def paged_decode_attention(q, new_k, new_v, k_pool, v_pool, pos, page_table,
                           active, *, window=0, softcap=0.0,
                           mode: str = "auto", block_k: int = 128):
    """One-token fused write+attend against paged KV pools.

    q [B, 1, H, hd]; new_k/new_v [B, KV, hd] (the new token's rows);
    pools [P, page_size, KV, hd], updated in place; page_table [B, NP]
    int32; active [B] bool (inactive slots write nothing).  Returns
    ``(o, k_pool, v_pool)``.  The row write happens inside the op, so a
    decode step runs one op per layer.  The kernel's reads scale with
    ``pos``; with equal ``block_k`` it equals ``decode_attention`` on the
    gathered view bit for bit."""
    fn = (da.paged_decode_attention_cuda if route(mode, q) == "kernel"
          else da.paged_decode_attention_plain)
    args = (q, new_k, new_v, k_pool, v_pool, pos, page_table, active)
    kw = dict(window=window, softcap=softcap, block_k=block_k)
    if _PROFILER is None:
        return fn(*args, **kw)
    nb = 2 * q.nbytes + da.paged_cache_read_bytes(
        pos.cpu(), num_pages_per_slot=page_table.shape[1],
        page_size=k_pool.shape[1], kv_heads=k_pool.shape[2],
        head_dim=k_pool.shape[3], window=window,
        dtype_bytes=k_pool.element_size())
    return _profiled_call("paged_decode_attention", fn, args, kw, nb,
                          q.device)


# --------------------------------------------------------------------- #
# adapter row scatter-swap
# --------------------------------------------------------------------- #


def scatter_swap(full, idx, rows, *, mode: str = "auto",
                 donate: bool = False):
    """Swap rows ``idx`` (a host array) of a ``[G, ...]`` leaf with
    ``rows`` [K, ...].  Returns ``(new_full, displaced_rows)``, an exact
    involution.

    ``donate=True`` updates ``full`` in place (the JAX package donates
    the buffer; O(K) bytes move and the returned leaf is ``full``
    itself).  The default clones the leaf first and leaves the input
    untouched, as the JAX package's non-donated path does.
    """
    if len(idx) == 0:
        return full, rows
    fn = (sa.scatter_swap_cuda if route(mode, full) == "kernel"
          else sa.scatter_swap_plain)
    if not donate:
        full = full.clone()
    if _PROFILER is None:
        return fn(full, idx, rows)
    # rows read + written in both directions (the swap is an involution)
    return _profiled_call("scatter_swap", fn, (full, idx, rows), {},
                          2 * rows.nbytes, full.device)


# --------------------------------------------------------------------- #
# fused masked adam over parameter trees (the BlockLLM optimizer step)
# --------------------------------------------------------------------- #


def _leaves(tree):
    return _flatten_with_names(tree)[1]


def _mask_leaves(masks, n):
    return [None] * n if masks is None else _leaves(masks)


def _tree_nbytes(*trees) -> int:
    return sum(t.nbytes for tree in trees if tree is not None
               for t in _leaves(tree))


def masked_adam_tree(params, grads, mu, nu, masks, *, lr, b1=0.9, b2=0.999,
                     eps=1e-8, weight_decay=0.0, count=0, tau=0.0,
                     use_tau=False, mode: str = "auto"):
    """Fused masked Adam across every leaf, in place on ``params``,
    ``mu`` and ``nu`` (the JAX step donates them).  Returns ``(params,
    mu, nu)``.  ``masks`` None (or a None leaf) means gate 1: no ones
    tensor is made.  One kernel launch per leaf, on the flat leaf (the
    JAX wrapper's ``_to_2d`` view is not needed)."""
    scal = ma.scalars(lr=lr, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay, count=count, tau=tau)
    ps = _leaves(params)
    if not ps:
        return params, mu, nu
    fn = (ma.masked_adam_cuda if route(mode, ps[0]) == "kernel"
          else ma.masked_adam_plain)

    def run():
        for p, g, m, v, msk in zip(ps, _leaves(grads), _leaves(mu),
                                   _leaves(nu), _mask_leaves(masks, len(ps))):
            fn(p, g, m, v, msk, scal, use_tau=use_tau)
        return params, mu, nu

    if _PROFILER is None:
        return run()
    # params/mu/nu read + written, grads and masks read once
    nb = 2 * _tree_nbytes(params, mu, nu) + _tree_nbytes(grads, masks)
    return _profiled_call("masked_adam", run, (), {}, nb, ps[0].device)


def masked_adam_q8_tree(params, grads, mu_q, mu_scale, nu_q, nu_scale,
                        masks, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                        weight_decay=0.0, count=0, tau=0.0, use_tau=False,
                        mode: str = "auto"):
    """Fused dequant -> masked Adam -> requant across every leaf, in place
    on ``params`` and the Q8 moments (int8 ``[NB, 256]`` codes + f32
    ``[NB]`` scales per leaf): no f32 moment tree is made.  Returns
    ``(params, mu_q, mu_scale, nu_q, nu_scale)``."""
    scal = ma.scalars(lr=lr, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay, count=count, tau=tau)
    ps = _leaves(params)
    if not ps:
        return params, mu_q, mu_scale, nu_q, nu_scale
    fn = (ma.masked_adam_q8_cuda if route(mode, ps[0]) == "kernel"
          else ma.masked_adam_q8_plain)

    def run():
        for p, g, mq, ms, vq, vs, msk in zip(
                ps, _leaves(grads), _leaves(mu_q), _leaves(mu_scale),
                _leaves(nu_q), _leaves(nu_scale),
                _mask_leaves(masks, len(ps))):
            fn(p, g, mq, ms, vq, vs, msk, scal, use_tau=use_tau)
        return params, mu_q, mu_scale, nu_q, nu_scale

    if _PROFILER is None:
        return run()
    nb = (2 * _tree_nbytes(params, mu_q, mu_scale, nu_q, nu_scale)
          + _tree_nbytes(grads, masks))
    return _profiled_call("masked_adam_q8", run, (), {}, nb, ps[0].device)


# --------------------------------------------------------------------- #
# RG-LRU scan (the recurrent blocks' time loop over a full sequence)
# --------------------------------------------------------------------- #


class _RGLRUScan(torch.autograd.Function):
    """``h_t = a_t * h_{t-1} + b_t`` with its VJP as one reversed scan
    (``repro.kernels.ops._rg_fwd`` / ``_rg_bwd``): lam_t = a_{t+1} *
    lam_{t+1} + dy_t (dy[:, -1] + dh_last at the end), da = lam * h_{t-1},
    db = lam, dh0 = lam_0 * a_0, all in one kernel.  Both directions run
    the kernels (``kernel=True``) or their plain versions."""

    @staticmethod
    def forward(ctx, a, b, h0, kernel):
        fn = rs.rglru_scan_cuda if kernel else rs.rglru_scan_plain
        y, h_last = fn(a, b, h0)
        ctx.save_for_backward(a, y, h0)
        ctx.kernel = kernel
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, y, h0 = ctx.saved_tensors
        fn = rs.rglru_scan_bwd_cuda if ctx.kernel else rs.rglru_scan_bwd_plain
        da, db, dh0 = fn(a, y, h0, dy.contiguous(), dh_last.contiguous(),
                         need_dh0=ctx.needs_input_grad[2])
        return da, db, dh0, None


def rglru_scan(a, b, h0, *, mode: str = "auto"):
    """RG-LRU linear recurrence over time, differentiable.

    a, b [B, S, W] f32; h0 [B, W] f32.  Returns ``(y [B, S, W], h_last
    [B, W])``, both f32.  Inputs are made contiguous here (the kernel
    takes contiguous tensors only)."""
    kernel = route(mode, a) == "kernel"
    a, b, h0 = a.contiguous(), b.contiguous(), h0.contiguous()
    if _PROFILER is None:
        return _RGLRUScan.apply(a, b, h0, kernel)
    # a/b read, y written (a-shaped), h0/hN negligible
    nb = 2 * a.nbytes + b.nbytes
    return _profiled_call("rglru_scan", _RGLRUScan.apply,
                          (a, b, h0, kernel), {}, nb, a.device)


# --------------------------------------------------------------------- #
# flash attention (forward kernel, backward through attention_chunked)
# --------------------------------------------------------------------- #


class _FlashAttention(torch.autograd.Function):
    """The kernel forward (``kernel=True``) or its plain version; the
    backward is the VJP of ``layers.attention_chunked`` recomputed from
    the saved q, k and v with positions ``arange(Sq)``, as
    ``repro.kernels.ops._fa_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kernel):
        fn = fa.flash_attention_cuda if kernel else fa.flash_attention_plain
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return fn(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        B, Sq = q.shape[:2]
        if k.shape[1] != Sq:
            raise ValueError(f"flash_attention's backward takes Sq == Sk "
                             f"(one position vector); got Sq {Sq}, Sk "
                             f"{k.shape[1]}")
        pos = torch.arange(Sq, dtype=torch.int32,
                           device=q.device)[None].expand(B, Sq)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            o = layers.attention_chunked(*ins, pos, pos, causal=ctx.causal,
                                         window=ctx.window)
            dq, dk, dv = torch.autograd.grad(o, ins, do)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, window=0, *, mode: str = "auto"):
    """Flash attention, differentiable: q [B, Sq, H, hd], k/v [B, Sk, KV,
    hd] -> o [B, Sq, H, hd] in q's dtype.  The forward is the kernel
    (``kernels/flash_attention.py``) or its plain version; the backward
    recomputes through ``attention_chunked``, whose q-chunk
    ``min(1024, Sq)`` must divide Sq, with Sq == Sk."""
    kernel = route(mode, q) == "kernel"
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _PROFILER is None:
        return _FlashAttention.apply(q, k, v, causal, window, kernel)
    # bytes touched: q, k, v read once, o (q-shaped) written
    nb = fa.flash_bytes(q, k, v)
    return _profiled_call("flash_attention", _FlashAttention.apply,
                          (q, k, v, causal, window, kernel), {}, nb,
                          q.device)
