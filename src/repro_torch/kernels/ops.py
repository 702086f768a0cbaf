"""Public kernel entry points: dispatch, launch counters, profiling.

Counterpart of ``repro.kernels.ops`` for the ported kernels: decode
attention, the row scatter-swap and masked Adam (f32 and Q8 moments).
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
from repro_torch.kernels import masked_adam as ma
from repro_torch.kernels import scatter_apply as sa
from repro_torch.kernels.build import (LAUNCHES, builds,  # noqa: F401
                                       reset_launches)

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
                     softcap=0.0, mode: str = "auto", block_k: int = 128):
    """One-token attention against a slot-batched KV cache.

    q [B, 1, H, hd]; caches [B, C, KV, hd]; pos [B] int32.  The kernel's
    cache reads scale with ``pos`` (see kernels/decode_attention.py)."""
    fn = (da.decode_attention_cuda if route(mode, q) == "kernel"
          else da.decode_attention_plain)
    kw = dict(window=window, ring=ring, softcap=softcap, block_k=block_k)
    if _PROFILER is None:
        return fn(q, k_cache, v_cache, pos, **kw)
    nb = 2 * q.nbytes + da.cache_read_bytes(
        pos.cpu(), seq_len=k_cache.shape[1], kv_heads=k_cache.shape[2],
        head_dim=k_cache.shape[3], window=window, ring=ring,
        block_k=block_k, dtype_bytes=k_cache.element_size())
    return _profiled_call("decode_attention", fn, (q, k_cache, v_cache, pos),
                          kw, nb, q.device)


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
