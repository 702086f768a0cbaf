"""Mixture-of-Experts feed-forward (counterpart of ``repro.models.moe``).

GShard-style capacity dispatch: a softmax router, the top-k experts of
each token, a capacity ``C = max(8, ceil(k * T * capacity_factor / E))``
per token chunk, and (token, slot) pairs past an expert's capacity
dropped, as in the JAX package.  The expert products are batched
matmuls (``torch.bmm``, where JAX leaves its einsums to XLA); dispatch
and combine are plain tensor code.

Where the two packages could part, the port copies JAX's choices:

- **top-k order.** ``lax.top_k`` puts the lower expert index first
  among equal probabilities (common when bf16 router logits tie); the
  port takes a stable descending sort cut to k, which gives the same
  order on the CPU and on the card.  The order inside the top k sets
  the ranks, hence the drops and the order of the combine's adds;
- **ranks and drops.** ``rank`` is the exclusive cumsum of the one-hot
  over the flattened ``[T * k]`` (token, slot) order; pairs with
  ``rank >= C`` are dropped, and a dropped slot reads row
  ``min(rank, C - 1)`` at weight 0.  Empty capacity slots gather the
  zero row ``T``;
- **the combine** adds the k slots one at a time in x's dtype;
- **every row routes.** Padding and idle slots' rows take capacity
  exactly like real tokens (the JAX server feeds them too), so a
  prompt's rows can depend on what it was batched with (ROADMAP C).

Both gathers have backward passes without atomics, so a rerun on the
card gives the same gradient bits: the dispatch's gradient of a token
is the sum of its kept slots' rows, added in slot order
(``_Dispatch``), and the combine's gradient lands on rows that at most
one kept pair reads (``_GatherUnique``).

Chunks of ``token_chunk`` tokens run under ``torch.utils.checkpoint``
when a gradient is taken (JAX's rematerialized scan); the aux loss is
averaged over the chunks.  ``tp_group`` (JAX's ``tp_axis``): the
expert weights are this rank's model-axis shards; the experts read the
tokens through Megatron's f, and one all-reduce over the model group
(g) sums the routed experts' partial outputs, with the shared expert's
folded in, before the combine (``runtime/moe_parallel.py``).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.runtime import shard_ctx


def moe_init(cfg, *, generator, device, groups):
    """One stage's ``[groups, ...]`` MoE parameters with JAX's
    distributions: the router N(0, 0.02^2), ``w_gate`` / ``w_up``
    N(0, 1/d), ``w_down`` N(0, 1) / sqrt(f) / sqrt(2 L), and a shared
    SwiGLU expert of ``shared_expert_d_ff`` as the dense MLP."""
    d, E, f, L = cfg.d_model, cfg.num_experts, cfg.moe_d_ff, cfg.num_layers

    def normal(shape, std):
        return torch.randn((groups,) + shape, generator=generator,
                           device=device) * std

    p = {"router": normal((d, E), 0.02),
         "w_gate": normal((E, d, f), 1 / math.sqrt(d)),
         "w_up": normal((E, d, f), 1 / math.sqrt(d)),
         "w_down": normal((E, f, d), 1 / math.sqrt(f) / math.sqrt(2 * L))}
    sf = cfg.shared_expert_d_ff
    if sf:
        p["shared"] = {"w_gate": normal((d, sf), 1 / math.sqrt(d)),
                       "w_up": normal((d, sf), 1 / math.sqrt(d)),
                       "w_down": normal((sf, d), 1 / math.sqrt(sf)
                                        / math.sqrt(2 * L))}
    return p


def _capacity(T: int, cfg) -> int:
    """Per-expert capacity of a chunk of ``T`` tokens (JAX ``_capacity``)."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    return max(8, int(math.ceil(k * T * cfg.capacity_factor / E)))


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` of the last axis: the k largest values, the lower
    index first among equal ones.  Returns ``(values, indices)``."""
    _, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return probs.gather(-1, idx), idx


class _Dispatch(torch.autograd.Function):
    """``xe = [xt; 0][disp]``: each expert's capacity rows (the zero row
    ``T`` where a slot is empty).  Backward: a token's gradient is the
    sum of the rows of its kept slots, added in slot order (``src``
    [T, k] holds each slot's row in ``[E * C]``, ``E * C`` where it was
    dropped), so no two writes meet and no atomics are needed."""

    @staticmethod
    def forward(ctx, xt, disp, src):
        ctx.save_for_backward(src)
        xpad = torch.cat([xt, xt.new_zeros(1, xt.shape[1])])
        return xpad[disp]

    @staticmethod
    def backward(ctx, g):
        (src,) = ctx.saved_tensors
        D = g.shape[-1]
        gpad = torch.cat([g.reshape(-1, D), g.new_zeros(1, D)])
        dx = torch.zeros(src.shape[0], D, dtype=g.dtype, device=g.device)
        for j in range(src.shape[1]):
            dx = dx + gpad[src[:, j]]
        return dx, None, None


class _GatherUnique(torch.autograd.Function):
    """``src[read]`` whose gradient rows go to ``write``: each read row's
    own row, or the discarded row ``N`` for reads whose weight is zero
    (dropped pairs).  Kept pairs never share a row, so the backward is a
    plain copy with no atomics."""

    @staticmethod
    def forward(ctx, src, read, write):
        ctx.save_for_backward(write)
        ctx.n = src.shape[0]
        return src[read]

    @staticmethod
    def backward(ctx, g):
        (write,) = ctx.saved_tensors
        out = g.new_zeros(ctx.n + 1, g.shape[-1])
        out.index_copy_(0, write, g)
        return out[:ctx.n], None, None


class RouteLog:
    """What the routed chunks did while a ``route_log()`` is open:
    ``pairs`` (token, slot) pairs routed, ``dropped`` of them past
    capacity (a device tensor, added without a host sync), and with
    ``keep_routes`` each chunk's ``(topi, keep, probs)`` on the host."""

    def __init__(self, keep_routes: bool = False):
        self.keep_routes = keep_routes
        self.pairs = 0
        self._dropped = None
        self.routes = []

    def add(self, topi, keep, probs):
        self.pairs += keep.numel()
        n = (~keep).sum()
        self._dropped = n if self._dropped is None else self._dropped + n
        if self.keep_routes:
            self.routes.append((topi.cpu(), keep.cpu(),
                                probs.detach().float().cpu()))

    @property
    def dropped(self) -> int:
        return 0 if self._dropped is None else int(self._dropped)


_LOG: Optional[RouteLog] = None


@contextmanager
def route_log(keep_routes: bool = False):
    """Record the routes of every ``moe_apply`` chunk in this block."""
    global _LOG
    prev, _LOG = _LOG, RouteLog(keep_routes)
    try:
        yield _LOG
    finally:
        _LOG = prev


def _moe_chunk(params, xt, cfg, C, with_aux, tp_group=False):
    """One token chunk: xt [T, D] -> (y [T, D], aux, topi, keep, probs);
    ``aux`` None unless ``with_aux``.  ``tp_group``: the experts are
    model-axis shards (see ``moe_apply``)."""
    T, D = xt.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = (xt @ params["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                         # [T, E]
    topw, topi = top_k(probs, k)                                  # [T, k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # rank of each (token, slot) within its expert, over the flattened
    # [T * k] order
    flat_e = topi.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(E, device=xt.device)).long()
    flat_r = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, flat_e[:, None])[:, 0]
    flat_k = flat_r < C
    rank, keep = flat_r.reshape(T, k), flat_k.reshape(T, k)

    # load-balancing auxiliary loss (Switch-style); the counts carry no
    # gradient, the mean probabilities do
    aux = None
    if with_aux:
        me = probs.mean(0)
        ce = onehot.sum(0).float() / (T * k)
        aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    # dispatch: expert e's capacity row c holds the token of rank c
    # (dropped pairs go to a discarded column C); empty rows read row T
    token_id = torch.arange(T * k, device=xt.device) // k
    disp = torch.full((E, C + 1), T, dtype=torch.long, device=xt.device)
    disp.view(-1).scatter_(0, flat_e * (C + 1) + flat_r.clamp(max=C),
                           torch.where(flat_k, token_id,
                                       torch.full_like(token_id, T)))
    disp = disp[:, :C].reshape(-1)
    own = torch.where(keep, topi * C + rank, torch.full_like(rank, E * C))
    # expert tensor parallelism: the experts read the tokens through f
    # and their partial outputs (with a split shared expert's) are summed
    # over the model group in one all-reduce (g) before the combine, so
    # the routing weights' gradient is whole on every rank
    xin = shard_ctx.constrain(xt, "block_in") if tp_group else xt
    xe = _Dispatch.apply(xin, disp, own).reshape(E, C, D)
    h = torch.bmm(xe, params["w_gate"].to(xe.dtype))
    u = torch.bmm(xe, params["w_up"].to(xe.dtype))
    ye = torch.bmm(F.silu(h) * u, params["w_down"].to(xe.dtype))
    shared = None
    if tp_group:
        sh = params.get("shared")
        if sh is not None and shard_ctx.tp_split(sh["w_down"].shape[-2],
                                                 cfg.shared_expert_d_ff):
            both = shard_ctx.constrain(torch.cat(
                [ye.reshape(E * C, D),
                 layers.mlp_apply(sh, xin, "swiglu")]), "residual")
            ye, shared = both[:E * C].reshape(E, C, D), both[E * C:]
        else:
            ye = shard_ctx.constrain(ye, "residual")

    # combine: the k slots one at a time, in x's dtype
    read = (topi * C + rank.clamp(max=C - 1)).reshape(-1)
    picked = _GatherUnique.apply(ye.reshape(E * C, D), read,
                                 own.reshape(-1)).reshape(T, k, D)
    y = torch.zeros(T, D, dtype=xt.dtype, device=xt.device)
    for j in range(k):
        wj = torch.where(keep[:, j], topw[:, j],
                         torch.zeros_like(topw[:, j])).to(xt.dtype)
        y = y + picked[:, j] * wj[:, None]

    if "shared" in params:
        y = y + (layers.mlp_apply(params["shared"], xt, "swiglu")
                 if shared is None else shared)
    return y, aux, topi, keep, probs


def moe_apply(params, x, cfg, *, capacity=None, token_chunk=8192,
              with_aux=True, tp_group=False):
    """x [B, S, D] -> (y [B, S, D], aux loss f32 scalar, or None without
    ``with_aux``: serving steps, which would throw it away).

    Tokens are flattened and processed in chunks (the largest divisor of
    T up to ``token_chunk``); capacity is per chunk.  With a gradient
    each chunk is recomputed in the backward pass when T spans more than
    one chunk, as JAX's checkpointed scan."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    chunk = min(token_chunk, T)
    while T % chunk:
        chunk -= 1
    C = capacity if capacity else _capacity(chunk, cfg)
    n = T // chunk
    remat = n > 1 and torch.is_grad_enabled()
    ys, aux = [], None
    for i in range(n):
        xc = xt[i * chunk:(i + 1) * chunk]
        if remat:
            out = torch.utils.checkpoint.checkpoint(
                lambda a: _moe_chunk(params, a, cfg, C, with_aux, tp_group),
                xc, use_reentrant=False)
        else:
            out = _moe_chunk(params, xc, cfg, C, with_aux, tp_group)
        y, a, topi, keep, probs = out
        if _LOG is not None:
            _LOG.add(topi, keep, probs)
        ys.append(y)
        if with_aux:
            aux = a if aux is None else aux + a
    y = ys[0] if n == 1 else torch.cat(ys)
    if with_aux and n > 1:
        aux = aux / n
    return y.reshape(B, S, D), aux


def moe_apply_dense_ref(params, x, cfg):
    """Exact dense reference: every expert on every token (tests only;
    equals ``moe_apply`` when no pair is dropped)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    logits = (xt @ params["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, cfg.num_experts_per_tok)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    gate = torch.zeros_like(probs).scatter(1, topi, topw)
    h = torch.einsum("td,edf->etf", xt, params["w_gate"].to(xt.dtype))
    u = torch.einsum("td,edf->etf", xt, params["w_up"].to(xt.dtype))
    ye = torch.einsum("etf,efd->etd", F.silu(h) * u,
                      params["w_down"].to(xt.dtype))
    y = torch.einsum("te,etd->td", gate.to(xt.dtype), ye)
    if "shared" in params:
        y = y + layers.mlp_apply(params["shared"], xt, "swiglu")
    return y.reshape(B, S, D), torch.zeros((), dtype=torch.float32,
                                           device=x.device)
