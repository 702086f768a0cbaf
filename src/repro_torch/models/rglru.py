"""RG-LRU recurrent block (counterpart of ``repro.models.rglru``;
RecurrentGemma / Griffin, arXiv:2402.19427).

Recurrence, per channel:
    r_t = sigmoid(W_a x_t + b_a)               (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)               (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)     (log-space decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Full sequences run the recurrence through ``ops.rglru_scan`` (the
hand-written scan kernel on the card, forward and backward), where the
JAX package uses ``lax.associative_scan``: the same f32 a and b, the
adds in sequential order.  Decode is one step (``rglru_step``).

Block layout (Griffin recurrent block):
    x -> [linear y-branch (gelu)] ---------------.
    x -> [linear x-branch] -> conv1d -> RG-LRU --*--> out proj

Parameters keep the JAX layout and are stacked ``[G, ...]`` by the model;
the functions here take one layer's row.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers

_C = 8.0


def rglru_init(cfg, *, generator, device, groups):
    """One stage's ``[groups, ...]`` RG-LRU parameters with JAX's
    distributions: Lambda from u ~ U(0.9, 0.999) (so the decay at r = 1
    is u), N(0, 0.1^2) conv taps, normal / sqrt(fan_in) projections, the
    gates at 1 / sqrt(w), the output at 1 / sqrt(w) / sqrt(2 L)."""
    d = cfg.d_model
    w = cfg.lru_width or d

    def normal(shape, std):
        return torch.randn((groups,) + shape, generator=generator,
                           device=device) * std

    u = torch.rand(groups, w, generator=generator, device=device) \
        * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / _C))   # softplus^-1
    return {
        "in_x": normal((d, w), 1 / math.sqrt(d)),
        "in_y": normal((d, w), 1 / math.sqrt(d)),
        "conv": layers.conv1d_init(cfg.conv1d_width, w, generator=generator,
                                   device=device, groups=groups),
        "gate_a": normal((w, w), 1 / math.sqrt(w)),
        "gate_x": normal((w, w), 1 / math.sqrt(w)),
        "lambda": lam,
        "out": normal((w, d), 1 / math.sqrt(w) / math.sqrt(
            2 * cfg.num_layers)),
        "b_a": torch.zeros(groups, w, device=device),
        "b_x": torch.zeros(groups, w, device=device),
    }


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus``'s
    threshold form can differ in the last bits)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(params, x):
    """(a, b) of the recurrence, both f32 [B, S, W].  The projections and
    sigmoids run in x's dtype, the decay and multiplier in f32, step for
    step as JAX's ``_gates``."""
    r = torch.sigmoid(x @ params["gate_a"].to(x.dtype)
                      + params["b_a"].to(x.dtype))
    i = torch.sigmoid(x @ params["gate_x"].to(x.dtype)
                      + params["b_x"].to(x.dtype))
    log_a = (-_C * _softplus(params["lambda"]).float()) * r.float()
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * i.float() * x.float()


def rglru_scan(params, x, h0=None):
    """x [B, S, W] -> (y [B, S, W] in x's dtype, h_last [B, W] f32)."""
    a, bx = _gates(params, x)
    if h0 is None:
        h0 = torch.zeros(a.shape[0], a.shape[2], dtype=torch.float32,
                         device=a.device)
    y, h_last = ops.rglru_scan(a, bx, h0.float())
    return y.to(x.dtype), h_last


def rglru_step(params, x_t, h):
    """Decode: x_t [B, W], h [B, W] f32 -> (y [B, W] in x's dtype, h')."""
    a, bx = _gates(params, x_t[:, None, :])
    h_new = a[:, 0] * h.float() + bx[:, 0]
    return h_new.to(x_t.dtype), h_new


def block_apply(params, x, *, mode, cache=None):
    """The Griffin recurrent block.  x [B, S, D].  ``mode``: ``decode``
    (one token; ``cache`` = {"h": [B, W] f32, "conv": [B, cw - 1, W]}),
    else a full sequence from a zero state.  Returns ``(y [B, S, D],
    new_cache)``: in ``decode`` and ``prefill`` mode the state after the
    last token (``h`` f32 from the scan, ``conv`` the last cw - 1 conv
    inputs in x's dtype, zero padding included when S < cw - 1), in
    ``train`` mode None.  The caller writes it (the model does so in
    place, for active slots only)."""
    y_branch = F.gelu(x @ params["in_y"].to(x.dtype), approximate="tanh")
    xb = x @ params["in_x"].to(x.dtype)
    if mode == "decode":
        xb, conv_state = layers.causal_conv1d(params["conv"], xb,
                                              state=cache["conv"])
        out, h = rglru_step(params, xb[:, 0], cache["h"])
        out = out[:, None, :]
        new_cache = {"h": h, "conv": conv_state}
    else:
        xb, conv_state = layers.causal_conv1d(params["conv"], xb)
        out, h = rglru_scan(params, xb)
        new_cache = {"h": h, "conv": conv_state} if mode == "prefill" \
            else None
    out = out * y_branch
    return out @ params["out"].to(x.dtype), new_cache


def init_cache(cfg, batch, *, groups, dtype=torch.bfloat16, device=None):
    """Decode state of one stage position: ``h`` [groups, batch, W] f32 and
    the conv's last inputs ``conv`` [groups, batch, cw - 1, W]."""
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros(groups, batch, w, dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(groups, batch, cfg.conv1d_width - 1, w,
                                dtype=dtype, device=device)}
