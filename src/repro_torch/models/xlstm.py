"""xLSTM blocks (counterpart of ``repro.models.xlstm``; arXiv:2405.04517):
mLSTM (matrix memory) and sLSTM.

mLSTM recurrence (per head, exp input gate, exp forget gate, stabilized):
    C_t = f_t C_{t-1} + i_t k_t v_t^T        (matrix memory [hd, hd])
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, exp(-m_t))

Full sequences use the chunkwise-parallel form (intra-chunk quadratic,
inter-chunk recurrent over the chunk grid, log-space stabilizers): a
Python loop over the chunks where JAX scans.  ``mlstm_recurrent_ref`` is
the per-step oracle of the tests.  sLSTM keeps a scalar memory per
channel with block-diagonal (per-head) recurrent gate weights, a
sequential loop over time.  Neither recurrence has a kernel in the JAX
package (both are scans and einsums), so both stay plain PyTorch.

Where PyTorch could part from JAX, the port keeps JAX's forms:

- **the stabilizers' order.** ``m0 = -inf`` (a fresh mLSTM state) is
  safe only in JAX's order: ``exp(-inf) = 0`` and ``max(., -1e30)``
  keeps ``m`` finite, while ``(m - m_new)`` first would give ``-inf -
  (-inf) = NaN``.  The gradient is NaN-free the same way;
- **ties.** ``amax`` and ``torch.maximum`` split the gradient evenly
  between tied entries, as JAX's reduce-max and ``jnp.maximum`` do
  (``Tensor.max(dim)`` would send it all to one index);
- **the state update** ``einsum("bhk,bhkd,bhke->bhde")`` is the scaled
  ``k^T`` times ``v``: one ``[hd, K] @ [K, hd]`` product per head, never
  the ``[B, H, K, hd, hd]`` outer products;
- **states stay f32**, whatever the compute dtype; a block's output is
  cast back to it;
- **the sLSTM's time loop** is eager PyTorch, so its cost is launches:
  the four gates' recurrent matrices are stacked into one batched
  product a step (each output the same dot product as JAX's per-gate
  einsum), and the input projections and their f32 cast are hoisted
  out of the loop, as JAX hoists the projections.

Block wiring (projection factor 2 for mLSTM; ``d_ff = 0``, no FFN):
    x -> RMSNorm -> up(d -> 2i), split (z, g)
         z -> per-head qkv -> mLSTM -> GN -> * silu(g) -> down(i -> d)

Parameters keep the JAX layout; the model stacks them ``[G, ...]`` and
the block functions take one layer's row.  Decode states are dicts of
the JAX tuples' leaves in their order (``MLSTM_FRESH``, ``SLSTM_FRESH``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers

# A fresh decode state: each leaf's name, in JAX's tuple order, and the
# value it starts from.  ``init_cache`` and the server's slot reset both
# read these.
MLSTM_FRESH = {"C": 0.0, "n": 0.0, "m": float("-inf")}
SLSTM_FRESH = {"c": 0.0, "n": 1e-6, "m": -1e30, "h": 0.0}
_M_FLOOR = -1e30


def _log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)`` with softplus as
    ``logaddexp(x, 0)``."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


def _floor(m):
    """``jnp.maximum(m, -1e30)``: the even gradient split at a tie."""
    return torch.maximum(m, m.new_tensor(_M_FLOOR))


def _as_tuple(state, fresh):
    return tuple(state[k] for k in fresh)


def _as_dict(state, fresh):
    return dict(zip(fresh, state))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(cfg, *, generator, device, groups):
    """One stage's ``[groups, ...]`` mLSTM parameters with JAX's
    distributions: ``w_up`` N(0, 1/d), ``wq`` / ``wk`` / ``wv`` N(0, 1) /
    sqrt(hd), ``w_if`` 0.02 N(0, 1), ``b_i = -2`` (a small input gate),
    ``b_f = +3`` (the forget gate near 1), ``w_down`` N(0, 1) / sqrt(i) /
    sqrt(2 L), zero norm scales."""
    d, H = cfg.d_model, cfg.num_heads
    i = 2 * d
    hd = i // H

    def normal(shape, std):
        return torch.randn((groups,) + shape, generator=generator,
                           device=device) * std

    s = 1.0 / math.sqrt(hd)
    return {
        "norm": {"scale": torch.zeros(groups, d, device=device)},
        "w_up": normal((d, 2 * i), 1.0 / math.sqrt(d)),
        "wq": normal((H, hd, hd), s),
        "wk": normal((H, hd, hd), s),
        "wv": normal((H, hd, hd), s),
        "w_if": normal((d, 2 * H), 0.02),
        "b_i": torch.full((groups, H), -2.0, device=device),
        "b_f": torch.full((groups, H), 3.0, device=device),
        "gn": {"scale": torch.zeros(groups, i, device=device)},
        "w_down": normal((i, d), 1.0 / math.sqrt(i)
                         / math.sqrt(2 * cfg.num_layers)),
    }


def _mlstm_qkvg(params, x):
    """x [B, S, D] -> q, k, v [B, S, H, hd], log-gates li, lf [B, S, H]
    (f32), the output gate g and the inner width i."""
    B, S, D = x.shape
    xn = layers.rms_norm(params["norm"], x)
    u = xn @ params["w_up"].to(x.dtype)                 # [B, S, 2i]
    i_dim = u.shape[-1] // 2
    z, g = u[..., :i_dim], u[..., i_dim:]
    H = params["wq"].shape[0]
    hd = i_dim // H
    zh = z.reshape(B, S, H, hd)
    q, k, v = (torch.einsum("bshd,hde->bshe", zh, params[n].to(x.dtype))
               for n in ("wq", "wk", "wv"))
    gates = (xn @ params["w_if"].to(x.dtype)).float()
    li = gates[..., :H] + params["b_i"]                 # log input gate
    lf = _log_sigmoid(gates[..., H:] + params["b_f"])   # log forget, < 0
    return q, k, v, li, lf, g, i_dim


def mlstm_chunkwise(q, k, v, li, lf, *, chunk=256, state=None):
    """Chunkwise-parallel stabilized mLSTM.

    q, k, v [B, S, H, hd]; li, lf [B, S, H] log gates (f32).  ``state``:
    optional ``(C [B, H, hd, hd], n [B, H, hd], m [B, H])``.  Returns
    ``(h [B, S, H, hd] in q's dtype, final state)``.  ``S`` must be a
    multiple of the chunk (JAX asserts it)."""
    B, S, H, hd = q.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mlstm_chunkwise: S = {S} is not a multiple of "
                         f"the chunk {chunk}")
    nc = S // chunk
    scale = 1.0 / math.sqrt(hd)

    def chunks(a):                  # [B, S, H, ...] -> [B, H, nc, K, ...]
        a = a.reshape((B, nc, chunk, H) + a.shape[3:])
        return a.permute((0, 3, 1, 2) + tuple(range(4, a.dim())))

    qc, kc, vc, lic = chunks(q), chunks(k), chunks(v), chunks(li)
    b = torch.cumsum(chunks(lf), dim=-1)   # cumulative log-decay incl. j
    if state is None:
        C = torch.zeros(B, H, hd, hd, dtype=torch.float32, device=q.device)
        n = torch.zeros(B, H, hd, dtype=torch.float32, device=q.device)
        m = torch.full((B, H), float("-inf"), dtype=torch.float32,
                       device=q.device)
    else:
        C, n, m = state
    idx = torch.arange(chunk, device=q.device)
    tri = idx[:, None] >= idx[None, :]      # [K, K] causal within chunk
    neg_inf = torch.tensor(float("-inf"), device=q.device)

    hs = []
    for c in range(nc):
        qj, kj, vj = qc[:, :, c], kc[:, :, c], vc[:, :, c]   # [B, H, K, hd]
        lij, bj = lic[:, :, c], b[:, :, c]                   # [B, H, K]
        # stabilizers
        m_inter = m[..., None] + bj
        intra_log = lij[..., None, :] + bj[..., :, None] - bj[..., None, :]
        intra_log = torch.where(tri, intra_log, neg_inf)     # [B, H, K, K]
        m_intra = intra_log.amax(-1)
        mj = _floor(torch.maximum(m_inter, m_intra))

        # inter-chunk contribution
        w_inter = torch.exp(m_inter - mj)
        qf = qj.float() * scale
        h_inter = (qf @ C) * w_inter[..., None]
        n_inter = (qf @ n[..., None])[..., 0] * w_inter

        # intra-chunk contribution
        sc = torch.exp(intra_log - mj[..., None])
        a = sc * (qf @ kj.float().transpose(-1, -2))
        h_intra = a @ vj.float()
        n_intra = a.sum(-1)

        denom = torch.maximum(torch.abs(n_inter + n_intra), torch.exp(-mj))
        hs.append((h_inter + h_intra) / denom[..., None])

        # state update to the end of the chunk
        Bc = bj[..., -1]
        m_state_cand = (lij + Bc[..., None] - bj).amax(-1)
        m_new = _floor(torch.maximum(m + Bc, m_state_cand))
        w_old = torch.exp(m + Bc - m_new)
        wk_ = torch.exp(lij + Bc[..., None] - bj - m_new[..., None])
        kf, vf = kj.float(), vj.float()
        C = C * w_old[..., None, None] + (
            kf * wk_[..., None]).transpose(-1, -2) @ vf
        n = n * w_old[..., None] + (wk_[..., None, :] @ kf)[..., 0, :]
        m = m_new

    # [B, H, nc, K, hd] -> [B, S, H, hd]
    h = torch.stack(hs, dim=2).reshape(B, H, S, hd).transpose(1, 2)
    return h.to(q.dtype), (C, n, m)


def mlstm_step(q, k, v, li, lf, state):
    """One decode step.  q, k, v [B, H, hd]; li, lf [B, H]; ``state`` a
    ``(C, n, m)`` tuple.  Returns ``(h [B, H, hd] in q's dtype, state)``."""
    C, n, m = state
    scale = 1.0 / math.sqrt(q.shape[-1])
    m_new = _floor(torch.maximum(lf + m, li))
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    kf, vf, qf = k.float(), v.float(), q.float()
    C_new = C * fw[..., None, None] + iw[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n_new = n * fw[..., None] + iw[..., None] * kf
    qs = qf * scale
    num = (qs[..., None, :] @ C_new)[..., 0, :]
    den = torch.maximum(torch.abs((qs * n_new).sum(-1)), torch.exp(-m_new))
    h = num / den[..., None]
    return h.to(q.dtype), (C_new, n_new, m_new)


def mlstm_recurrent_ref(q, k, v, li, lf, state=None):
    """Per-step oracle (tests).  Shapes as ``mlstm_chunkwise``."""
    B, S, H, hd = q.shape
    if state is None:
        state = (torch.zeros(B, H, hd, hd, device=q.device),
                 torch.zeros(B, H, hd, device=q.device),
                 torch.full((B, H), float("-inf"), device=q.device))
    hs = []
    for t in range(S):
        h, state = mlstm_step(q[:, t], k[:, t], v[:, t], li[:, t], lf[:, t],
                              state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def mlstm_block_apply(params, x, *, mode, cache=None, chunk=256):
    """The mLSTM block, x [B, S, D] -> ``(y [B, S, D], new_cache)``.
    ``decode``: one token from ``cache`` (``{"C", "n", "m"}``); else a
    full sequence from ``cache`` (None: a fresh state), whose final state
    is returned in ``prefill`` mode only.  The caller adds the residual."""
    B, S, D = x.shape
    q, k, v, li, lf, g, i_dim = _mlstm_qkvg(params, x)
    state = None if cache is None else _as_tuple(cache, MLSTM_FRESH)
    if mode == "decode":
        h, st = mlstm_step(q[:, 0], k[:, 0], v[:, 0], li[:, 0], lf[:, 0],
                           state)
        h = h[:, None]
        new_cache = _as_dict(st, MLSTM_FRESH)
    else:
        h, st = mlstm_chunkwise(q, k, v, li, lf, chunk=min(chunk, S),
                                state=state)
        new_cache = _as_dict(st, MLSTM_FRESH) if mode == "prefill" else None
    hflat = layers.rms_norm(params["gn"], h.reshape(B, -1, i_dim))
    out = (hflat * (g * torch.sigmoid(g))) @ params["w_down"].to(x.dtype)
    return out, new_cache


def mlstm_init_cache(cfg, batch, *, groups, device=None):
    """A fresh mLSTM state for ``groups`` layers: ``C`` [G, batch, H, hd,
    hd], ``n`` [G, batch, H, hd], ``m`` [G, batch, H], all f32."""
    H = cfg.num_heads
    hd = (2 * cfg.d_model) // H
    shapes = {"C": (H, hd, hd), "n": (H, hd), "m": (H,)}
    return {k: torch.full((groups, batch) + shapes[k], v,
                          dtype=torch.float32, device=device)
            for k, v in MLSTM_FRESH.items()}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

_SLSTM_GATES = ("i", "f", "z", "o")


def slstm_init(cfg, *, generator, device, groups):
    """One stage's ``[groups, ...]`` sLSTM parameters with JAX's
    distributions: ``w_*`` 0.02 N(0, 1), ``r_*`` N(0, 1) / sqrt(hd),
    ``b_f = 3`` and the other biases 0, ``w_down`` N(0, 1) / sqrt(d) /
    sqrt(2 L), zero norm scales."""
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H

    def normal(shape, std):
        return torch.randn((groups,) + shape, generator=generator,
                           device=device) * std

    p = {"norm": {"scale": torch.zeros(groups, d, device=device)},
         "gn": {"scale": torch.zeros(groups, d, device=device)}}
    for gate in _SLSTM_GATES:
        p[f"w_{gate}"] = normal((d, d), 0.02)
        p[f"r_{gate}"] = normal((H, hd, hd), 1.0 / math.sqrt(hd))
        p[f"b_{gate}"] = torch.full((groups, d), 3.0 if gate == "f" else 0.0,
                                    device=device)
    p["w_down"] = normal((d, d), 1.0 / math.sqrt(d)
                         / math.sqrt(2 * cfg.num_layers))
    return p


def _stack_recurrent(params):
    """The four gates' recurrent matrices as one f32 ``[H, hd, 4 hd]``
    operand (i, f, z, o) and their biases as ``[4, D]``: one batched
    product a time step in place of four einsums, each output still the
    same length-``hd`` dot product."""
    H, hd, _ = params["r_i"].shape
    r = torch.stack([params[f"r_{g}"].float() for g in _SLSTM_GATES], dim=2)
    b = torch.stack([params[f"b_{g}"] for g in _SLSTM_GATES])
    return r.reshape(H, hd, 4 * hd), b


def _slstm_cell(params, xt, state, H, *, wx=None, stacked=None):
    """xt [B, D]; ``state`` ``(c, n, m, h)`` each [B, D] f32.

    ``wx``: optional precomputed input projections [B, 4, D] (i, f, z,
    o): the sequence path hoists them out of the time loop (one matmul
    instead of 4 per step); decode projects ``xt`` gate by gate.  The
    recurrent product runs in f32 each step.  ``stacked``: the
    ``_stack_recurrent`` operands, which the sequence path builds once
    (None: built here)."""
    c, n, m, h = state
    B, D = xt.shape
    hd = D // H
    r, b = stacked if stacked is not None else _stack_recurrent(params)
    if wx is None:
        wx = torch.stack([xt @ params[f"w_{g}"].to(xt.dtype)
                          for g in _SLSTM_GATES], dim=1)
    rec = torch.bmm(h.reshape(B, H, hd).transpose(0, 1), r)  # [H, B, 4 hd]
    rec = rec.reshape(H, B, 4, hd).permute(1, 2, 0, 3).reshape(B, 4, D)
    it, ft, zt, ot = (wx.float() + rec + b).unbind(1)
    lf = _log_sigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(lf + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(zt)
    n_new = torch.maximum(f_p * n + i_p, n.new_tensor(1e-6))
    h_new = torch.sigmoid(ot) * (c_new / n_new)
    return (c_new, n_new, m_new, h_new), h_new


def slstm_block_apply(params, x, cfg, *, mode, cache=None):
    """The sLSTM block, x [B, S, D] -> ``(y [B, S, D], new_cache)``;
    ``cache`` ``{"c", "n", "m", "h"}`` (None: a fresh state).  Modes as
    ``mlstm_block_apply``."""
    B, S, D = x.shape
    H = cfg.num_heads
    xn = layers.rms_norm(params["norm"], x)
    if cache is None:
        cache = {k: a[0] for k, a in slstm_init_cache(
            cfg, B, groups=1, device=x.device).items()}
    state = _as_tuple(cache, SLSTM_FRESH)
    if mode == "decode":
        st, h = _slstm_cell(params, xn[:, 0], state, H)
        hs = h[:, None]
        new_cache = _as_dict(st, SLSTM_FRESH)
    else:
        # the 4 input projections, their f32 cast and the stacked
        # recurrent operands hoisted out of the time loop
        wx_all = torch.stack([xn @ params[f"w_{g}"].to(xn.dtype)
                              for g in _SLSTM_GATES], dim=2).float()
        stacked = _stack_recurrent(params)
        out = []
        for t in range(S):
            state, h = _slstm_cell(params, xn[:, t], state, H,
                                   wx=wx_all[:, t], stacked=stacked)
            out.append(h)
        hs = torch.stack(out, dim=1)
        new_cache = _as_dict(state, SLSTM_FRESH) if mode == "prefill" \
            else None
    hs = layers.rms_norm(params["gn"], hs.to(x.dtype))
    return hs @ params["w_down"].to(x.dtype), new_cache


def slstm_init_cache(cfg, batch, *, groups, device=None):
    """A fresh sLSTM state for ``groups`` layers: ``c``, ``n``, ``m``,
    ``h`` each [G, batch, D] f32."""
    return {k: torch.full((groups, batch, cfg.d_model), v,
                          dtype=torch.float32, device=device)
            for k, v in SLSTM_FRESH.items()}
