"""The port's RG-LRU pieces against the JAX package: the scan kernel's
plain version, the differentiable scan op, the causal conv and the
recurrent block.

Inputs are made with numpy from a seed and given to both packages; block
parameters come from JAX's ``rglru_init`` through ``repro_torch.interop``.
Tolerances, and why:

- the plain scan against the TPU kernel in interpret mode
  (``rglru_scan_kernel(..., interpret=True)``) and JAX's oracle
  ``rglru_ref``: atol 1e-6.  Not bitwise: on the CPU, XLA contracts
  ``a_t * h + b_t`` into one fused multiply-add (both JAX results equal
  an f64-emulated FMA bit for bit), while the port rounds the product
  and the sum on their own, as its CUDA kernel does (measured: at most
  1.8e-7 apart, which near zero is up to 20 210 ulp), and past
  ``SCAN_CHUNK`` steps the port's scan is a chunked one (carries
  P_k * c_k + H_k between chunks), which rounds otherwise again.  The
  port's plain version equals its own sequential oracle bitwise up to
  ``SCAN_CHUNK`` steps, and within atol 1e-6 past it;
- the plain backward (``rglru_scan_bwd_plain``) bitwise the composite
  formula it replaces (shifted copies, the reversed scan, the product),
  and against JAX's custom VJP at atol 1e-4;
- gradients through ``ops.rglru_scan`` against JAX's custom VJP
  (``ops.rglru_scan(a, b, h0, True)``): atol 1e-4, the tolerance of
  ``tests/test_kernels.py::test_rglru_kernel_grad`` (in practice equal
  but for the last bits of the loss's reduction);
- the causal conv in f32: rtol 1e-6 / atol 1e-6 (the 4-tap contraction
  may sum in another order);
- the block in f32 against JAX (train mode: the associative scan against
  the sequential one; decode: the same step): rtol 1e-4 / atol 2e-5,
  the model tolerance of ``tests/test_torch_model.py``;
- the port's scan against its own decode steps: atol 2e-5, as
  ``tests/test_models.py::test_rglru_scan_vs_step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro.kernels import ops as jops
from repro.kernels.ref import rglru_ref as jrglru_ref
from repro.kernels.rglru_scan import rglru_scan_kernel
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro_torch import interop
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels.ref import rglru_ref
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=2e-5)


def _scan_inputs(B, S, W, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0.8, 0.999, (B, S, W)).astype(np.float32)
    b = (rng.randn(B, S, W) * 0.1).astype(np.float32)
    h0 = (rng.randn(B, W) * 0.1).astype(np.float32)
    return a, b, h0


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


L = rs.SCAN_CHUNK


@pytest.mark.parametrize("B,S,W", [(1, 64, 128), (2, 96, 192), (1, 33, 130)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_plain_scan_matches_interpret_kernel(B, S, W, with_h0):
    """At ``tests/test_kernels.py``'s shapes, with and without h0 (the
    JAX kernel takes zeros for none), all past one chunk: within atol 1e-6
    of it and of the port's own sequential oracle."""
    a, b, h0 = _scan_inputs(B, S, W)
    if not with_h0:
        h0 = np.zeros_like(h0)
    jy, jh = rglru_scan_kernel(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(h0), block_t=32, block_w=64,
                               interpret=True)
    ty, th = rs.rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(h0) if with_h0 else None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-6)
    ry, rh = rglru_ref(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(h0))
    jry, jrh = jrglru_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    np.testing.assert_allclose(ty.numpy(), ry.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(th.numpy(), rh.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("S", [1, 7, L])
@pytest.mark.parametrize("with_h0", [True, False])
def test_plain_scan_up_to_one_chunk_is_sequential_bitwise(S, with_h0):
    """Up to ``SCAN_CHUNK`` steps the chunked scan is the sequential one:
    bitwise the port's oracle ``rglru_ref``, within 1e-6 of JAX's."""
    a, b, h0 = _scan_inputs(2, S, 40, seed=11)
    if not with_h0:
        h0 = np.zeros_like(h0)
    ty, th = rs.rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(h0) if with_h0 else None)
    ry, rh = rglru_ref(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(h0))
    np.testing.assert_array_equal(_bits(ty.numpy()), _bits(ry.numpy()))
    np.testing.assert_array_equal(_bits(th.numpy()), _bits(rh.numpy()))
    jry, _ = jrglru_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jry), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("S", [L + 1, 3 * L + 5, 9 * L + 3])
@pytest.mark.parametrize("W", [40, 70])
def test_chunked_scan_matches_jax(S, W):
    """Past one chunk (a ragged last chunk; 9L + 3 steps run two groups
    of 8 chunks in the kernel) and at widths that are not a multiple of
    32: against the TPU kernel in interpret mode and JAX's ``rglru_ref``,
    and against the port's sequential oracle, at atol 1e-6."""
    a, b, h0 = _scan_inputs(2, S, W, seed=S + W)
    ty, th = rs.rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(h0))
    jy, jh = rglru_scan_kernel(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(h0), block_t=32, block_w=64,
                               interpret=True)
    jry, jrh = jrglru_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    ry, rh = rglru_ref(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(h0))
    for want_y, want_h in ((jy, jh), (jry, jrh), (ry, rh)):
        np.testing.assert_allclose(ty.numpy(), np.asarray(want_y), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(th.numpy(), np.asarray(want_h), rtol=0,
                                   atol=1e-6)
    assert torch.equal(th, ty[:, -1])
    assert ty.is_contiguous()     # the kernels take it as it comes


@pytest.mark.parametrize("S", [5, 3 * L + 5])
def test_negative_zero_keeps_its_bits(S):
    """A run of -0 states stays -0 through the chunk carries and the
    identity padding (a = 1, b = -0) of a ragged last chunk, as in the
    sequential oracle."""
    a = torch.full((2, S, 40), 0.9)
    b = torch.full_like(a, -0.0)
    h0 = torch.full((2, 40), -0.0)
    for reverse in (False, True):
        y, h = rs.rglru_scan_plain(a, b, h0, reverse=reverse)
        assert torch.signbit(y).all() and torch.signbit(h).all()
    ry, rh = rglru_ref(a, b, h0)
    y, h = rs.rglru_scan_plain(a, b, h0)
    np.testing.assert_array_equal(_bits(y.numpy()), _bits(ry.numpy()))
    np.testing.assert_array_equal(_bits(h.numpy()), _bits(rh.numpy()))


def test_reversed_scan_equals_flipped_scan_bitwise():
    """``reverse=True`` takes the place of the two flips of JAX's
    backward: the same bits."""
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(2, 37, 48, 3))
    ry, rh = rs.rglru_scan_plain(a, b, h0, reverse=True)
    fy, fh = rs.rglru_scan_plain(a.flip(1), b.flip(1), h0)
    assert torch.equal(ry, fy.flip(1)) and torch.equal(rh, fh)


@pytest.mark.parametrize("S", [L - 3, 3 * L + 5, 9 * L + 3])
@pytest.mark.parametrize("need_dh0", [True, False])
def test_bwd_plain_equals_composite_bitwise(S, need_dh0):
    """``rglru_scan_bwd_plain`` against the composite it stands for, the
    backward of ``repro.kernels.ops._rg_bwd`` written out: a shifted one
    step (0 at the end), dy copied with dh_last added at the last step,
    the reversed scan from zeros, y shifted (h0 first), the products.
    Its reversed scan counts chunks from t = S - 1: the flipped forward
    scan of the flipped inputs."""
    B, W = 2, 40
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(B, S, W, S))
    rng = np.random.RandomState(S + 1)
    dy = torch.from_numpy(rng.randn(B, S, W).astype(np.float32))
    dh_last = torch.from_numpy(rng.randn(B, W).astype(np.float32))
    y, _ = rs.rglru_scan_plain(a, b, h0)
    da, db, dh0 = rs.rglru_scan_bwd_plain(a, y, h0, dy, dh_last,
                                          need_dh0=need_dh0)
    a_next = torch.cat([a[:, 1:], torch.zeros(B, 1, W)], dim=1)
    dy2 = dy.clone()
    dy2[:, -1] = dy2[:, -1] + dh_last
    lam, _ = rs.rglru_scan_plain(a_next, dy2, None, reverse=True)
    flam, _ = rs.rglru_scan_plain(a_next.flip(1), dy2.flip(1), None)
    assert torch.equal(lam, flam.flip(1))
    y_prev = torch.cat([h0[:, None], y[:, :-1]], dim=1)
    assert torch.equal(db, lam)
    assert torch.equal(da, lam * y_prev)
    if need_dh0:
        assert torch.equal(dh0, lam[:, 0] * a[:, 0])
    else:
        assert dh0 is None


@pytest.mark.parametrize("S", [L + 1, 3 * L + 5])
def test_bwd_plain_matches_jax_vjp(S):
    """``rglru_scan_bwd_plain`` against JAX's custom VJP around the TPU
    kernel in interpret mode, given the same cotangents: atol 1e-4."""
    B, W = 2, 40
    a, b, h0 = _scan_inputs(B, S, W, seed=S + 2)
    rng = np.random.RandomState(S + 3)
    dy = rng.randn(B, S, W).astype(np.float32)
    dh_last = rng.randn(B, W).astype(np.float32)
    (jy, _), vjp = jax.vjp(lambda a, b, h0: jops.rglru_scan(a, b, h0, True),
                           jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    jg = vjp((jnp.asarray(dy), jnp.asarray(dh_last)))
    ta, th0 = torch.from_numpy(a), torch.from_numpy(h0)
    y, _ = rs.rglru_scan_plain(ta, torch.from_numpy(b), th0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
    tg = rs.rglru_scan_bwd_plain(ta, y, th0, torch.from_numpy(dy),
                                 torch.from_numpy(dh_last))
    for name, g, j in zip(("da", "db", "dh0"), tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("B,S,W", [(1, 48, 64), (2, 33, 40)])
def test_scan_op_grads_match_jax_vjp(B, S, W):
    """The port's autograd Function (plain directions on the CPU) against
    JAX's custom VJP around the TPU kernel in interpret mode, on the loss
    of ``tests/test_kernels.py::test_rglru_kernel_grad``."""
    a, b, h0 = _scan_inputs(B, S, W, seed=1)

    def jloss(a, b, h0):
        y, hN = jops.rglru_scan(a, b, h0, True)
        return (y ** 2).sum() + (hN ** 2).sum()

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    ts = [torch.from_numpy(x).requires_grad_() for x in (a, b, h0)]
    y, hN = ops.rglru_scan(*ts)
    tl = (y ** 2).sum() + (hN ** 2).sum()
    tg = torch.autograd.grad(tl, ts)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    for name, g, j in zip(("da", "db", "dh0"), tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-4,
                                   err_msg=name)


def test_scan_op_mode_dispatch():
    """``auto`` on a CPU tensor is the plain version in both directions
    and launches nothing; ``kernel`` on a CPU tensor raises; ``plain``
    runs anywhere; the CUDA wrappers refuse CPU tensors."""
    a, b, h0 = (torch.from_numpy(x).requires_grad_()
                for x in _scan_inputs(1, 9, 16))
    ops.reset_launches()
    y, h = ops.rglru_scan(a, b, h0)
    yp, hp = ops.rglru_scan(a, b, h0, mode="plain")
    assert torch.equal(y, yp) and torch.equal(h, hp)
    g = torch.autograd.grad(y.sum() + h.sum(), (a, b, h0))
    gp = torch.autograd.grad(yp.sum() + hp.sum(), (a, b, h0))
    assert all(torch.equal(x, xp) for x, xp in zip(g, gp))
    assert ops.LAUNCHES["rglru_scan"] == ops.LAUNCHES["rglru_scan_bwd"] == 0
    a, b, h0 = a.detach(), b.detach(), h0.detach()
    with pytest.raises(ValueError, match="CUDA"):
        ops.rglru_scan(a, b, h0, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        rs.rglru_scan_cuda(a, b, h0)
    with pytest.raises(ValueError, match="CUDA"):
        rs.rglru_scan_bwd_cuda(a, y.detach(), h0, b, h0)
    with pytest.raises(ValueError, match="mode"):
        ops.rglru_scan(a, b, h0, mode="pallas")


def test_scan_profiled_bytes():
    """The profiler hook counts a and b read and y written, as JAX's;
    the kernels' traffic for the bounds: 12 bytes an element forward,
    20 backward (a, y, dy read; da, db written)."""
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(2, 8, 32))
    prof = ops.enable_kernel_profiling()
    try:
        ops.rglru_scan(a, b, h0)
    finally:
        ops.disable_kernel_profiling()
    (rec,) = prof.records
    assert rec["op"] == "rglru_scan" and rec["bytes"] == 3 * a.nbytes
    assert rs.scan_bytes(8, 256, 2560) == 4 * (3 * 8 * 256 * 2560
                                               + 2 * 8 * 2560)
    assert rs.scan_bwd_bytes(8, 256, 2560) == 4 * (5 * 8 * 256 * 2560
                                                   + 3 * 8 * 2560)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.RandomState(2)
    B, S, C, W = 2, 7, 24, 4
    w = (rng.randn(W, C) * 0.1).astype(np.float32)
    bias = (rng.randn(C) * 0.1).astype(np.float32)
    x = rng.randn(B, S, C).astype(np.float32)
    st = rng.randn(B, W - 1, C).astype(np.float32) if with_state else None
    jy, js = jlayers.causal_conv1d(
        {"w": jnp.asarray(w), "b": jnp.asarray(bias)}, jnp.asarray(x),
        state=None if st is None else jnp.asarray(st))
    ty, ts = tlayers.causal_conv1d(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(bias)},
        torch.from_numpy(x), state=None if st is None else
        torch.from_numpy(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


class _Cfg:
    d_model = 32
    lru_width = 48
    conv1d_width = 4
    num_layers = 4


def _block_params(seed=7):
    jp = jrglru.rglru_init(jax.random.PRNGKey(seed), _Cfg)
    return jp, interop.tree_to_torch(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def test_block_train_matches_jax():
    """The whole recurrent block over a sequence (conv, gates, the scan,
    the gelu branch, the output projection) in f32, and its gradient with
    respect to every parameter."""
    jp, tp = _block_params()
    x = np.random.RandomState(4).randn(2, 21, _Cfg.d_model).astype(
        np.float32)

    def jloss(p):
        y, _ = jrglru.block_apply(p, jnp.asarray(x), mode="train")
        return (y ** 2).sum(), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    names, leaves, _ = _flatten_with_names(tp)
    for v in leaves:
        v.requires_grad_()
    ty, cache = trglru.block_apply(tp, torch.from_numpy(x), mode="train")
    assert cache is None
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **F32_TOL)
    tg = torch.autograd.grad((ty ** 2).sum(), leaves)
    jnames, jleaves, _ = jflat(jg)
    assert jnames == names
    for n, g, j in zip(names, tg, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_block_decode_matches_jax_and_scan():
    """Decode steps of the block from a zero cache against JAX's decode
    steps (same cache in, same cache out), and the port's own scan over
    the sequence against its steps."""
    jp, tp = _block_params(8)
    B, S, W = 2, 11, _Cfg.lru_width
    x = np.random.RandomState(5).randn(B, S, _Cfg.d_model).astype(
        np.float32)
    jc = {"h": jnp.zeros((B, W)), "conv": jnp.zeros((B, 3, W))}
    tc = {"h": torch.zeros(B, W), "conv": torch.zeros(B, 3, W)}
    ys = []
    for t in range(S):
        jy, jc = jrglru.block_apply(jp, jnp.asarray(x[:, t:t + 1]),
                                    mode="decode", cache=jc)
        ty, tc = trglru.block_apply(tp, torch.from_numpy(x[:, t:t + 1]),
                                    mode="decode", cache=tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **F32_TOL)
        ys.append(ty)
    y_scan, _ = trglru.block_apply(tp, torch.from_numpy(x), mode="train")
    np.testing.assert_allclose(y_scan.numpy(), torch.cat(ys, 1).numpy(),
                               atol=2e-5)


def test_rglru_scan_vs_step():
    """The port's scan (through ``ops.rglru_scan``) against its own
    decode steps, as ``tests/test_models.py::test_rglru_scan_vs_step``."""
    _, tp = _block_params(9)
    B, S, W = 2, 33, _Cfg.lru_width
    x = torch.from_numpy(np.random.RandomState(6).randn(B, S, W).astype(
        np.float32))
    y_scan, h_last = trglru.rglru_scan(tp, x)
    h = torch.zeros(B, W)
    ys = []
    for t in range(S):
        yt, h = trglru.rglru_step(tp, x[:, t], h)
        ys.append(yt)
    np.testing.assert_allclose(y_scan.numpy(), torch.stack(ys, 1).numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(h_last.numpy(), h.numpy(), atol=2e-5)


def test_softplus_and_gates_match_jax():
    """``_gates`` in f32 and bf16 (projections and sigmoids in x's dtype,
    decay and multiplier in f32): f32 within rtol 1e-6, bf16 inputs
    within one bf16 rounding of the sigmoids (atol 1e-2); softplus as
    ``jax.nn.softplus`` (``m + log1p(exp(-|x|))``, the same formula)
    within rtol 1e-6: the two libraries' exp and log1p differ in the last
    bit (measured: 2 ulp)."""
    jp, tp = _block_params(10)
    lam = np.random.RandomState(1).randn(64).astype(np.float32) * 4
    np.testing.assert_allclose(
        trglru._softplus(torch.from_numpy(lam)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(lam))), rtol=1e-6, atol=0)
    x = np.random.RandomState(3).randn(2, 5, _Cfg.lru_width).astype(
        np.float32)
    for dt, tdt, tol in ((jnp.float32, torch.float32, dict(rtol=1e-6,
                                                           atol=1e-6)),
                         (jnp.bfloat16, torch.bfloat16, dict(atol=1e-2))):
        ja, jb = jrglru._gates(jp, jnp.asarray(x).astype(dt))
        ta, tb = trglru._gates(tp, torch.from_numpy(x).to(tdt))
        assert ta.dtype == tb.dtype == torch.float32
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **tol)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **tol)
