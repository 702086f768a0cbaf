"""The port's flash-attention op (``kernels/flash_attention.py``, the
differentiable ``ops.flash_attention``) against the JAX package.  The
chunked attention its backward runs, and the model's chunked branch, are
in ``tests/test_torch_chunked.py``; the CUDA kernel itself runs only on
the card (``tests/test_torch_cuda.py``).

Inputs are made with numpy from a seed and given to both packages.
Tolerances, and why:

- ``flash_attention_plain`` against the TPU kernel in interpret mode
  (``flash_attention_fwd(..., interpret=True)``) at the shapes of
  ``tests/test_kernels.py::test_flash_attention_sweep``: f32 atol 2e-5,
  that sweep's bound (the two sum in other orders).  bf16 outputs: within
  one bf16 ulp of the reference value plus that f32 atol — both round an
  f32 result once, and two f32 results up to 2e-5 apart can round to
  neighbouring bf16 values (near zero an ulp is far below 2e-5).  A
  ragged S is held against JAX's oracle ``flash_attention_ref`` instead:
  in interpret mode the TPU kernel reads NaN past the end of the ragged
  last k-block, and p = 0 times NaN gives NaN rows (ROADMAP C);
- gradients through ``ops.flash_attention`` against JAX's custom VJP
  (``ops.flash_attention(..., interpret=True)``): atol 1e-4, the bound of
  ``test_flash_attention_grad_matches_ref``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

torch.set_num_threads(2)

F32_ATOL = 2e-5
GRAD_ATOL = 1e-4


def _qkv(B, Sq, Sk, H, KV, hd, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, hd).astype(dtype),
            rng.randn(B, Sk, KV, hd).astype(dtype),
            rng.randn(B, Sk, KV, hd).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    x = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.maximum(x, 2.0 ** -133)))
    return 2.0 ** (e - 7)


def assert_within_one_bf16_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got.astype(np.float64) - want)
    bad = err > bf16_ulp(want) + F32_ATOL
    assert not bad.any(), (f"{bad.sum()} outputs over one bf16 ulp + "
                           f"{F32_ATOL}; largest error {err.max():.3g}")


# ------------------------------------------------- plain vs the TPU kernel


@pytest.mark.parametrize(
    "B,S,H,KV,hd,causal,window",
    [(2, 256, 4, 2, 64, True, 0),
     (1, 512, 4, 1, 64, True, 64),
     (2, 128, 2, 2, 32, False, 0),
     (1, 384, 4, 4, 128, True, 0),
     (1, 256, 8, 2, 64, True, 128)])
def test_plain_matches_tpu_kernel_interpret(B, S, H, KV, hd, causal, window):
    q, k, v = _qkv(B, S, S, H, KV, hd)
    want = flash_attention_fwd(q, k, v, causal=causal, window=window,
                               block_q=128, block_k=128, interpret=True)
    got = fa.flash_attention_plain(*_t(q, k, v), causal=causal,
                                   window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)


def test_plain_bf16_matches_tpu_kernel_interpret():
    """``test_flash_attention_dtypes``' bf16 case: bf16 q, k, v; both
    compute in f32 and cast the output once."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(1, 128, 128, 2, 2,
                                                          64, seed=3))
    want = flash_attention_fwd(q, k, v, block_q=64, block_k=64,
                               interpret=True)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                  for a in (q, k, v))
    got = fa.flash_attention_plain(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    assert_within_one_bf16_ulp(got.float().numpy(),
                               np.asarray(want, np.float32))


@pytest.mark.parametrize("Sq,Sk,causal,window,dtype", [
    (200, 200, True, 0, np.float32), (1000, 1000, True, 96, np.float32),
    (77, 130, False, 0, np.float32), (130, 77, False, 40, np.float32),
    (200, 200, True, 0, "bf16")])
def test_plain_ragged_and_rectangular_match_jax_oracle(Sq, Sk, causal,
                                                       window, dtype):
    """Ragged S and Sq != Sk (non-causal; a windowed q past Sk has rows
    with no visible key, which both zero)."""
    q, k, v = _qkv(1, Sq, Sk, 4, 2, 32, seed=1)
    if dtype == "bf16":
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in
                   (q, k, v))
    want = jref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32))
                  for a in (q, k, v))
    if dtype == "bf16":
        tq, tk, tv = tq.bfloat16(), tk.bfloat16(), tv.bfloat16()
    got = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    if dtype == "bf16":
        assert_within_one_bf16_ulp(got.float().numpy(),
                                   np.asarray(want, np.float32))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=F32_ATOL)


def test_flop_and_byte_counts():
    """``flash_flops`` counts the visible pairs the mask lets through."""
    for Sq, Sk, causal, window in [(37, 37, True, 0), (50, 30, False, 7),
                                   (30, 50, True, 9), (64, 64, False, 0)]:
        qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None]
        ok = np.ones((Sq, Sk), bool)
        if causal:
            ok &= qp >= kp
        if window:
            ok &= qp - kp < window
        assert fa.visible_pairs(Sq, Sk, causal=causal,
                                window=window) == ok.sum()
        assert fa.flash_flops(2, Sq, Sk, 3, 16, causal=causal,
                              window=window) == 4 * 2 * 3 * 16 * ok.sum()
    q, k, v = _t(*_qkv(1, 8, 8, 4, 2, 32))
    assert fa.flash_bytes(q, k, v) == 2 * q.nbytes + k.nbytes + v.nbytes


# ------------------------------------- the bf16 kernel's three-piece split


def _pieces_sum(p):
    p1, p2, p3 = fa.split_bf16x3(p)
    assert p1.dtype == p2.dtype == p3.dtype == torch.bfloat16
    return p1.float() + p2.float() + p3.float()


def test_split_bf16x3_is_exact_above_2_pow_minus_100():
    """p1 + p2 + p3 == p bitwise for 10^5 seeded p log-uniform in
    [2^-100, 1], 10^5 uniform in [0, 1], 1.0, the largest f32 below 1 and
    every power of two from 2^-100 to 1: P.V with the three pieces keeps
    p's f32 value."""
    rng = np.random.RandomState(11)
    p = np.concatenate([
        2.0 ** rng.uniform(-100, 0, 100_000), rng.uniform(0, 1, 100_000),
        [1.0, np.nextafter(np.float32(1), np.float32(0))],
        2.0 ** np.arange(-100, 1)]).astype(np.float32)
    p = torch.from_numpy(p[p >= 2.0 ** -100])
    assert p.numel() > 200_000
    assert torch.equal(_pieces_sum(p), p)


def test_split_bf16x3_needs_the_third_piece():
    """Two pieces hold 16 of p's 24 significant bits: most p are not
    p1 + p2, which is why the kernel runs a third P.V product."""
    rng = np.random.RandomState(12)
    p = torch.from_numpy(rng.uniform(0, 1, 100_000).astype(np.float32))
    p1, p2, _ = fa.split_bf16x3(p)
    two = p1.float() + p2.float()
    assert (two != p).float().mean().item() > 0.9
    assert (two - p).abs().max().item() > 0


def test_split_bf16x3_error_below_2_pow_minus_100():
    """Below 2^-100 the last piece can fall under bf16's normal range; the
    error of the three pieces stays under 2^-120."""
    rng = np.random.RandomState(13)
    p = np.concatenate([2.0 ** rng.uniform(-149, -100, 100_000),
                        2.0 ** np.arange(-149, -100), [0.0]])
    p = torch.from_numpy(p.astype(np.float32))
    err = (_pieces_sum(p).double() - p.double()).abs()
    assert err.max().item() < 2.0 ** -120


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = _t(*_qkv(1, 8, 8, 2, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, mode="kernel")


# ------------------------------------------------- the op and its gradient


@pytest.mark.parametrize("shape,window", [
    ((1, 128, 4, 2, 32), 0),          # test_flash_attention_grad_matches_ref
    ((1, 256, 4, 1, 16), 48)])
def test_op_grads_match_jax(shape, window):
    """``ops.flash_attention``'s forward and q/k/v gradients of
    sum(o ** 2) against JAX's custom VJP with the Pallas forward in
    interpret mode, and against autograd through the plain version."""
    B, S, H, KV, hd = shape
    q, k, v = _qkv(B, S, S, H, KV, hd, seed=2)
    jo, jvjp = jax.vjp(lambda *a: jops.flash_attention(*a, True, window,
                                                       True), q, k, v)
    jg = jvjp(2 * jo)
    ins = [t.requires_grad_() for t in _t(q, k, v)]
    o = ops.flash_attention(*ins, True, window)
    tg = torch.autograd.grad((o ** 2).sum(), ins)
    ref_ins = [t.detach().clone().requires_grad_() for t in ins]
    rg = torch.autograd.grad((fa.flash_attention_plain(
        *ref_ins, window=window) ** 2).sum(), ref_ins)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0,
                               atol=F32_ATOL)
    for got, want, ref in zip(tg, jg, rg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=GRAD_ATOL)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=GRAD_ATOL)


def test_op_backward_asserts_like_jax():
    """The backward's chunk must divide Sq (``min(1024, Sq)``, JAX's
    assertion), and it takes one position vector (Sq == Sk)."""
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(1, 1536, 1536, 1, 1,
                                                     8)))
    o = ops.flash_attention(q, k, v)          # the forward takes any S
    with pytest.raises(AssertionError):
        o.sum().backward()
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(1, 16, 24, 2, 1, 8)))
    o = ops.flash_attention(q, k, v, False)
    with pytest.raises(ValueError, match="Sq == Sk"):
        o.sum().backward()


def test_op_kernel_profiler_records():
    """As ``tests/test_tracekit.py::test_kernel_profiler_records_and_
    passthrough``: one record per call under ``flash_attention`` with the
    JAX byte count, the calls counter, one span on the ``kernels`` lane,
    gradients through the profiled call, no record once disabled."""
    from repro_torch.obs import MetricsRegistry, Tracer
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(1, 128, 128, 2, 2, 16)))
    ref = ops.flash_attention(q, k, v)
    (gref,) = torch.autograd.grad(ref.sum(), (q,))
    tr, reg = Tracer(), MetricsRegistry()
    prof = ops.enable_kernel_profiling(tracer=tr, metrics=reg)
    try:
        out = ops.flash_attention(q, k, v)
        (g,) = torch.autograd.grad(out.sum(), (q,))
        assert torch.equal(out, ref) and torch.equal(g, gref)
        assert len(prof.records) == 1
        rec = prof.records[0]
        assert rec["op"] == "flash_attention" and rec["ms"] >= 0
        assert rec["bytes"] == q.nbytes * 2 + k.nbytes + v.nbytes
        assert reg.counter("kernels/flash_attention_calls").value == 1
        spans = tr.spans("flash_attention")
        assert len(spans) == 1 and spans[0].lane == "kernels"
        assert prof.summary()["flash_attention"]["calls"] == 1
    finally:
        ops.disable_kernel_profiling()
    ops.flash_attention(q, k, v)
    assert len(prof.records) == 1
