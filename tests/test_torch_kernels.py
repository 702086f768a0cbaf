"""Port kernels (``repro_torch.kernels``) against the JAX package.

The plain PyTorch versions of the two serving kernels — decode attention
and the row scatter-swap — are held against the JAX oracles
(``repro.kernels.ref``) and the Pallas kernels in interpret mode, on the
same numpy inputs.  Decode attention: rtol 1e-4 / atol 2e-5 in f32 (the
two sum in different orders), atol 2e-2 in bf16 (one bf16 rounding step
of outputs below 4).  The scatter-swap is bitwise.  The CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jda
from repro.kernels import ref as jref
from repro.kernels import scatter_apply as jsa
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops, ref
from repro_torch.kernels import scatter_apply as sa

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_ATOL = 2e-2


def _decode_inputs(B, C, H, KV, hd, ring, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, H, hd).astype(np.float32)
    k = rng.randn(B, C, KV, hd).astype(np.float32)
    v = rng.randn(B, C, KV, hd).astype(np.float32)
    pos = rng.randint(0, 2 * C, B).astype(np.int32)
    pos[0] = 0
    if not ring:
        pos = np.minimum(pos, C - 1)
    return q, k, v, pos


# ------------------------------------------------------- decode attention


@pytest.mark.parametrize(
    "B,C,H,KV,hd,window,ring,softcap",
    [(3, 64, 4, 2, 32, 0, False, 0.0),      # G 2, ragged pos
     (3, 64, 4, 4, 32, 0, False, 0.0),      # G 1
     (2, 128, 8, 2, 64, 32, False, 0.0),    # G 4, sliding window
     (2, 32, 4, 4, 32, 32, True, 0.0),      # ring buffer
     (1, 48, 4, 1, 16, 0, False, 30.0),     # softcap, G 4
     (4, 96, 6, 3, 32, 48, True, 0.0)])     # ring, pos past the wrap
def test_plain_decode_attention_matches_jax(B, C, H, KV, hd, window, ring,
                                            softcap):
    q, k, v, pos = _decode_inputs(B, C, H, KV, hd, ring)
    kw = dict(window=window, ring=ring, softcap=softcap)
    got = da.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(pos), block_k=32, **kw)
    oracle = jref.decode_attention_ref(q, k, v, pos, **kw)
    pallas = jda.decode_attention_fwd(q, k, v, pos, block_k=32,
                                      interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32_TOL)
    # the port's own oracle agrees too
    mine = ref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(mine.numpy(), np.asarray(oracle), **F32_TOL)


@pytest.mark.parametrize("q_bf16", [False, True])
def test_plain_decode_attention_bf16_cache_matches_jax(q_bf16):
    q, k, v, _ = _decode_inputs(2, 96, 4, 2, 64, False, seed=1)
    pos = np.asarray([7, 90], np.int32)
    qj = jnp.asarray(q, jnp.bfloat16 if q_bf16 else jnp.float32)
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    pallas = jda.decode_attention_fwd(qj, kj, vj, pos, block_k=32,
                                      interpret=True)
    qt = torch.from_numpy(q).to(torch.bfloat16 if q_bf16 else torch.float32)
    kt = torch.from_numpy(k).bfloat16()
    vt = torch.from_numpy(v).bfloat16()
    got = da.decode_attention_plain(qt, kt, vt, torch.from_numpy(pos),
                                    block_k=32)
    assert got.dtype == qt.dtype
    want = np.asarray(pallas, np.float32)
    if q_bf16:
        np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("window,ring", [(0, False), (64, False), (0, True)])
def test_block_bounds_and_cache_bytes_equal_jax(window, ring):
    pos = np.asarray([0, 15, 127, 128, 200, 255], np.int32)
    kw = dict(seq_len=256, window=window, ring=ring, block_k=32)
    lo, hi = da.block_bounds(torch.from_numpy(pos), **kw)
    jlo, jhi = jda.block_bounds(pos, **kw)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    bkw = dict(seq_len=256, kv_heads=2, head_dim=64, window=window,
               ring=ring, block_k=32)
    assert (da.cache_read_bytes(torch.from_numpy(pos), **bkw)
            == jda.cache_read_bytes(pos, **bkw))


def test_decode_attention_dispatch():
    q, k, v, pos = (torch.from_numpy(a) for a in
                    _decode_inputs(2, 64, 4, 2, 32, False))
    auto = ops.decode_attention(q, k, v, pos)
    plain = ops.decode_attention(q, k, v, pos, mode="plain")
    assert torch.equal(auto, plain)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q, k, v, pos, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(q, k, v, pos)
    with pytest.raises(ValueError, match="mode"):
        ops.decode_attention(q, k, v, pos, mode="pallas")
    assert dict(ops.LAUNCHES) == before     # nothing launched on the CPU


# ----------------------------------------------------------- scatter swap


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scatter_swap_bitwise_vs_jax(dtype):
    rng = np.random.RandomState(0)
    full = rng.randn(12, 96).astype(np.float32)
    rows = rng.randn(3, 96).astype(np.float32)
    idx = np.asarray([7, 0, 11], np.int32)
    jfull = jnp.asarray(full, dtype)
    jrows = jnp.asarray(rows, dtype)
    want_full, want_disp = jref.scatter_swap_ref(jfull, idx, jrows)
    pal_full, pal_disp = jsa.scatter_swap_2d(jnp.array(jfull), idx, jrows,
                                             block_c=32, interpret=True)
    tfull = torch.from_numpy(full).to(getattr(torch, dtype))
    trows = torch.from_numpy(rows).to(getattr(torch, dtype))
    orig = tfull.clone()
    got_full, got_disp = sa.scatter_swap_plain(tfull, idx, trows)
    assert got_full is tfull                       # in place
    for want in (want_full, pal_full):
        assert np.array_equal(
            _bits(got_full).numpy(),
            np.asarray(want).view(np.int16 if dtype == "bfloat16"
                                  else np.int32))
    for want in (want_disp, pal_disp):
        assert np.array_equal(
            _bits(got_disp).numpy(),
            np.asarray(want).view(np.int16 if dtype == "bfloat16"
                                  else np.int32))
    # the port's own oracle agrees, and leaves its input untouched
    rf, rd = ref.scatter_swap_ref(orig, idx, trows)
    assert torch.equal(_bits(rf), _bits(got_full))
    assert torch.equal(_bits(rd), _bits(got_disp))
    # involution: swapping the displaced rows back restores the original
    back, again = sa.scatter_swap_plain(got_full, idx, got_disp)
    assert torch.equal(_bits(back), _bits(orig))
    assert torch.equal(_bits(again), _bits(trows))


def test_scatter_swap_ops_modes_and_checks():
    full = torch.arange(24, dtype=torch.float32).reshape(4, 3, 2)
    rows = -torch.ones(2, 3, 2)
    idx = np.asarray([2, 0], np.int32)
    kept = full.clone()
    new, disp = ops.scatter_swap(full, idx, rows)          # not donated
    assert torch.equal(full, kept) and new is not full
    assert torch.equal(new[[2, 0]], rows)
    assert torch.equal(disp, kept[[2, 0]])
    new2, _ = ops.scatter_swap(full, idx, rows, donate=True)
    assert new2 is full and torch.equal(full[[2, 0]], rows)
    with pytest.raises(ValueError, match="CUDA"):
        ops.scatter_swap(full, idx, rows, mode="kernel")
    with pytest.raises(ValueError, match="unique"):
        ops.scatter_swap(kept, np.asarray([1, 1]), rows)
    with pytest.raises(ValueError, match="range"):
        ops.scatter_swap(kept, np.asarray([1, 4]), rows)
    with pytest.raises(ValueError, match="contiguous"):
        sa.scatter_swap_plain(kept.transpose(1, 2), idx, rows)
    same, r = ops.scatter_swap(kept, np.zeros(0, np.int32), rows[:0])
    assert same is kept and r.shape[0] == 0


def test_kernel_profiling_records_ops():
    """``enable_kernel_profiling`` times each op under the JAX package's
    metric names and trace lane."""
    from repro_torch.obs import MetricsRegistry, Tracer
    metrics, tracer = MetricsRegistry(), Tracer()
    prof = ops.enable_kernel_profiling(tracer=tracer, metrics=metrics)
    try:
        q, k, v, pos = (torch.from_numpy(a) for a in
                        _decode_inputs(2, 64, 4, 2, 32, False))
        ops.decode_attention(q, k, v, pos)
        ops.scatter_swap(torch.zeros(4, 6), np.asarray([1]),
                         torch.ones(1, 6))
    finally:
        ops.disable_kernel_profiling()
    summary = prof.summary()
    assert summary["decode_attention"]["calls"] == 1
    assert summary["decode_attention"]["bytes"] == 2 * q.nbytes + \
        da.cache_read_bytes(pos, seq_len=64, kv_heads=2, head_dim=32,
                            dtype_bytes=4)
    assert summary["scatter_swap"]["bytes"] == 2 * 24
    snap = metrics.snapshot()
    assert snap["kernels/decode_attention_calls"] == 1
    assert snap["kernels/scatter_swap_ms"]["count"] == 1
    assert {e.lane for e in tracer.events()} == {"kernels"}
