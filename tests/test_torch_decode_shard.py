"""The decode kernel's shard variant (plain version) and the cross-rank
softmax merge, against the whole-cache call and the JAX package.

A cache of C rows is cut into n shards of C / n rows; each shard is
attended with its first global row (``offset``) and the whole cache's
length (``total``), returning o and each head's log-sum-exp, and
``shard_ctx.merge_softmax`` merges the shards.  The merged output is
held against ``decode_attention_plain`` over the whole cache and JAX's
Pallas ``decode_attention_fwd`` in interpret mode: rtol 1e-5 / atol
2e-6 in f32 (the shards group the k-block merge differently from one
sweep, so the sums run in another order; f32 rounding of outputs below
4 in magnitude), atol 2e-2 against Pallas with a bf16 cache (one bf16
step).  With offset 0 over the whole cache the shard variant is bitwise
the call without it.  The ``full`` path's shard form
(``layers.attention_decode_shard``) is held the same way against
``layers.attention_decode``.  The CUDA kernel's shard variant runs only
on the card (``chip_smoke.py`` phase 30).
"""
import math

import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jda
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.runtime import shard_ctx

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-5, atol=2e-6)
BF16_ATOL = 2e-2

# (B, C, H, KV, hd, window, ring, softcap, n shards, pos): windows, rings
# (before and after the wrap), softcap, ragged positions; every case has
# shards with no visible row (rows past pos, or outside the window)
CASES = [
    (3, 128, 4, 2, 32, 0, False, 0.0, 4, [0, 37, 127]),
    (2, 256, 8, 2, 64, 48, False, 0.0, 8, [200, 61]),
    (2, 64, 4, 4, 32, 64, True, 0.0, 4, [150, 20]),
    (3, 96, 6, 3, 32, 48, True, 0.0, 3, [7, 95, 300]),
    (1, 128, 4, 1, 16, 0, False, 30.0, 8, [70]),
    (4, 64, 8, 1, 32, 0, False, 0.0, 2, [3, 31, 32, 63]),
]


def _inputs(B, C, H, KV, hd, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 1, H, hd).astype(np.float32),
            rng.randn(B, C, KV, hd).astype(np.float32),
            rng.randn(B, C, KV, hd).astype(np.float32))


def _sharded(fn, q, k, v, pos, n, **kw):
    """Attend each of the n shards with its offset, then merge."""
    C = k.shape[1]
    c = C // n
    outs, lses = [], []
    for r in range(n):
        o, lse = fn(q, k[:, r * c:(r + 1) * c].contiguous(),
                    v[:, r * c:(r + 1) * c].contiguous(), pos,
                    offset=r * c, total=C, **kw)
        outs.append(o.reshape(o.shape[0], o.shape[2], o.shape[3]))
        lses.append(lse)
    o, lse = shard_ctx.merge_softmax(torch.stack(outs), torch.stack(lses))
    return o[:, None], lse, lses


@pytest.mark.parametrize("B,C,H,KV,hd,window,ring,softcap,n,pos", CASES)
def test_plain_shards_merged_match_whole_cache_and_jax(B, C, H, KV, hd,
                                                       window, ring, softcap,
                                                       n, pos):
    q, k, v = _inputs(B, C, H, KV, hd)
    pos = np.asarray(pos, np.int32)
    if not ring:
        pos = np.minimum(pos, C - 1)
    kw = dict(window=window, ring=ring, softcap=softcap)
    qt, kt, vt, pt = map(torch.from_numpy, (q, k, v, pos))
    got, lse, lses = _sharded(da.decode_attention_plain, qt, kt, vt, pt, n,
                              block_k=16, return_lse=True, **kw)
    whole = da.decode_attention_plain(qt, kt, vt, pt, block_k=16, **kw)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **F32_TOL)
    pallas = jda.decode_attention_fwd(q, k, v, pos, block_k=16,
                                      interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32_TOL)
    # a shard with no visible row: lse -inf, and it changed nothing
    empty = [bool(torch.isneginf(x).any()) for x in lses]
    assert any(empty), "the case has no all-masked shard"
    assert torch.isfinite(lse).all()
    # the whole cache's lse from one call with offset 0
    _, lse1 = da.decode_attention_plain(qt, kt, vt, pt, block_k=16,
                                        offset=0, total=C, return_lse=True,
                                        **kw)
    np.testing.assert_allclose(lse.numpy(), lse1.numpy(), **F32_TOL)


@pytest.mark.parametrize("B,C,H,KV,hd,window,ring,softcap,n,pos", CASES)
def test_offset_zero_whole_cache_is_bitwise_the_plain_call(
        B, C, H, KV, hd, window, ring, softcap, n, pos):
    q, k, v = _inputs(B, C, H, KV, hd, seed=1)
    kw = dict(window=window, ring=ring, softcap=softcap, block_k=16)
    args = tuple(map(torch.from_numpy, (q, k, v, np.asarray(pos, np.int32))))
    plain = da.decode_attention_plain(*args, **kw)
    o, _ = da.decode_attention_plain(*args, offset=0, total=C,
                                     return_lse=True, **kw)
    assert torch.equal(o, plain)
    # through the op, as the model calls it
    o2, _ = ops.decode_attention(*args, offset=0, total=C, return_lse=True,
                                 **kw)
    assert torch.equal(o2, plain)


def test_bf16_cache_shards_match_jax():
    q, k, v = _inputs(2, 128, 8, 2, 64, seed=2)
    pos = np.asarray([9, 120], np.int32)
    kb, vb = (torch.from_numpy(a).bfloat16() for a in (k, v))
    got, _, _ = _sharded(da.decode_attention_plain, torch.from_numpy(q), kb,
                         vb, torch.from_numpy(pos), 4, block_k=32,
                         return_lse=True)
    import jax.numpy as jnp
    pallas = jda.decode_attention_fwd(
        jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), pos, block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas, np.float32),
                               atol=BF16_ATOL)


@pytest.mark.parametrize("B,C,H,KV,hd,window,ring,softcap,n,pos", CASES)
def test_full_path_shards_merged_match_attention_decode(
        B, C, H, KV, hd, window, ring, softcap, n, pos):
    q, k, v = _inputs(B, C, H, KV, hd, seed=3)
    pos = np.asarray(pos, np.int32)
    kw = dict(window=window, ring=ring, softcap=softcap)
    qt, kt, vt, pt = map(torch.from_numpy, (q, k, v, pos))
    got, _, _ = _sharded(layers.attention_decode_shard, qt, kt, vt, pt, n,
                         **kw)
    want = layers.attention_decode(qt, kt, vt, pt, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_merge_of_empty_shards_is_zero():
    o = torch.randn(3, 2, 4, 8)
    lse = torch.full((3, 2, 4), -math.inf)
    lse[1, 0] = 0.5
    out, m = shard_ctx.merge_softmax(o, lse)
    assert torch.equal(out[0], o[1, 0])         # one shard: itself
    assert torch.equal(out[1], torch.zeros(4, 8))
    assert torch.isneginf(m[1]).all() and torch.equal(m[0],
                                                       torch.full((4,), 0.5))


def test_block_bounds_of_shards():
    """Each shard's own k-blocks; [0, 0] where it sees no row."""
    pos = torch.tensor([0, 100, 255], dtype=torch.int32)
    lo, hi = da.block_bounds(pos, seq_len=64, block_k=16, offset=64,
                             total=256)
    assert lo.tolist() == [0, 0, 0] and hi.tolist() == [0, 2, 3]
    lo, hi = da.block_bounds(torch.tensor([0, 100, 200, 255],
                                          dtype=torch.int32),
                             seq_len=64, block_k=16, offset=128, total=256,
                             window=40)
    # rows 161..200 of [128, 192) are local rows 33..63; at 255 the
    # window (215, 255] misses the shard
    assert lo.tolist() == [0, 0, 2, 0] and hi.tolist() == [0, 0, 3, 0]
