"""The port's plain Q8 masked-Adam step against the JAX Pallas kernel.

``masked_adam_q8_plain`` (flat leaf, last codec block zero padded in the
function) against JAX's ``ops.masked_adam_q8_tree`` with
``interpret=True`` (the Pallas ``masked_adam_q8_2d`` over the wrapper's
padded ``[NB, 256]`` views), on the same numpy inputs, over the sweep of
``tests/test_kernels.py``: parameters rtol 1e-6 in f32 (2e-2 in bf16),
scales rtol 1e-6, int8 codes within one quantum — the bounds
``tests/test_q8state.py`` allows between XLA and the interpret-mode
kernel.  Also the oracle pair ``ref.masked_adam_q8_ref``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.runtime.compression import quantize_int8 as jquant
from repro_torch.kernels import masked_adam as ma
from repro_torch.kernels import ref

torch.set_num_threads(2)

SHAPES = [(8, 128), (256, 512), (100, 257), (1, 128), (513, 130)]
KW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, count=3,
          tau=0.7)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gate", ["mask", "tau"])
def test_plain_masked_adam_q8_matches_jax_interpret(shape, dtype, gate):
    rng = np.random.default_rng(sum(shape))
    p = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    m = rng.normal(size=shape).astype(np.float32) * 0.1
    v = np.abs(rng.normal(size=shape)).astype(np.float32) * 0.01
    mask = rng.random(shape) > 0.5
    mq, ms = jquant(jnp.asarray(m))
    vq, vs = jquant(jnp.asarray(v))
    jd = getattr(jnp, dtype)
    pj, gj = jnp.asarray(p, jd), jnp.asarray(g, jd)
    use_tau = gate == "tau"
    out = jops.masked_adam_q8_tree(
        {"a": pj}, {"a": gj}, {"a": mq}, {"a": ms}, {"a": vq}, {"a": vs},
        None if use_tau else {"a": jnp.asarray(mask)}, use_tau=use_tau,
        interpret=True, **KW)
    jp, jmq, jms, jvq, jvs = (np.asarray(o["a"], np.float32
                                         if i == 0 else None)
                              for i, o in enumerate(out))
    td = getattr(torch, dtype)
    pt = _t(np.asarray(pj.astype(jnp.float32))).to(td)
    gt = _t(np.asarray(gj.astype(jnp.float32))).to(td)
    q = [_t(np.asarray(a)) for a in (mq, ms, vq, vs)]
    ma.masked_adam_q8_plain(pt, gt, *q, None if use_tau else _t(mask),
                            ma.scalars(**KW), use_tau=use_tau)
    rtol = 2e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(pt.float().numpy(), jp, rtol=rtol, atol=1e-5)
    for mine, want in ((q[1], jms), (q[3], jvs)):
        np.testing.assert_allclose(mine.numpy(), want, rtol=1e-6)
    for mine, want in ((q[0], jmq), (q[2], jvq)):
        assert np.abs(mine.numpy().astype(np.int32)
                      - want.astype(np.int32)).max() <= 1


def test_q8_oracles_agree():
    rng = np.random.default_rng(9)
    p, g = (rng.normal(size=(6, 256)).astype(np.float32) for _ in range(2))
    m = rng.normal(size=(6, 256)).astype(np.float32) * 0.1
    v = np.abs(rng.normal(size=(6, 256))).astype(np.float32) * 0.01
    mq, ms = jquant(jnp.asarray(m))
    vq, vs = jquant(jnp.asarray(v))
    mask = rng.random((6, 256)) > 0.3
    scal = np.asarray(ma.scalars(**KW), np.float32)
    want = jref.masked_adam_q8_ref(
        jnp.asarray(p), jnp.asarray(g), mq, ms[:, None], vq, vs[:, None],
        jnp.asarray(mask), jnp.asarray(scal))
    got = ref.masked_adam_q8_ref(
        _t(p), _t(g), _t(np.asarray(mq)), _t(np.asarray(ms))[:, None],
        _t(np.asarray(vq)), _t(np.asarray(vs))[:, None], _t(mask), _t(scal))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
