"""Port optimizers, codec and the masked-Adam plain kernels against JAX.

The same numpy inputs go through the JAX package and the port:

- ``runtime/compression`` int8 codes and scales: bitwise;
- ``Adam.update`` / ``processed_grad`` (with and without a mask and
  weight decay) and ``Q8Adam.update``: bitwise (the port takes IEEE
  division and square root where PyTorch's fast paths are not, see
  ``repro_torch.numerics``); with global-norm clipping rtol 1e-6 /
  atol 1e-7 (the norm is a sum in another order);
- ``masked_adam_plain`` against the Pallas ``masked_adam_2d`` in
  interpret mode over the sweep of ``tests/test_kernels.py``: rtol 1e-6
  in f32 and 2e-2 in bf16, atol 1e-5, as the JAX test states;
- the tree wrappers against ``Adam.update`` (the port's own pairing of
  ``tests/test_kernels.py::test_masked_adam_tree_wrapper``);
- the learning-rate schedules and the refresh-step quantile threshold.

The CUDA kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.blockllm import _masked_quantile_threshold as jthreshold
from repro.kernels import masked_adam as jma
from repro.kernels import ref as jref
from repro.optim import schedule as jschedule
from repro.optim.adam import Adam as JAdam
from repro.optim.adam import AdamState as JAdamState
from repro.optim.q8adam import Q8Adam as JQ8Adam
from repro.runtime.compression import dequantize_int8 as jdequant
from repro.runtime.compression import quantize_int8 as jquant
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.core.blockllm import _masked_quantile_threshold
from repro_torch.kernels import masked_adam as ma
from repro_torch.kernels import ops, ref
from repro_torch.optim import schedule
from repro_torch.optim.adam import Adam, AdamState
from repro_torch.optim.q8adam import Q8Adam, from_adam_state, to_adam_state
from repro_torch.runtime.compression import dequantize_int8, quantize_int8

torch.set_num_threads(2)

SHAPES = [(8, 128), (256, 512), (100, 257), (1, 128), (513, 130)]
SCAL = np.array([1e-3, 0.9, 0.999, 1e-8, 0.01, 0.1, 0.01, 0.7], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree):
    return _flatten_with_names(tree)[1]


def _adam_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    m = rng.normal(size=shape).astype(np.float32) * 0.1
    v = np.abs(rng.normal(size=shape)).astype(np.float32) * 0.01
    mask = rng.random(shape) > 0.5
    return p, g, m, v, mask


# ------------------------------------------------------------------ codec


@pytest.mark.parametrize("shape", [(1000, 37), (256,), (3, 5), (2, 300, 7)])
def test_quantize_int8_bitwise_equal_jax(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    x.reshape(-1)[:5] = [0.0, 1e-30, -3.5, 127.0, -127.5]
    qj, sj = jquant(jnp.asarray(x))
    qt, st = quantize_int8(_t(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    back = dequantize_int8(qt, st, shape)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jdequant(qj, sj, shape)))


# ------------------------------------------------------------------- adam


def _jstate(m, v, count):
    return JAdamState(jnp.asarray(count, jnp.int32), {"a": jnp.asarray(m)},
                      {"a": jnp.asarray(v)})


def _tstate(m, v, count):
    return AdamState(torch.tensor(count, dtype=torch.int32), {"a": _t(m)},
                     {"a": _t(v)})


@pytest.mark.parametrize("masked,wd,count,clip", [(False, 0.0, 0, 0.0),
                                                  (True, 0.0, 3, 0.0),
                                                  (True, 0.1, 7, 0.0),
                                                  (False, 0.01, 1, 10.0)])
def test_adam_update_bitwise_equal_jax(masked, wd, count, clip):
    p, g, m, v, mask = _adam_inputs((37, 129), seed=count)
    mk = {"a": mask} if masked else None
    jp, js = JAdam(lr=3e-3, weight_decay=wd, clip_norm=clip).update(
        {"a": jnp.asarray(g)}, _jstate(m, v, count), {"a": jnp.asarray(p)},
        update_mask=None if mk is None else {"a": jnp.asarray(mask)})
    tp = {"a": _t(p)}
    st = _tstate(m, v, count)
    out, ts = Adam(lr=3e-3, weight_decay=wd, clip_norm=clip).update(
        {"a": _t(g)}, st, tp,
        update_mask=None if mk is None else {"a": _t(mask)})
    assert out is tp and ts.mu is st.mu          # in place
    assert int(ts.count) == count + 1
    for a, b in ((jp["a"], out["a"]), (js.mu["a"], ts.mu["a"]),
                 (js.nu["a"], ts.nu["a"])):
        if clip:
            # the global norm is a sum in another order (one f32 ulp
            # apart), so the clip scale is too; where b1*m and
            # (1-b1)*g*scale nearly cancel, only the absolute error of
            # the operands' last bits (~1e-8) remains meaningful
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    upd_j, _ = JAdam().processed_grad({"a": jnp.asarray(g)},
                                      _jstate(m, v, count))
    upd_t, _ = Adam().processed_grad({"a": _t(g)}, _tstate(m, v, count))
    np.testing.assert_array_equal(upd_t["a"].numpy(), np.asarray(upd_j["a"]))


def test_q8adam_update_matches_jax():
    p, g, m, v, _ = _adam_inputs((7, 300), seed=5)
    tree_j = {"a": jnp.asarray(p), "b": jnp.asarray(p[0])}
    tree_t = {"a": _t(p), "b": _t(p[0])}
    gj = {"a": jnp.asarray(g), "b": jnp.asarray(g[0])}
    gt = {"a": _t(g), "b": _t(g[0])}
    jq, tq = JQ8Adam(JAdam(lr=1e-3)), Q8Adam(Adam(lr=1e-3))
    sj, st = jq.init(tree_j), tq.init(tree_t)
    for _ in range(3):
        tree_j, sj = jq.update(gj, sj, tree_j)
        tree_t, st = tq.update(gt, st, tree_t)
    for a, b in zip(jax.tree.leaves((tree_j, sj.mu_q, sj.mu_scale, sj.nu_q,
                                     sj.nu_scale)),
                    _leaves((tree_t, st.mu_q, st.mu_scale, st.nu_q,
                             st.nu_scale))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tq.state_bytes(st) == jq.state_bytes(sj)
    f32 = to_adam_state(st, tree_t)
    again = from_adam_state(f32)
    for a, b in zip(_leaves((st.mu_q, st.nu_q)),
                    _leaves((again.mu_q, again.nu_q))):
        assert torch.equal(a, b)


# --------------------------------------------------- masked adam kernels


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_tau", [False, True])
def test_plain_masked_adam_matches_jax_interpret(shape, dtype, use_tau):
    p, g, m, v, mask = _adam_inputs(shape)
    jd = getattr(jnp, dtype)
    pj, gj = jnp.asarray(p, jd), jnp.asarray(g, jd)
    out = jma.masked_adam_2d(pj, gj, jnp.asarray(m), jnp.asarray(v),
                             jnp.asarray(mask), jnp.asarray(SCAL),
                             use_tau=use_tau, interpret=True)
    td = getattr(torch, dtype)
    pt = _t(np.asarray(pj.astype(jnp.float32))).to(td)
    gt = _t(np.asarray(gj.astype(jnp.float32))).to(td)
    mt, vt = _t(m), _t(v)
    oracle = ref.masked_adam_ref(pt, gt, mt, vt, _t(mask), _t(SCAL),
                                 use_tau=use_tau)
    ma.masked_adam_plain(pt, gt, mt, vt, _t(mask), SCAL, use_tau=use_tau)
    rtol = 2e-2 if dtype == "bfloat16" else 1e-6
    for o, r, mine in zip(out, (pt, mt, vt), oracle):
        np.testing.assert_allclose(r.float().numpy(),
                                   np.asarray(o, np.float32), rtol=rtol,
                                   atol=1e-5)
        np.testing.assert_allclose(mine.float().numpy(),
                                   np.asarray(o, np.float32), rtol=rtol,
                                   atol=1e-5)
    jo = jref.masked_adam_ref(pj, gj, jnp.asarray(m), jnp.asarray(v),
                              jnp.asarray(mask), jnp.asarray(SCAL),
                              use_tau=use_tau)
    np.testing.assert_allclose(oracle[0].float().numpy(),
                               np.asarray(jo[0], np.float32), rtol=rtol,
                               atol=1e-5)


def test_masked_adam_tree_wrappers_match_adam_update():
    """ops.masked_adam_tree (plain) against the unfused Adam on the same
    step: the fused path takes 1 - b1 from the f32 scalar (0.100000024),
    the unfused f32(1 - 0.9) = 0.1, so they agree to rtol 1e-5 (as the
    JAX test), not bitwise; a None mask is gate 1."""
    rng = np.random.default_rng(3)
    tree = {"a": _t(rng.normal(size=(16, 32)).astype(np.float32)),
            "b": _t(rng.normal(size=(7,)).astype(np.float32))}
    grads = {k: v * 0.1 for k, v in tree.items()}
    adam = Adam(lr=0.1)
    ref_p = {k: v.clone() for k, v in tree.items()}
    adam.update(grads, adam.init(ref_p), ref_p)
    for masks in (None, {k: torch.ones(v.shape, dtype=torch.bool)
                         for k, v in tree.items()}):
        p = {k: v.clone() for k, v in tree.items()}
        st = adam.init(p)
        ops.masked_adam_tree(p, grads, st.mu, st.nu, masks, lr=0.1,
                             mode="plain")
        for k in tree:
            np.testing.assert_allclose(p[k].numpy(), ref_p[k].numpy(),
                                       rtol=1e-5, atol=1e-6)
        q8 = Q8Adam(adam)
        p8 = {k: v.clone() for k, v in tree.items()}
        s8 = q8.init(p8)
        ops.masked_adam_q8_tree(p8, grads, s8.mu_q, s8.mu_scale, s8.nu_q,
                                s8.nu_scale, masks, lr=0.1, mode="plain")
        for k in tree:
            np.testing.assert_allclose(p8[k].numpy(), ref_p[k].numpy(),
                                       rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        ops.masked_adam_tree(p, grads, st.mu, st.nu, None, lr=0.1,
                             mode="kernel")


def test_scalars_equal_jax_tree_wrapper():
    """The f32 scalar vector equals the one the JAX wrapper builds."""
    got = ma.scalars(lr=3e-4, b1=0.9, b2=0.95, eps=1e-6, weight_decay=0.1,
                     count=9, tau=0.25)
    cf = jnp.asarray(9, jnp.float32) + 1.0
    want = np.asarray(jnp.stack([
        jnp.asarray(3e-4, jnp.float32), jnp.asarray(0.9, jnp.float32),
        jnp.asarray(0.95, jnp.float32), jnp.asarray(1e-6, jnp.float32),
        jnp.asarray(0.1, jnp.float32), 1.0 - 0.9 ** cf, 1.0 - 0.95 ** cf,
        jnp.asarray(0.25, jnp.float32)]))
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)


# --------------------------------------------------- schedules, threshold


def test_schedules_match_jax():
    for jf, tf in ((jschedule.cosine(1e-3, 100, warmup_steps=10),
                    schedule.cosine(1e-3, 100, warmup_steps=10)),
                   (jschedule.cosine(3e-4, 50), schedule.cosine(3e-4, 50)),
                   (jschedule.linear_warmup_rsqrt(1e-3, 20),
                    schedule.linear_warmup_rsqrt(1e-3, 20)),
                   (jschedule.constant(2e-3), schedule.constant(2e-3))):
        for step in (0, 1, 5, 10, 11, 49, 50, 99, 150):
            want = float(jf(jnp.asarray(step, jnp.int32)))
            np.testing.assert_allclose(float(tf(step)), want, rtol=1e-6)


@pytest.mark.parametrize("shape,q", [((3, 70000), 0.1), ((2, 5, 9), 0.25),
                                     ((1, 200000), 0.05), ((4, 33), 1.0)])
def test_masked_quantile_threshold_equal_jax(shape, q):
    u = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    want = np.asarray(jthreshold(jnp.asarray(u), q, 65536))
    got = _masked_quantile_threshold(_t(u), q, 65536).numpy()
    np.testing.assert_array_equal(got, want)
