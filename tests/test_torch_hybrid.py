"""The hybrid RG-LRU family (``recurrentgemma-2b``) in the port against the
JAX package, and its serving in the port.

The architecture is ``reduce_config(recurrentgemma-2b, 8)`` with 5
layers, so both stage shapes are present: ``(recurrent, recurrent,
local) x 1`` and the remainder ``(recurrent, recurrent) x 1``; local
attention is MQA with a 64-row window.  Both packages get JAX's
``init_params`` weights through ``repro_torch.interop`` and the same numpy
tokens.  Tolerances, and why:

- f32 loss, gradients and decode logits: rtol 1e-4 / atol 2e-5, the
  model tolerance of ``tests/test_torch_model.py`` (JAX scans the
  recurrence associatively and contracts multiply-adds; the port scans
  sequentially, each op rounded);
- bf16 forward logits: atol 5e-2 (bf16 rounds at other places in the two
  frameworks, and the recurrence carries a rounding through the whole
  sequence: measured up to 1.6e-2);
- greedy token streams: equal.

Serving: the port primes recurrent models token by token and zeroes a
slot's recurrent state at admission; the JAX server does not (ROADMAP
C), so the server is held against the model-level greedy decode from a
fresh cache, and a request in a reused slot against a fresh server.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro.configs.base import get_config as jget_config
from repro.launch.train import reduce_config as jreduce
from repro.models import model as jmodel
from repro_torch import interop
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.configs import base as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.runtime.serve_config import ServeConfig
from repro_torch.runtime.serve_loop import DecodeServer, Request

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_ATOL = 5e-2


def _cfgs(dtype="float32", **kw):
    jcfg = jreduce(jget_config("recurrentgemma-2b"), 8).replace(
        num_layers=5, dtype=dtype, **kw)
    return jcfg, tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def f32_model():
    jcfg, cfg = _cfgs()
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jcfg, cfg, jparams, params


def test_config_stages_and_port_init_layout(f32_model):
    """Both stage shapes are present, and the port's own ``init_params``
    has JAX's leaf paths and shapes (``rec/conv/w`` [G, 4, W],
    ``rec/lambda`` [G, W], tied embedding)."""
    jcfg, cfg, jparams, _ = f32_model
    assert cfg.stages() == [(("recurrent", "recurrent", "local"), 1),
                            (("recurrent", "recurrent"), 1)]
    mine = tmodel.init_params(cfg, device="cpu")
    tn, tl, _ = _flatten_with_names(mine)
    jn, jl, _ = jflat(jparams)
    assert tn == jn
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    names = dict(zip(tn, tl))
    W = cfg.lru_width
    assert names["stages/0/pos0/rec/conv/w"].shape == (1, 4, W)
    assert names["stages/1/pos1/rec/lambda"].shape == (1, W)
    assert "head" not in mine
    # Lambda puts the decay at r = 1 in (0.9, 0.999), as JAX's init
    lam = names["stages/0/pos0/rec/lambda"]
    decay = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert bool(((decay > 0.9 - 1e-5) & (decay < 0.999 + 1e-5)).all())


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    """``loss_fn`` and its gradient with respect to every leaf against
    JAX's ``value_and_grad`` (f32; remat recomputes each block, the scan
    Function's forward included)."""
    jcfg, cfg = _cfgs(remat=remat)
    jparams = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)},
                                 attn_impl="full", loss_chunk=0),
        has_aux=True))(jparams)
    names, leaves, td = _flatten_with_names(interop.tree_to_torch(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    for leaf in leaves:
        leaf.requires_grad_()
    tl, _ = tmodel.loss_fn(td.unflatten(leaves), cfg,
                           {"tokens": torch.from_numpy(tokens).long()},
                           loss_chunk=0)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, leaves)
    jnames, jleaves, _ = jflat(jg)
    assert jnames == names
    for n, g, j in zip(names, grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **F32_TOL,
                                   err_msg=n)


def test_bf16_forward_logits_match_jax():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jparams = jmodel.init_params(jax.random.PRNGKey(2), jcfg)
    params = interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    tokens = np.random.RandomState(6).randint(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    jlog, _, _ = jax.jit(lambda p, t: jmodel.forward(
        p, jcfg, {"tokens": t}, attn_impl="full"))(jparams,
                                                   jnp.asarray(tokens))
    tlog = tmodel.forward(params, cfg, torch.from_numpy(tokens).long())
    assert tlog.dtype == torch.bfloat16
    np.testing.assert_allclose(tlog.float().numpy(),
                               np.asarray(jlog, np.float32), rtol=0,
                               atol=BF16_ATOL)


def _jax_decode(jcfg):
    return jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, jcfg, c, t, pos, attn_impl="full"))


def test_teacher_forced_decode_matches_jax_past_the_window(f32_model):
    """70 teacher-forced decode steps from a fresh cache (f32 caches), so
    the 64-row local-attention ring wraps: logits and the recurrent
    state at every step."""
    jcfg, cfg, jparams, params = f32_model
    B, steps, max_seq = 2, 70, 96
    rng = np.random.RandomState(3)
    fed = rng.randint(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    jc = jmodel.init_cache(jcfg, B, max_seq, dtype=jnp.float32)
    tc = tmodel.init_cache(cfg, B, max_seq, dtype=torch.float32,
                           device="cpu")
    decode = _jax_decode(jcfg)
    for t in range(steps):
        pos = np.full(B, t, np.int32)
        jlg, jc = decode(jparams, jc, jnp.asarray(fed[t]), jnp.asarray(pos))
        tlg, _ = tmodel.decode_step(params, cfg, tc,
                                    torch.from_numpy(fed[t]).long(), pos)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **F32_TOL,
                                   err_msg=f"step {t}")
    jst = jflat(jc["stages"])
    tst = _flatten_with_names(tc["stages"])
    assert jst[0] == tst[0]
    for n, j, t in zip(jst[0], jst[1], tst[1]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32_TOL,
                                   err_msg=n)


def _port_greedy(cfg, params, prompt, n_new, *, max_seq=96,
                 attn_impl="full", dtype=torch.bfloat16):
    """Model-level greedy decode of one request from a fresh cache (of
    ``dtype``; the server's is bf16): the prompt teacher-forced token by
    token, then argmax fed back."""
    cache = tmodel.init_cache(cfg, 1, max_seq, dtype=dtype, device="cpu")
    out = []
    tok = None
    for t in range(len(prompt) + n_new - 1):
        cur = int(prompt[t]) if t < len(prompt) else out[-1]
        lg, _ = tmodel.decode_step(
            params, cfg, cache, torch.tensor([[cur]]),
            np.array([t], np.int32), attn_impl=attn_impl)
        if t >= len(prompt) - 1:
            tok = int(lg[0].argmax())
            out.append(tok)
    return out


def test_greedy_streams_match_jax(f32_model):
    """Greedy decode from a fresh cache: the same tokens in both
    packages (prompt teacher-forced, then 24 tokens fed back; f32
    caches: with a bf16 cache JAX's conv state turns f32 after the first
    step, the port's stays in the cache's dtype)."""
    jcfg, cfg, jparams, params = f32_model
    rng = np.random.RandomState(4)
    decode = _jax_decode(jcfg)
    for plen in (5, 11):
        prompt = rng.randint(0, cfg.vocab_size, plen).astype(np.int32)
        jc = jmodel.init_cache(jcfg, 1, 96, dtype=jnp.float32)
        jout = []
        for t in range(plen + 23):
            cur = int(prompt[t]) if t < plen else jout[-1]
            lg, jc = decode(jparams, jc, jnp.asarray([[cur]], jnp.int32),
                            jnp.asarray([t], jnp.int32))
            if t >= plen - 1:
                jout.append(int(np.asarray(lg)[0].argmax()))
        assert _port_greedy(cfg, params, prompt, 24,
                            dtype=torch.float32) == jout


def test_decode_inactive_slot_state_stays_bit_exact(f32_model):
    """A decode step with an active mask leaves the inactive slot's
    recurrent state (``h`` and ``conv``) and ring rows bit-exact, and the
    active slots equal an unmasked step."""
    _, cfg, _, params = f32_model
    B = 3
    rng = np.random.RandomState(8)
    cache = tmodel.init_cache(cfg, B, 96, device="cpu")
    for t in range(4):            # some non-zero state in every slot
        tmodel.decode_step(params, cfg, cache, torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (B, 1))).long(),
            np.full(B, t, np.int32))
    ref = {"stages": [{p: {k: v.clone() for k, v in blk.items()}
                       for p, blk in st.items()} for st in cache["stages"]]}
    snap = [t.clone() for t in _flatten_with_names(cache)[1]]
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, 1))).long()
    pos = np.full(B, 4, np.int32)
    active = torch.tensor([True, False, True])
    lg, _ = tmodel.decode_step(params, cfg, cache, tok, pos, active=active)
    lg_all, _ = tmodel.decode_step(params, cfg, ref, tok, pos)
    for before, now, full in zip(snap, _flatten_with_names(cache)[1],
                                 _flatten_with_names(ref)[1]):
        assert torch.equal(now[:, 1], before[:, 1])
        assert torch.equal(now[:, 0], full[:, 0])
        assert torch.equal(now[:, 2], full[:, 2])
    assert torch.equal(lg[active], lg_all[active])


def _serve(cfg, params, reqs, slots, attn_impl="full"):
    srv = DecodeServer(cfg, params, ServeConfig(
        batch_slots=slots, max_seq=96, attn_impl=attn_impl), device="cpu")
    assert not srv._slot_prefill      # recurrent models prime per token
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return srv, [r.out for r in reqs]


def _reqs(cfg, seed, n, new=8):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               3 + (5 * i) % 9),
                    max_new_tokens=new + i % 3) for i in range(n)]


@pytest.mark.parametrize("attn_impl", ["full", "kernel"])
def test_server_streams_equal_model_greedy(f32_model, attn_impl):
    """Five requests over two slots (per-token priming, slots reused):
    every stream equals the model-level greedy decode of its request
    alone from a fresh cache."""
    _, cfg, _, params = f32_model
    reqs = _reqs(cfg, 1, 5)
    srv, outs = _serve(cfg, params, reqs, 2, attn_impl)
    assert srv.prefill_dispatches == sum(len(r.prompt) for r in reqs)
    for r, out in zip(reqs, outs):
        assert out == _port_greedy(cfg, params, r.prompt, r.max_new_tokens,
                                   attn_impl=attn_impl), r.rid


def test_reused_slot_equals_fresh_server(f32_model):
    """One slot: the second request runs in the slot the first left with
    a non-zero recurrent state, and gives the stream a fresh server
    gives it."""
    _, cfg, _, params = f32_model
    first, second = _reqs(cfg, 2, 2, new=6)
    _, outs = _serve(cfg, params, [first, second], 1)
    fresh = Request(rid=9, prompt=second.prompt,
                    max_new_tokens=second.max_new_tokens)
    _, (alone,) = _serve(cfg, params, [fresh], 1)
    assert outs[1] == alone


def test_hybrid_refuses_slot_prefill_paged_and_spec(f32_model):
    """As in JAX: no chunked prefill, paged KV, prefix sharing or
    speculative decoding for recurrent blocks."""
    _, cfg, _, params = f32_model
    assert not (tmodel.supports_slot_prefill(cfg)
                or tmodel.supports_paged_kv(cfg)
                or tmodel.supports_spec_decode(cfg)
                or tmodel.supports_prefix_share(cfg))
    cache = tmodel.init_cache(cfg, 2, 32, device="cpu")
    with pytest.raises(ValueError, match="recurrent"):
        tmodel.prefill_into_slots(params, cfg, cache,
                                  torch.zeros(2, 4, dtype=torch.long),
                                  np.array([4, 4]))
    with pytest.raises(ValueError, match="recurrent"):
        tmodel.verify_into_slots(params, cfg, cache,
                                 torch.zeros(2, 2, dtype=torch.long),
                                 np.array([0, 0]), np.array([True, True]))
    with pytest.raises(ValueError, match="paged"):
        tmodel.init_paged_cache(cfg, 2, 9, 16, 32, device="cpu")
