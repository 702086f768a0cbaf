"""The port's ``layers.attention_chunked`` (the long-context attention, and
the recompute of ``ops.flash_attention``'s backward) against the JAX
package, and the model's chunked branch (``attn_impl="chunked"`` past
2048 tokens) against JAX's ``loss_fn``.

Inputs are made with numpy from a seed and given to both packages; model
weights come from JAX's ``init_params`` through ``repro_torch.interop``.
Tolerances, and why:

- ``attention_chunked`` in f32: values rtol 1e-4 / atol 2e-5 and q/k/v
  gradients rtol 1e-4 / atol 1e-4 (sums in other orders); in bf16 atol
  2e-2 for values (one bf16 rounding step below 4: the scores and
  probabilities round to bf16 on both sides, at other places in the two
  frameworks' products) and 5e-2 for gradients (accumulated over three
  kv-chunks in bf16);
- the model's loss with ``attn_impl="chunked"`` in f32: rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.launch.train import reduce_config as jreduce
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import interop
from repro_torch.configs import base as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

torch.set_num_threads(2)

F32_ATOL, GRAD_ATOL = 2e-5, 1e-4
BF16_ATOL, BF16_GRAD_ATOL = 2e-2, 5e-2


def _qkv(B, Sq, Sk, H, KV, hd, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, hd).astype(np.float32),
            rng.randn(B, Sk, KV, hd).astype(np.float32),
            rng.randn(B, Sk, KV, hd).astype(np.float32))


# ------------------------------------------------------ attention_chunked


@pytest.mark.parametrize("causal,window,softcap,dtype,KV", [
    (True, 0, 0.0, "float32", 2),
    (True, 1100, 0.0, "float32", 1),    # lo > 0: q-chunk 2 skips kv-chunk 0
    (False, 0, 30.0, "float32", 4),     # softcap, every kv-chunk visited
    (True, 1500, 0.0, "bfloat16", 2)])
def test_attention_chunked_matches_jax(causal, window, softcap, dtype, KV):
    """S = 3072 with 1024-row chunks: three q-chunks, the causal limit
    and the window's lower limit skip kv-chunks; values and q/k/v
    gradients of sum(o * w) against JAX's ``jax.vjp``."""
    B, S, H, hd = 1, 3072, 4, 8
    q, k, v = _qkv(B, S, S, H, KV, hd, seed=4)
    w = np.random.RandomState(5).randn(B, S, H, hd).astype(np.float32)
    jdt = getattr(jnp, dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    jin = [jnp.asarray(a, jdt) for a in (q, k, v)]
    kw = dict(causal=causal, window=window, softcap=softcap)
    jo, jvjp = jax.vjp(lambda *a: jlayers.attention_chunked(
        *a, jnp.asarray(pos), jnp.asarray(pos), **kw), *jin)
    jg = jvjp(jnp.asarray(w, jdt))
    tdt = getattr(torch, dtype)
    tin = [torch.tensor(np.asarray(a, np.float32)).to(tdt).requires_grad_()
           for a in jin]
    tpos = torch.from_numpy(pos.copy())
    to = tlayers.attention_chunked(*tin, tpos, tpos, **kw)
    tg = torch.autograd.grad(to, tin, torch.from_numpy(w).to(tdt))
    assert to.dtype == tdt
    f32 = dtype == "float32"
    np.testing.assert_allclose(to.detach().float().numpy(),
                               np.asarray(jo, np.float32),
                               rtol=1e-4 if f32 else 0,
                               atol=F32_ATOL if f32 else BF16_ATOL)
    for name, got, want in zip("qkv", tg, jg):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-4 if f32 else 0,
                                   atol=GRAD_ATOL if f32 else BF16_GRAD_ATOL,
                                   err_msg=f"d{name}")


def test_attention_chunked_equals_full_in_f32():
    """The port's chunked attention against its own full attention
    (softcap, window, GQA; chunks smaller than S), f32."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 384, 384, 4, 2, 16,
                                                  seed=6))
    pos = torch.arange(384)[None].expand(2, 384)
    for kw in (dict(window=100), dict(softcap=20.0), dict(causal=False)):
        got = tlayers.attention_chunked(q, k, v, pos, pos, q_chunk=128,
                                        kv_chunk=64, **kw)
        want = tlayers.attention_full(q, k, v, pos, pos, **kw)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=F32_ATOL)


# ------------------------------------------------- the model's branch


def _model(arch, **replace):
    jcfg = jreduce(jget_config(arch), 8).replace(dtype="float32", **replace)
    jparams = jax.jit(lambda key: jmodel.init_params(key, jcfg))(
        jax.random.PRNGKey(0))
    params = interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jcfg, tconfigs.ModelConfig(**dataclasses.asdict(jcfg)), \
        jparams, params


@pytest.mark.parametrize("arch,replace", [
    ("internlm2-1.8b", dict(num_layers=2)),
    ("recurrentgemma-2b", dict(num_layers=3))])    # window 64: lo > 0
def test_loss_chunked_attention_matches_jax(arch, replace, monkeypatch):
    """``model.loss_fn(attn_impl="chunked")`` at S = 3072 > 2048 runs
    ``attention_chunked`` in every attention block, and its loss equals
    JAX's ``loss_fn(attn_impl="chunked")`` within rtol 1e-4 (f32)."""
    jcfg, cfg, jparams, params = _model(arch, **replace)
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, cfg.vocab_size, (1, 3072)).astype(np.int32)
    jl = jax.jit(lambda p, t: jmodel.loss_fn(
        p, jcfg, {"tokens": t}, attn_impl="chunked")[0])(
            jparams, jnp.asarray(tokens))
    calls = []
    chunked = tlayers.attention_chunked
    monkeypatch.setattr(tlayers, "attention_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    with torch.no_grad():
        tl, _ = tmodel.loss_fn(params, cfg,
                               {"tokens": torch.from_numpy(tokens)},
                               attn_impl="chunked")
    attn_blocks = sum(t != "recurrent" for t in cfg.layer_types())
    assert len(calls) == attn_blocks > 0
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)


def test_default_attn_impl_is_chunked_as_jax(monkeypatch):
    """``forward`` and ``loss_fn`` called without ``attn_impl`` run the
    chunked branch past 2048 tokens, as JAX's defaults do: at S = 3072 the
    port's logits and loss agree with JAX's (called without the keyword
    too) within the chunked branch's f32 tolerances, and the port's default
    equals its explicit ``attn_impl="chunked"`` bitwise."""
    jcfg, cfg, jparams, params = _model("internlm2-1.8b", num_layers=2)
    tokens = np.random.RandomState(9).randint(
        0, cfg.vocab_size, (1, 3072)).astype(np.int32)
    jt = jnp.asarray(tokens)
    jlog = jax.jit(lambda p, t: jmodel.forward(p, jcfg, {"tokens": t})[0])(
        jparams, jt)
    jl = jax.jit(lambda p, t: jmodel.loss_fn(p, jcfg, {"tokens": t})[0])(
        jparams, jt)
    calls = []
    chunked = tlayers.attention_chunked
    monkeypatch.setattr(tlayers, "attention_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    tt = torch.from_numpy(tokens).long()
    with torch.no_grad():
        log = tmodel.forward(params, cfg, tt)
        assert len(calls) == cfg.num_layers
        tl, _ = tmodel.loss_fn(params, cfg, {"tokens": tt})
        log_c = tmodel.forward(params, cfg, tt, attn_impl="chunked")
        tl_c, _ = tmodel.loss_fn(params, cfg, {"tokens": tt},
                                 attn_impl="chunked")
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog, np.float32),
                               rtol=1e-4, atol=F32_ATOL)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    assert torch.equal(log, log_c) and torch.equal(tl, tl_c)


def test_forward_and_loss_take_attn_impl(tiny_cfg, monkeypatch):
    """``forward`` takes ``attn_impl`` (full / chunked; chunked only past
    2048 tokens, as JAX), both refuse anything else, and a BlockLLM trainer
    made with ``attn_impl="chunked"`` reaches the chunked branch."""
    from repro_torch import trainers
    from repro_torch.optim.adam import Adam
    cfg = tconfigs.ModelConfig(**dataclasses.asdict(tiny_cfg)).replace(
        num_layers=2, dtype="float32")
    params = tmodel.init_params(cfg, generator=torch.Generator(
        "cpu").manual_seed(0), device="cpu")
    calls = []
    chunked = tlayers.attention_chunked
    monkeypatch.setattr(tlayers, "attention_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    toks = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, (1, 2048)).astype(np.int64))
    with torch.no_grad():
        short = tmodel.forward(params, cfg, toks, attn_impl="chunked")
        assert not calls                       # S <= 2048: full attention
        torch.testing.assert_close(short, tmodel.forward(params, cfg, toks))
        long = torch.cat([toks, toks], dim=1)
        a = tmodel.forward(params, cfg, long, attn_impl="chunked")
        assert len(calls) == cfg.num_layers
        b = tmodel.forward(params, cfg, long, attn_impl="full")
    torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5)
    for fn in (lambda: tmodel.forward(params, cfg, toks, attn_impl="kernel"),
               lambda: tmodel.loss_fn(params, cfg, {"tokens": toks},
                                      attn_impl="pallas")):
        with pytest.raises(ValueError, match="attn_impl"):
            fn()
    calls.clear()
    core = trainers.make("blockllm", cfg, adam=Adam(lr=1e-3),
                         attn_impl="chunked", device="cpu")
    state = core.init(torch.Generator("cpu").manual_seed(0))
    state, m = core.step(state, {"tokens": long[:, :3072]})
    assert calls and np.isfinite(m["loss"])
