"""Port model (``repro_torch.models``) against the JAX package.

Both packages get the same weights (the JAX ``init_params`` tree through
``repro_torch.interop``) and the same numpy token ids.  Logits of
``prefill_into_slots`` and of 8 chained ``decode_step``s must match:
``attn_impl="full"`` against JAX's ``full`` path and ``"kernel"`` (on
the CPU: the kernel's plain version) against JAX's ``pallas_interpret``
path.  f32 models with f32 KV caches: rtol 1e-4 / atol 2e-5 (the two
packages multiply in different orders; a bf16 cache would turn those
last-bit differences into whole bf16 rounding steps of K/V).  bf16
models with the serving default bf16 cache: atol 3e-2 (bf16 rounds at
other places in the two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro.configs.base import (BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN,
                                ModelConfig)
from repro.configs.base import get_config as jget_config
from repro.launch.train import reduce_config as jreduce_config
from repro.models import model as jmodel
from repro_torch import interop
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.configs import base as tconfigs
from repro_torch.models import model as tmodel

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_ATOL = 3e-2
B, MAX_SEQ, STEPS = 4, 32, 8


def _port_cfg(jcfg):
    """The same architecture as a port ModelConfig."""
    import dataclasses
    return tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


def _jax_params(cfg, dtype=jnp.float32):
    return jmodel.init_params(jax.random.PRNGKey(0), cfg, dtype=dtype)


def _to_port(params):
    return interop.tree_to_torch(jax.tree.map(np.asarray, params),
                                 device="cpu")


def _inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    lengths = np.asarray([12, 7, 0, 9], np.int32)      # slot 2 not primed
    prompt = rng.randint(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    fed = rng.randint(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    return prompt, lengths, fed


def _cache_dtype(cfg):
    return "float32" if cfg.dtype == "float32" else "bfloat16"


def _jax_run(cfg, params, impl, prompt, lengths, fed):
    cache = jmodel.init_cache(cfg, B, MAX_SEQ,
                              dtype=getattr(jnp, _cache_dtype(cfg)))
    prefill = jax.jit(lambda p, c, t, n: jmodel.prefill_into_slots(
        p, cfg, c, t, n))
    decode = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, cfg, c, t, pos, attn_impl=impl))
    out = []
    lg, cache = prefill(params, cache, jnp.asarray(prompt),
                        jnp.asarray(lengths))
    out.append(np.asarray(lg, np.float32))
    pos = lengths.copy()
    for t in fed:
        lg, cache = decode(params, cache, jnp.asarray(t[:, None]),
                           jnp.asarray(pos))
        out.append(np.asarray(lg, np.float32))
        pos = pos + 1
    return out


def _port_run(cfg, params, impl, prompt, lengths, fed):
    cache = tmodel.init_cache(cfg, B, MAX_SEQ, device="cpu",
                              dtype=getattr(torch, _cache_dtype(cfg)))
    out = []
    lg, _ = tmodel.prefill_into_slots(params, cfg, cache,
                                      torch.from_numpy(prompt), lengths)
    out.append(lg.float().numpy())
    pos = lengths.copy()
    for t in fed:
        lg, _ = tmodel.decode_step(params, cfg, cache,
                                   torch.from_numpy(t[:, None]),
                                   torch.from_numpy(pos), attn_impl=impl)
        out.append(lg.float().numpy())
        pos = pos + 1
    return out


def _local_cfg():
    return ModelConfig(name="tiny-local", family="dense", num_layers=4,
                       d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                       vocab_size=128, remat=False, dtype="float32",
                       pattern=(BLOCK_LOCAL_ATTN, BLOCK_GLOBAL_ATTN),
                       window_size=8)


@pytest.mark.parametrize("arch", ["tiny", "internlm2-reduced", "local-ring"])
@pytest.mark.parametrize("impl", ["full", "kernel"])
def test_prefill_and_decode_logits_match_jax(tiny_cfg, arch, impl):
    if arch == "tiny":
        jcfg = tiny_cfg.replace(dtype="float32")       # GQA: 4 heads / 2
    elif arch == "internlm2-reduced":
        jcfg = jreduce_config(jget_config("internlm2-1.8b"),
                              8).replace(dtype="float32")
    else:
        jcfg = _local_cfg()                            # ring-buffer blocks
    jparams = _jax_params(jcfg)
    cfg, params = _port_cfg(jcfg), _to_port(jparams)
    prompt, lengths, fed = _inputs(jcfg)
    jimpl = {"full": "full", "kernel": "pallas_interpret"}[impl]
    want = _jax_run(jcfg, jparams, jimpl, prompt, lengths, fed)
    got = _port_run(cfg, params, impl, prompt, lengths, fed)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **F32_TOL)


def test_bf16_model_logits_match_jax(tiny_cfg):
    jcfg = tiny_cfg                                    # dtype bfloat16
    jparams = _jax_params(jcfg)
    cfg, params = _port_cfg(jcfg), _to_port(jparams)
    prompt, lengths, fed = _inputs(jcfg, seed=1)
    want = _jax_run(jcfg, jparams, "full", prompt, lengths, fed)
    got = _port_run(cfg, params, "full", prompt, lengths, fed)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=BF16_ATOL, err_msg=f"step {i}")


def test_forward_logits_match_jax(tiny_cfg):
    jcfg = tiny_cfg.replace(dtype="float32")
    jparams = _jax_params(jcfg)
    toks = np.random.RandomState(3).randint(0, 128, (2, 16)).astype(np.int32)
    want, _, _ = jmodel.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got = tmodel.forward(_to_port(jparams), _port_cfg(jcfg),
                         torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_interop_round_trip_bit_exact(tiny_cfg, dtype):
    jparams = _jax_params(tiny_cfg, dtype)
    named = dict(zip(*jflat(jparams)[:2]))
    port = _to_port(jparams)
    names, leaves, _ = _flatten_with_names(port)
    assert names == list(named)
    back = interop.named_numpy(port)
    for name, arr in named.items():
        a = np.asarray(arr)
        assert back[name].dtype == a.dtype and back[name].shape == a.shape
        assert back[name].tobytes() == a.tobytes(), name
    # and the tree structure survives too
    rt = interop.tree_to_numpy(port)
    assert jax.tree.structure(rt) == jax.tree.structure(
        jax.tree.map(np.asarray, jparams))


def test_port_init_params_has_jax_layout(tiny_cfg):
    """The port's own init builds the JAX tree: same leaf paths, shapes
    and dtypes (so adapters and fingerprints carry across)."""
    for jcfg in (tiny_cfg, _local_cfg()):
        jnames, jleaves, _ = jflat(_jax_params(jcfg))
        tp = tmodel.init_params(_port_cfg(jcfg), device="cpu",
                                generator=torch.Generator().manual_seed(0))
        names, leaves, _ = _flatten_with_names(tp)
        assert names == jnames
        assert [tuple(x.shape) for x in leaves] == \
            [tuple(x.shape) for x in jleaves]
        assert all(x.dtype == torch.float32 for x in leaves)


def test_inactive_slot_cache_rows_stay_bit_exact(tiny_cfg):
    cfg = _port_cfg(tiny_cfg.replace(dtype="float32"))
    params = _to_port(_jax_params(tiny_cfg.replace(dtype="float32")))
    prompt, lengths, fed = _inputs(cfg)
    cache = tmodel.init_cache(cfg, B, MAX_SEQ, device="cpu")
    tmodel.prefill_into_slots(params, cfg, cache, torch.from_numpy(prompt),
                              lengths)
    # the un-primed slot 2 was not touched by the prefill
    for st in cache["stages"]:
        for blk in st.values():
            assert not blk["k"][:, 2].any() and not blk["v"][:, 2].any()
    snap = [{k: {kk: t.clone() for kk, t in b.items()} for k, b in
             st.items()} for st in cache["stages"]]
    ref_cache = [{k: {kk: t.clone() for kk, t in b.items()} for k, b in
                  st.items()} for st in cache["stages"]]
    active = torch.tensor([True, False, True, True])
    pos = torch.from_numpy(lengths.copy())
    lg, _ = tmodel.decode_step(params, cfg, cache,
                               torch.from_numpy(fed[0][:, None]), pos,
                               active=active)
    lg_all, _ = tmodel.decode_step(params, cfg, {"stages": ref_cache},
                                   torch.from_numpy(fed[0][:, None]), pos)
    for st, before, full in zip(cache["stages"], snap, ref_cache):
        for name, blk in st.items():
            for kk in ("k", "v"):
                assert torch.equal(blk[kk][:, 1], before[name][kk][:, 1])
                for s in (0, 2, 3):
                    assert torch.equal(blk[kk][:, s], full[name][kk][:, s])
    assert torch.equal(lg[active], lg_all[active])


def test_unported_families_raise():
    for arch in ("qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-1.3b"):
        cfg = tconfigs.reduce_config(tconfigs.get_config(arch), 8)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmodel.init_params(cfg, device="cpu")
