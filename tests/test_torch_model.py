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
                                BLOCK_MLSTM, BLOCK_SLSTM, ModelConfig)
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


def _prefill_cfg(tiny_cfg, arch):
    """The architecture and prompt length of a prefill case."""
    if arch == "tiny":
        return tiny_cfg.replace(dtype="float32"), 16
    if arch == "local-ring":
        return _local_cfg(), 16
    if arch.startswith("hybrid"):       # RG-LRU, RG-LRU, local attention
        cfg = jreduce_config(jget_config("recurrentgemma-2b"), 8).replace(
            num_layers=3, dtype="float32")
        # "hybrid-short": fewer tokens than the conv's W - 1 = 3 inputs,
        # so the conv state keeps zero padding
        return cfg, (2 if arch == "hybrid-short" else 16)
    cfg = jget_config("xlstm-1.3b").replace(      # an mLSTM and an sLSTM
        num_layers=2, pattern=(BLOCK_MLSTM, BLOCK_SLSTM), d_model=64,
        num_heads=2, num_kv_heads=2, vocab_size=256, dtype="float32",
        remat=False)
    return cfg, 16


def _cache_pairs(cache, jcache):
    """``(name, port leaf, JAX leaf)`` of every stage cache leaf: by name,
    except an xLSTM state, which JAX keeps as a tuple in the order the
    port's dict has (``xlstm.MLSTM_FRESH`` / ``SLSTM_FRESH``)."""
    out = []
    for si, st in enumerate(cache["stages"]):
        for pos, blk in st.items():
            jb = jcache["stages"][si][pos]
            for i, (n, a) in enumerate(blk.items()):
                out.append((f"{si}/{pos}/{n}", a,
                            jb[i] if isinstance(jb, (tuple, list)) else jb[n]))
    assert len(out) == len(jax.tree.leaves(jcache["stages"]))
    return out


@pytest.mark.parametrize("arch", ["tiny", "local-ring", "hybrid",
                                  "hybrid-short", "xlstm"])
def test_whole_sequence_prefill_matches_jax(tiny_cfg, arch):
    """``prefill`` (``forward(mode="prefill")``): the last position's
    logits and every block's cache leaves against JAX's ``prefill``: an
    attention block's K/V rows (a local block keeps its window's rows in
    the ring layout decode writes: 16 tokens over a window of 8), an
    RG-LRU block's final ``h`` (the scan, the B7 kernel on the card) and
    conv state (the last W - 1 inputs; at 2 tokens they include the zero
    padding), an mLSTM's and an sLSTM's final states.  Then 4 decode
    steps from ``init_cache`` with the prefill cache copied in, against
    JAX's from its own: logits and, at the end, every cache leaf."""
    jcfg, S = _prefill_cfg(tiny_cfg, arch)
    cfg = _port_cfg(jcfg)
    jparams = _jax_params(jcfg)
    params = _to_port(jparams)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    fed = rng.randint(0, jcfg.vocab_size, (4, 2, 1)).astype(np.int32)
    jlast, jcache = jax.jit(lambda p, t: jmodel.prefill(
        p, jcfg, {"tokens": t}))(jparams, jnp.asarray(toks))
    with torch.no_grad():
        last, cache = tmodel.prefill(params, cfg,
                                     {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **F32_TOL)
    for n, a, b in _cache_pairs(cache, jcache):
        assert tuple(a.shape) == tuple(b.shape), n
        assert str(a.dtype)[6:] == str(np.asarray(b).dtype), n
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=n,
                                   **F32_TOL)
    # decode on from the prefill: its leaves copied into init_cache's
    # (an attention block's rows into the first S rows)
    jdec = jax.tree.map(
        lambda a, b: b if a.shape == b.shape else a.at[:, :, :S].set(b),
        jmodel.init_cache(jcfg, 2, MAX_SEQ, dtype=jnp.float32), jcache)
    dec = tmodel.init_cache(cfg, 2, MAX_SEQ, dtype=torch.float32,
                            device="cpu")
    for (n, a, _), (_, b, _) in zip(_cache_pairs(dec, jdec),
                                    _cache_pairs(cache, jcache)):
        a[:, :, :b.shape[2]] = b
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, jcfg, c, t,
                                                           pos))
    for t, tok in enumerate(fed):
        pos = np.full(2, S + t, np.int32)
        jlg, jdec = step(jparams, jdec, jnp.asarray(tok), jnp.asarray(pos))
        with torch.no_grad():
            lg, _ = tmodel.decode_step(params, cfg, dec,
                                       torch.from_numpy(tok).long(), pos)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **F32_TOL,
                                   err_msg=f"decode step {t}")
    for n, a, b in _cache_pairs(dec, jdec):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=n,
                                   **F32_TOL)


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
    """What the port still refuses: a family it does not know, and
    experts outside the MoE family; every family of the zoo inits."""
    base = tconfigs.reduce_config(tconfigs.get_config("internlm2-1.8b"), 8)
    for cfg, why in ((base.replace(family="diffusion"), "diffusion"),
                     (base.replace(num_experts=4, num_experts_per_tok=2,
                                   moe_d_ff=32), "experts")):
        with pytest.raises(NotImplementedError, match=why):
            tmodel.init_params(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match=why):
            tmodel.init_cache(cfg, 1, 8, device="cpu")
    for arch in ("pixtral-12b", "whisper-large-v3", "xlstm-1.3b",
                 "granite-moe-3b-a800m", "recurrentgemma-2b"):
        tmodel.check_supported(tconfigs.get_config(arch))


def test_whisper_init_and_forward():
    """``whisper-large-v3``, reduced, inits with ``lnx`` / ``xattn`` on
    every decoder row and an ``encoder`` subtree, and runs ``forward``
    (with frames), ``loss_fn``, ``prefill`` and a decode step over the
    prefill's ``cross_kv`` on the CPU: finite logits of the expected
    shape; without frames ``forward`` raises."""
    cfg = tconfigs.reduce_config(tconfigs.get_config("whisper-large-v3"), 8)
    tmodel.check_supported(cfg)
    params = tmodel.init_params(cfg, device="cpu")
    blk = params["stages"][0]["pos0"]
    assert {"lnx", "xattn"} <= set(blk) and "xattn" not in \
        params["encoder"]["stages"][0]["pos0"]
    assert set(params["encoder"]) == {"frontend", "stages", "final_norm"}
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    frames = torch.randn(2, cfg.encoder_seq_len, cfg.encoder_feature_dim,
                         generator=g)
    logits = tmodel.forward(params, cfg, toks, frames=frames)
    loss, _ = tmodel.loss_fn(params, cfg, {"tokens": toks,
                                           "frames": frames})
    last, pre = tmodel.prefill(params, cfg, {"tokens": toks,
                                             "frames": frames})
    cache = tmodel.init_cache(cfg, 2, 16, device="cpu")
    cache["cross_kv"] = pre["cross_kv"]
    step, _ = tmodel.decode_step(params, cfg, cache, toks[:, :1],
                                 np.zeros(2, np.int32))
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(loss)
    assert torch.equal(last, logits[:, -1])
    assert torch.isfinite(step).all()
    with pytest.raises(ValueError, match="frames"):
        tmodel.forward(params, cfg, toks)


def test_xlstm_init_and_forward():
    """``xlstm-1.3b``, reduced, inits with mLSTM and sLSTM rows (no
    ``ln1`` / ``ln2``) and runs ``forward``, ``loss_fn`` and a decode step
    on the CPU: finite logits of the expected shape."""
    cfg = tconfigs.reduce_config(tconfigs.get_config("xlstm-1.3b"), 8)
    tmodel.check_supported(cfg)
    params = tmodel.init_params(cfg, device="cpu")
    st = params["stages"][0]
    assert set(st["pos0"]) == {"norm", "w_up", "wq", "wk", "wv", "w_if",
                               "b_i", "b_f", "gn", "w_down"}
    assert "r_f" in st["pos7"] and "ln1" not in st["pos7"]
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    logits = tmodel.forward(params, cfg, toks)
    loss, _ = tmodel.loss_fn(params, cfg, {"tokens": toks})
    cache = tmodel.init_cache(cfg, 2, 16, device="cpu")
    step, _ = tmodel.decode_step(params, cfg, cache, toks[:, :1],
                                 np.zeros(2, np.int32))
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(loss)
    assert torch.isfinite(step).all()


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_moe_archs_init_and_forward(arch):
    """Both MoE archs, reduced, init with an ``moe`` leaf per block (a
    shared expert where the config has one) and run ``forward`` on the
    CPU: finite logits of the expected shape and a positive aux loss."""
    cfg = tconfigs.reduce_config(tconfigs.get_config(arch), 8)
    tmodel.check_supported(cfg)
    params = tmodel.init_params(cfg, device="cpu")
    blk = params["stages"][0]["pos0"]
    assert "moe" in blk and "mlp" not in blk
    assert ("shared" in blk["moe"]) == bool(cfg.shared_expert_d_ff)
    G, E = cfg.num_layers, cfg.num_experts
    assert blk["moe"]["w_gate"].shape == (G, E, cfg.d_model, cfg.moe_d_ff)
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    logits = tmodel.forward(params, cfg, toks)
    _, metrics = tmodel.loss_fn(params, cfg, {"tokens": toks})
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all() and metrics["aux"].item() > 0


@pytest.mark.parametrize("loss_chunk,labels,remat", [
    (0, False, False), (8, False, False), (0, True, False), (8, True, True)])
def test_loss_and_grads_match_jax(tiny_cfg, loss_chunk, labels, remat):
    """``loss_fn`` (direct and sequence-chunked cross entropy, given
    labels with ignored positions, remat) and its gradient with respect
    to every leaf against JAX's ``value_and_grad`` of its ``loss_fn``:
    loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6 (f32 sums in
    another order)."""
    jcfg = tiny_cfg.replace(dtype="float32", remat=remat)
    jparams = _jax_params(jcfg)
    rng = np.random.RandomState(5)
    batch = {"tokens": rng.randint(0, 128, (2, 16)).astype(np.int32)}
    if labels:
        batch["labels"] = rng.randint(-1, 128, (2, 16)).astype(np.int32)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch),
                                 attn_impl="full", loss_chunk=loss_chunk),
        has_aux=True)(jparams)
    names, leaves, td = _flatten_with_names(_to_port(jparams))
    req = [leaf.requires_grad_() for leaf in leaves]
    tl, tm = tmodel.loss_fn(td.unflatten(req), _port_cfg(jcfg),
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            loss_chunk=loss_chunk)
    grads = torch.autograd.grad(tl, req)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert tm["tokens"].item() == float(jm["tokens"])
    jnames, jleaves, _ = jflat(jg)
    assert jnames == names
    for name, want, got in zip(names, jleaves, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
