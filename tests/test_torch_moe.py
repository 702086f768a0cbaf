"""The port's MoE family (``repro_torch.models.moe``) against the JAX package.

Both packages get the same weights (JAX's tree through
``repro_torch.interop``) and the same numpy inputs, on reduced
``granite-moe-3b-a800m`` (8 experts, top-8, no shared expert) and
reduced ``qwen2-moe-a2.7b`` (8 experts, top-4, a shared expert), f32.

Tolerances, and why:

- ``moe_apply``: rtol 1e-5 / atol 1e-6 (the expert products and the
  softmax sum in another order); the routes (top-k experts in order and
  the keep mask) exactly equal, with and without drops and over token
  chunks;
- ``loss_fn`` rtol 1e-5, its gradients (the router's included: it gets
  one through the top-k weights and one through the aux loss) rtol 1e-4
  / atol 1e-6, as ``tests/test_torch_model.py``;
- the BlockLLM trajectory under the bounds of
  ``tests/test_torch_blockllm.py`` (Adam eps 1e-3, masks >= 99.9% equal,
  the final selection close on >= 99.5% of elements);
- serving: streams equal.  Both sides set ``capacity_factor = E / k``,
  so no pair is dropped: the port primes on a fixed chunk grid (ROADMAP
  C2) where JAX buckets its last chunk, and a chunk of another width
  has another T and so another capacity.  With drops, rows are compared
  for the same group and chunk shape (``prefill_into_slots``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.adapters import InMemoryRegistry as JInMemory
from repro.adapters import apply_delta as japply
from repro.adapters import extract_delta as jextract
from repro.adapters import quantize_delta as jquantize
from repro.adapters.testing import perturb_rows as jperturb
from repro import trainers as jtrainers
from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro.configs.base import get_config as jget_config
from repro.core import units as junits
from repro.core.blockllm import BlockLLMConfig as JBConfig
from repro.core.selection import SelectorConfig as JSelector
from repro.data.pipeline import DataConfig, TokenPipeline
from repro.kernels import decode_attention as jda
from repro.kernels import ref as jref
from repro.launch.train import reduce_config as jreduce
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.optim.adam import Adam as JAdam
from repro.runtime.serve_config import KVConfig as JKV
from repro.runtime.serve_config import SchedConfig as JSched
from repro.runtime.serve_config import ServeConfig as JServeConfig
from repro.runtime.serve_loop import DecodeServer as JServer
from repro.runtime.serve_loop import Request as JRequest
from repro_torch import adapters as tad
from repro_torch import interop, trainers
from repro_torch.adapters import InMemoryRegistry, extract_delta
from repro_torch.adapters.testing import perturb_rows
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.configs import base as tconfigs
from repro_torch.core import units as tunits
from repro_torch.core.blockllm import BlockLLMConfig
from repro_torch.core.selection import SelectorConfig
from repro_torch.kernels import decode_attention as da
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.optim.adam import Adam
from repro_torch.runtime.serve_config import KVConfig, SchedConfig, ServeConfig
from repro_torch.runtime.serve_loop import DecodeServer, Request

torch.set_num_threads(2)

ARCHS = ("granite-moe-3b-a800m", "qwen2-moe-a2.7b")
MOE_TOL = dict(rtol=1e-5, atol=1e-6)


def _cfgs(arch, dtype="float32", **kw):
    jcfg = jreduce(jget_config(arch), 8).replace(dtype=dtype, **kw)
    return jcfg, tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


def _to_port(tree):
    return interop.tree_to_torch(jax.tree.map(np.asarray, tree),
                                 device="cpu")


def _jax_routes(p, xt, cfg, C):
    """JAX ``_moe_chunk``'s routes: top-k experts in order, keep mask."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = (xt @ p["router"].astype(xt.dtype)).astype(jnp.float32)
    _, topi = lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat = topi.reshape(-1)
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    rank = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot,
                               flat[:, None], axis=1)[:, 0]
    return np.asarray(topi), np.asarray(rank < C).reshape(-1, k)


def _moe_params(jcfg):
    return jmoe.moe_init(jax.random.PRNGKey(3), jcfg)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["no_drops", "drops", "token_chunks"])
def test_moe_apply_matches_jax(arch, case):
    """Reduced granite has no shared expert, reduced qwen2-moe has one.
    ``drops``: capacity 8 for 64 tokens; ``token_chunks``: 4 chunks of
    16 tokens (capacity per chunk, the aux loss averaged)."""
    jcfg, cfg = _cfgs(arch)
    jp = _moe_params(jcfg)
    tp = _to_port(jp)
    assert ("shared" in tp) == bool(cfg.shared_expert_d_ff)
    x = np.random.RandomState(1).randn(4, 16, cfg.d_model).astype(np.float32)
    kw = {"no_drops": {}, "drops": {"capacity": 8},
          "token_chunks": {"token_chunk": 16}}[case]
    jy, jaux = jax.jit(lambda p, a: jmoe.moe_apply(p, a, jcfg, **kw))(
        jp, jnp.asarray(x))
    with tmoe.route_log(keep_routes=True) as log:
        ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), cfg, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    chunk = kw.get("token_chunk", 64)
    C = kw.get("capacity") or jmoe._capacity(chunk, jcfg)
    assert len(log.routes) == 64 // chunk
    dropped = 0
    for i, (topi, keep, _) in enumerate(log.routes):
        xt = jnp.asarray(x.reshape(64, -1)[i * chunk:(i + 1) * chunk])
        jtopi, jkeep = _jax_routes(jp, xt, jcfg, C)
        np.testing.assert_array_equal(topi.numpy(), jtopi)
        np.testing.assert_array_equal(keep.numpy(), jkeep)
        dropped += int((~jkeep).sum())
    assert log.dropped == dropped and log.pairs == 64 * cfg.num_experts_per_tok
    if case != "token_chunks":      # 16-token chunks may drop a few
        assert (dropped > 0) == (case == "drops")
    if case == "no_drops":
        # without drops the capacity dispatch is the dense reference
        ry, _ = tmoe.moe_apply_dense_ref(tp, torch.from_numpy(x), cfg)
        jry, _ = jmoe.moe_apply_dense_ref(jp, jnp.asarray(x), jcfg)
        np.testing.assert_allclose(ry.numpy(), np.asarray(jry), **MOE_TOL)
        np.testing.assert_allclose(ty.numpy(), ry.numpy(), **MOE_TOL)


def test_top_k_tie_order_equals_lax():
    """Exact ties (integer logits, bf16-rounded logits over 40 experts):
    the port's top-k, in order, is ``lax.top_k``'s."""
    rng = np.random.RandomState(0)
    for logits in (rng.randint(0, 4, (256, 40)).astype(np.float32),
                   np.asarray(jnp.asarray(rng.randn(256, 40) * 0.05,
                                          jnp.bfloat16), np.float32)):
        probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        jv, ji = lax.top_k(jnp.asarray(probs), 8)
        tv, ti = tmoe.top_k(torch.from_numpy(probs), 8)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_tied_router_routes_equal_jax():
    """A bf16 router whose expert columns come in equal pairs, so every
    token's probabilities tie pairwise: routes, drops and outputs of
    ``moe_apply`` equal JAX's (bf16 atol 2e-2: bf16 rounds at other
    places in the two frameworks)."""
    jcfg, cfg = _cfgs("qwen2-moe-a2.7b", dtype="bfloat16")
    jp = _moe_params(jcfg)
    r = np.asarray(jp["router"])
    jp["router"] = jnp.asarray(np.repeat(r[:, ::2], 2, axis=1))
    tp = _to_port(jp)
    x = np.random.RandomState(2).randn(4, 16, cfg.d_model).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jy, _ = jmoe.moe_apply(jp, xb, jcfg, capacity=12)
    with tmoe.route_log(keep_routes=True) as log:
        ty, _ = tmoe.moe_apply(tp, torch.from_numpy(x).bfloat16(), cfg,
                               capacity=12)
    (topi, keep, probs), = log.routes
    assert (probs[:, 0::2] == probs[:, 1::2]).all()
    jtopi, jkeep = _jax_routes(jp, xb.reshape(64, -1), jcfg, 12)
    np.testing.assert_array_equal(topi.numpy(), jtopi)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert not jkeep.all()
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_matches_jax(arch):
    """The Switch load-balancing loss: ``coef * E * sum(mean probs *
    routed fraction)``, one chunk and averaged over 8 chunks; the dense
    reference carries none."""
    jcfg, cfg = _cfgs(arch)
    jp = _moe_params(jcfg)
    tp = _to_port(jp)
    x = np.random.RandomState(4).randn(2, 32, cfg.d_model).astype(np.float32)
    for chunk in (64, 8):
        _, ja = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, token_chunk=chunk)
        _, ta = tmoe.moe_apply(tp, torch.from_numpy(x), cfg,
                               token_chunk=chunk)
        assert ta.dtype == torch.float32 and ta.item() > 0
        np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-5)
    _, za = tmoe.moe_apply_dense_ref(tp, torch.from_numpy(x), cfg)
    assert za.item() == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` (cross entropy + the layers' aux losses) and its
    gradient with respect to every leaf, the routers' included, against
    JAX's ``value_and_grad``."""
    jcfg, cfg = _cfgs(arch)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)},
                                 attn_impl="full"), has_aux=True))(jparams)
    names, leaves, td = _flatten_with_names(_to_port(jparams))
    req = [leaf.requires_grad_() for leaf in leaves]
    tl, tm = tmodel.loss_fn(td.unflatten(req), cfg,
                            {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(tl, req)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tm["aux"].item(), float(jm["aux"]),
                               rtol=1e-5)
    assert tm["aux"].item() > 0
    jnames, jleaves, _ = jflat(jg)
    assert jnames == names
    assert any("router" in n for n in names)
    for name, want, got in zip(names, jleaves, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


LR, EPS, STEPS = 1e-3, 1e-3, 6
SELECTOR = dict(sparsity=0.9, policy="static", static_k_frac=0.34,
                reselect_every=3, probe_rows_per_stack=1)


def _flat(tree, port):
    leaves = _flatten_with_names(tree)[1] if port else jflat(tree)[1]
    return np.concatenate([np.asarray(l.numpy() if port else l,
                                      np.float32).ravel() for l in leaves])


def test_blockllm_trajectory_matches_jax():
    """6 ``blockllm`` steps on reduced granite at 2 layers (3-D expert
    rows selected whole with their layer, the router trained through the
    aux loss), two selections, the bounds of
    ``tests/test_torch_blockllm.py``."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", num_layers=2)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    jh = jtrainers.handle(
        "blockllm", jcfg, jparams, adam=JAdam(lr=LR, eps=EPS),
        bcfg=JBConfig(selector=JSelector(**SELECTOR)))
    th = trainers.handle(
        "blockllm", cfg, _to_port(jparams), device="cpu",
        adam=Adam(lr=LR, eps=EPS),
        bcfg=BlockLLMConfig(selector=SelectorConfig(**SELECTOR)))
    pipe = TokenPipeline(DataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                    global_batch=4, seed=0))
    for step in range(STEPS):
        batch = pipe.batch(step)
        mj = jh.train_step(batch)
        mt = th.train_step({"tokens": np.asarray(batch["tokens"])})
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-4,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(mt["aux"], mj["aux"], rtol=1e-4)
        for key in ("stack_idx", "probe_idx", "active_leaves", "q",
                    "reselections"):
            assert th.state.meta[key] == jh.state.meta[key], (step, key)
        if not jh.state.meta["needs_mask_refresh"]:
            same = (_flat(th.state.arrays["masks"], True)
                    == _flat(jh.state.arrays["masks"], False))
            assert same.mean() >= 0.999, (step, same.mean())
    assert jh.state.meta["reselections"] == 1 + STEPS // 3
    sel = th.state.arrays["sel"]["stacks"]
    assert any(a.dim() == 4 for a in _flatten_with_names(sel)[1])
    a = _flat(jh.state.arrays["sel"], False)
    b = _flat(th.state.arrays["sel"], True)
    close = np.abs(b - a) <= 1e-5 + 1e-3 * np.abs(a)
    assert close.mean() >= 0.995, close.mean()
    assert np.abs(b - a).max() <= STEPS * LR


def test_units_and_q8_expert_deltas_match_jax():
    """Reduced qwen2-moe: the unit index (one unit per layer row, its
    experts, router and shared expert inside it) equals JAX's; a tenant
    whose rows 1 of every stack changed (``[E, d, f]`` expert rows) is
    extracted, quantized to q8 and applied bitwise as JAX does, and
    reverts exactly."""
    jcfg, cfg = _cfgs("qwen2-moe-a2.7b")
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = _to_port(jparams)
    jidx = junits.build_unit_index(jcfg, jparams)
    tidx = tunits.build_unit_index(cfg, params)
    assert dataclasses.asdict(tidx) == dataclasses.asdict(jidx)
    # ``param_count`` (JAX's formula) leaves out the final norm's scale
    assert cfg.param_count() == jcfg.param_count()
    assert tidx.total_params == cfg.param_count() + cfg.d_model
    jq = jquantize(jextract(jparams, jperturb(jparams, rows=(1,), seed=3)))
    tq = tad.quantize_delta(tad.extract_delta(params, perturb_rows(
        params, rows=(1,), seed=3)))
    assert sorted(tq.entries) == sorted(jq.entries)
    assert any("w_gate" in n for n in tq.entries)
    for name, je in jq.entries.items():
        te = tq.entries[name]
        assert te.quantized == je.quantized, name
        np.testing.assert_array_equal(te.idx, np.asarray(je.idx))
        assert (interop.named_numpy({"r": te.rows})["r"].tobytes()
                == np.asarray(je.rows).tobytes()), name
    want, _ = japply(jparams, jq)
    new, disp = tad.apply_delta(_to_port(jparams), tq)
    got = interop.named_numpy(new)
    for n, leaf in zip(*jflat(want)[:2]):
        assert got[n].tobytes() == np.asarray(leaf).tobytes(), n
    back = interop.named_numpy(tad.revert_delta(new, disp, donate=True))
    for n, leaf in zip(*jflat(jparams)[:2]):
        assert back[n].tobytes() == np.asarray(leaf).tobytes(), n


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

TENANTS = [None, "demo0", "demo1"]
LENS = [5, 11, 3, 9, 7, 4]


@pytest.fixture(scope="module")
def served():
    """Reduced qwen2-moe with ``capacity_factor = E / k`` (no drops),
    its weights in both packages and two demo tenants whose deltas touch
    the stacked expert rows."""
    jcfg, cfg = _cfgs("qwen2-moe-a2.7b", capacity_factor=8 / 4)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = _to_port(jparams)
    jreg, reg = JInMemory(), InMemoryRegistry()
    for i, aid in enumerate(TENANTS[1:]):
        jreg.put(aid, jextract(jparams, jperturb(jparams, rows=(1 + i % 2,),
                                                 seed=i)))
        reg.put(aid, extract_delta(params, perturb_rows(
            params, rows=(1 + i % 2,), seed=i)))
    return jcfg, jparams, jreg, cfg, params, reg


def _requests(cls, vocab):
    rng = np.random.default_rng(7)
    return [cls(rid=i, prompt=rng.integers(1, vocab, n).astype(np.int32),
                max_new_tokens=5, adapter_id=TENANTS[i % 3])
            for i, n in enumerate(LENS)]


@pytest.mark.parametrize("impl", ["full", "kernel"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_server_streams_match_jax(served, layout, impl):
    """Base + 2 tenants over 3 slots, chunked prefill; the port's
    ``kernel`` (the plain version on the CPU) against JAX's
    ``pallas_interpret``, ``full`` against ``full``."""
    jcfg, jparams, jreg, cfg, params, reg = served
    jimpl = {"full": "full", "kernel": "pallas_interpret"}[impl]
    kv = dict(layout=layout, page_size=8, prefix_share=False)
    jsrv = JServer(jcfg, jparams, JServeConfig(
        batch_slots=3, max_seq=32, attn_impl=jimpl, prefill_chunk=8,
        kv=JKV(**kv), sched=JSched(steps_per_turn=2)), registry=jreg)
    srv = DecodeServer(cfg, params, ServeConfig(
        batch_slots=3, max_seq=32, attn_impl=impl, prefill_chunk=8,
        kv=KVConfig(**kv), sched=SchedConfig(steps_per_turn=2)),
        registry=reg, device="cpu")
    jreqs = _requests(JRequest, jcfg.vocab_size)
    reqs = _requests(Request, cfg.vocab_size)
    for jr, r in zip(jreqs, reqs):
        jsrv.submit(jr)
        srv.submit(r)
    jsrv.run_until_drained()
    with tmoe.route_log() as log:
        srv.run_until_drained()
    assert log.pairs > 0 and log.dropped == 0
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert all(len(r.out) == 5 for r in reqs)
    assert srv.steps == jsrv.steps and srv.swaps == jsrv.swaps


def _prefill_both(jcfg, cfg, jparams, params, prompt, lengths):
    B, S = prompt.shape
    jcache = jmodel.init_cache(jcfg, B, 32, dtype=jnp.float32)
    jlg, jcache = jmodel.prefill_into_slots(
        jparams, jcfg, jcache, jnp.asarray(prompt), jnp.asarray(lengths))
    cache = tmodel.init_cache(cfg, B, 32, dtype=torch.float32, device="cpu")
    with tmoe.route_log() as log:
        lg, _ = tmodel.prefill_into_slots(params, cfg, cache,
                                          torch.from_numpy(prompt), lengths)
    return np.asarray(jlg), jcache, lg.numpy(), cache, log


def test_prefill_rows_match_jax_with_drops():
    """``prefill_into_slots`` at capacity factor 0.5 (capacity 16 for
    4 x 16 rows of 4 picks each, so pairs drop; padding rows and the idle
    slot 2 route too): logits and every written K/V row equal JAX's for
    the same group and chunk shape (f32 rtol 1e-4 / atol 2e-5, as
    ``tests/test_torch_model.py``)."""
    jcfg, cfg = _cfgs("qwen2-moe-a2.7b", capacity_factor=0.5)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = _to_port(jparams)
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    lengths = np.asarray([16, 7, 0, 11], np.int32)
    jlg, jcache, lg, cache, log = _prefill_both(jcfg, cfg, jparams, params,
                                                prompt, lengths)
    assert log.pairs == cfg.num_layers * 4 * 16 * 4 and log.dropped > 0
    for s in (0, 1, 3):
        np.testing.assert_allclose(lg[s], jlg[s], rtol=1e-4, atol=2e-5)
    for st, jst in zip(cache["stages"], jcache["stages"]):
        for name, blk in st.items():
            for kk in ("k", "v"):
                for s, n in enumerate(lengths):
                    np.testing.assert_allclose(
                        blk[kk][:, s, :n].numpy(),
                        np.asarray(jst[name][kk])[:, s, :n], rtol=1e-4,
                        atol=2e-5)


def test_prefill_rows_depend_on_the_group_alike_in_both_packages():
    """Padding and idle rows take expert capacity (ROADMAP C, faults of
    the reference): the same prompt in slot 1 gives other logits when a
    prompt in slot 0 shares its chunk than beside an idle slot 0 (token 0
    in every row, as both servers feed it; slot 0's rows rank first), in
    JAX and in the port alike."""
    jcfg, cfg = _cfgs("qwen2-moe-a2.7b", capacity_factor=0.5)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = _to_port(jparams)
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    idle = prompt.copy()
    idle[0] = 0
    alone = _prefill_both(jcfg, cfg, jparams, params, idle,
                          np.asarray([0, 16], np.int32))
    grouped = _prefill_both(jcfg, cfg, jparams, params, prompt,
                            np.asarray([16, 16], np.int32))
    for jlg, _, lg, _, _ in (alone, grouped):
        np.testing.assert_allclose(lg[1], jlg[1], rtol=1e-4, atol=2e-5)
    assert np.abs(alone[0][1] - grouped[0][1]).max() > 1e-3
    assert np.abs(alone[2][1] - grouped[2][1]).max() > 1e-3


def test_plain_decode_attention_g3_matches_jax():
    """GQA 24 / 8's group of 3 query heads at head_dim 64 (granite's
    decode shape, reduced): the plain version against the JAX oracle and
    the Pallas kernel in interpret mode (f32 rtol 1e-4 / atol 2e-5, as
    ``tests/test_torch_kernels.py``), ragged positions."""
    rng = np.random.RandomState(0)
    B, C, H, KV, hd = 3, 96, 6, 2, 64
    q = rng.randn(B, 1, H, hd).astype(np.float32)
    k = rng.randn(B, C, KV, hd).astype(np.float32)
    v = rng.randn(B, C, KV, hd).astype(np.float32)
    pos = np.asarray([0, 40, 95], np.int32)
    got = da.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(pos), block_k=32)
    oracle = jref.decode_attention_ref(q, k, v, pos)
    pallas = jda.decode_attention_fwd(q, k, v, pos, block_k=32,
                                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=1e-4, atol=2e-5)
    assert 3 in da._KERNEL_GROUPS and 3 in da._PAGED_KERNEL_GROUPS
