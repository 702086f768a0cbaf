"""The rest of the zoo in the port against the JAX package: ``gemma3-1b``
(26 layers of 5 local : 1 global attention blocks, a 512-token window,
MQA 4 / 1 at head_dim 256, GeGLU, a tied 262144-row vocabulary),
``gemma-2b`` (MQA 8 / 1 at head_dim 256, GeGLU, a tied 256000-row
vocabulary) and ``deepseek-7b`` (llama-style MHA 32 / 32 at head_dim
128, SwiGLU, an untied head).

Two cuts of each architecture, never at full width on the CPU:

- ``reduced``: ``reduce_config(arch, 8)`` of both packages (the same
  shapes; one query head, so no grouping is left; ``gemma3-1b`` keeps its
  6-block pattern and a 64-token window);
- ``grouped``: each source's head grouping at narrow widths (head_dim
  32): G = 4 over one kv head (``gemma3-1b``, 8 layers, so the stack has
  the remainder stage ``(local, local)`` after one full pattern, and a
  window of 8), G = 8 over one (``gemma-2b``) and MHA (``deepseek-7b``).

Weights go across from JAX's ``init_params`` through
``repro_torch.interop``; tokens are numpy draws from a seed.  Tolerances,
and why:

- logits, caches and decode logits: rtol 1e-4 / atol 2e-5 (``F32_TOL``,
  the model tolerance of the other port tests: the two frameworks
  multiply in other orders);
- ``loss_fn``: rtol 1e-5;
- gradients: ``F32_TOL`` with the atol times the leaf's largest
  magnitude where that exceeds 1 (``SCALED``, as the other port tests);
- the BlockLLM trajectory: ``tests/test_torch_blockllm.py``'s bounds;
- token streams, selections, counts and predicates: equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro.configs.base import get_config as jget_config
from repro.core import units as junits
from repro.launch.train import reduce_config as jreduce
from repro.models import model as jmodel
from repro.runtime.serve_config import KVConfig as JKV
from repro.runtime.serve_config import ServeConfig as JServeConfig
from repro.runtime.serve_config import SpecConfig as JSpec
from repro.runtime.serve_loop import DecodeServer as JServer
from repro.runtime.serve_loop import Request as JRequest
from repro_torch import interop
from repro_torch.adapters import InMemoryRegistry, extract_delta
from repro_torch.adapters.testing import perturb_rows
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.configs import base as tconfigs
from repro_torch.configs.base import BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN
from repro_torch.core import units as tunits
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.runtime.serve_config import KVConfig, ServeConfig, SpecConfig
from repro_torch.runtime.serve_loop import DecodeServer, Request
from tests.test_torch_blockllm import run_trajectory

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=2e-5)
SCALED = "scaled"
ARCHS = ("gemma3-1b", "gemma-2b", "deepseek-7b")
VARIANTS = ("reduced", "grouped")
GROUPED = {
    "gemma3-1b": dict(num_layers=8, num_heads=4, num_kv_heads=1,
                      window_size=8),
    "gemma-2b": dict(num_layers=2, num_heads=8, num_kv_heads=1),
    "deepseek-7b": dict(num_layers=2, num_heads=4, num_kv_heads=4),
}
NARROW = dict(d_model=64, head_dim=32, d_ff=128, vocab_size=256)
# (query heads, kv heads, head_dim, window, tied, vocab) of each source
SOURCE = {"gemma3-1b": (4, 1, 256, 512, True, 262144),
          "gemma-2b": (8, 1, 256, 0, True, 256000),
          "deepseek-7b": (32, 32, 128, 0, False, 102400)}


def _cfgs(arch, variant="reduced", **kw):
    jcfg = jreduce(jget_config(arch), 8)
    if variant == "grouped":
        jcfg = jcfg.replace(**NARROW, **GROUPED[arch])
    jcfg = jcfg.replace(dtype="float32", remat=False, **kw)
    return jcfg, tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _model(arch, variant):
    """(jcfg, cfg, JAX params, the port's copy of them)."""
    jcfg, cfg = _cfgs(arch, variant)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, _port(jparams)


def _port(jparams):
    return interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                                 device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, msg=""):
    want = np.asarray(want)
    if tol == SCALED:
        tol = dict(F32_TOL, atol=F32_TOL["atol"] * max(
            1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else got, want,
        **tol, err_msg=msg)


CASES = [pytest.param(a, v, id=f"{a}-{v}") for a in ARCHS for v in VARIANTS]

# ------------------------------------------------------- config, support


@pytest.mark.parametrize("arch", ARCHS)
def test_config_param_count_and_support_match_jax(arch):
    """The port's config equals JAX's field for field, ``reduce_config``
    builds JAX's reduced shapes, ``param_count`` is JAX's and the size of
    JAX's full-size tree (through ``jax.eval_shape``: no weights) less the
    final norm, and the four support predicates agree with JAX's on the
    full, reduced and grouped configs: ``gemma3-1b`` takes chunked slot
    prefill and paged KV but neither speculation nor prefix sharing (its
    local blocks keep per-slot ring rows); the all-global models take
    all four."""
    j, t = jget_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    H, KV, hd, window, tied, vocab = SOURCE[arch]
    assert (t.num_heads, t.num_kv_heads, t.resolved_head_dim, t.window_size,
            t.tie_embeddings, t.vocab_size) == (H, KV, hd, window, tied,
                                                vocab)
    for f in (2, 8):
        assert dataclasses.asdict(tconfigs.reduce_config(t, f)) == \
            dataclasses.asdict(jreduce(j, f))
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, j),
                            jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert t.param_count() == j.param_count() == n - t.d_model
    assert ("head" in shapes) is not tied
    tmodel.check_supported(t)
    local = BLOCK_LOCAL_ATTN in t.pattern
    want = {"supports_slot_prefill": True, "supports_paged_kv": True,
            "supports_spec_decode": not local,
            "supports_prefix_share": not local}
    for jc, c in ((j, t), _cfgs(arch), _cfgs(arch, "grouped")):
        for fn, w in want.items():
            assert getattr(tmodel, fn)(c) is getattr(jmodel, fn)(jc) is w, \
                (c.num_layers, fn)


def test_gemma3_stages_hold_the_remainder_stage():
    """``gemma3-1b``'s 26 layers are 4 full patterns and the remainder
    ``(local, local)``; the grouped cut's 8 are one pattern and the same
    remainder, in both packages."""
    full = tconfigs.get_config("gemma3-1b")
    pattern = (BLOCK_LOCAL_ATTN,) * 5 + (BLOCK_GLOBAL_ATTN,)
    assert full.stages() == [(pattern, 4), ((BLOCK_LOCAL_ATTN,) * 2, 1)]
    jcfg, cfg = _cfgs("gemma3-1b", "grouped")
    assert cfg.stages() == jcfg.stages() == [
        (pattern, 1), ((BLOCK_LOCAL_ATTN,) * 2, 1)]


@pytest.mark.parametrize("arch,variant", CASES)
def test_init_layout_and_units_match_jax(arch, variant):
    """The port's ``init_params`` has JAX's leaf paths and shapes (no
    ``head`` when the embedding is tied: it is the head), and BlockLLM's
    units (sizes, labels) are JAX's on the same tree."""
    jcfg, cfg, jparams, params = _model(arch, variant)
    mine = tmodel.init_params(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(1))
    tn, tl, _ = _flatten_with_names(mine)
    jn, jl, _ = jflat(jparams)
    assert tn == jn
    assert [tuple(a.shape) for a in tl] == [tuple(a.shape) for a in jl]
    assert ("head" in mine) is not cfg.tie_embeddings
    assert tuple(mine["embed"].shape) == (cfg.vocab_size, cfg.d_model)
    assert set(tunits.build_unit_index(cfg, params).unit_sizes()) == \
        set(jmodel.param_labels(jcfg, jparams))
    assert junits.build_unit_index(jcfg, jparams).unit_sizes() == \
        tunits.build_unit_index(cfg, params).unit_sizes()


# ------------------------------------------------------------ model, loss


@pytest.mark.parametrize("arch,variant", CASES)
def test_forward_loss_and_grads_match_jax(arch, variant):
    """``forward(mode="train")`` logits with ``attn_impl`` ``full`` and
    ``chunked`` (the same attention below 2048 tokens, in both packages),
    ``loss_fn`` and its gradient with respect to every leaf (the tied
    ``embed`` takes the head's gradient too), against JAX's."""
    jcfg, cfg, jparams, params = _model(arch, variant)
    tokens = np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    tt = _t(tokens).long()
    jbatch = {"tokens": jnp.asarray(tokens)}

    def jloss(p):
        loss, _ = jmodel.loss_fn(p, jcfg, jbatch, loss_chunk=0,
                                 attn_impl="full")
        return loss, jmodel.forward(p, jcfg, jbatch, attn_impl="full")[0]

    (jl, jlog), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    with torch.no_grad():
        for impl in ("full", "chunked"):
            _close(tmodel.forward(params, cfg, tt, attn_impl=impl), jlog,
                   F32_TOL, impl)
    names, leaves, td = _flatten_with_names(params)
    req = [a.detach().clone().requires_grad_() for a in leaves]
    tl, _ = tmodel.loss_fn(td.unflatten(req), cfg, {"tokens": tt},
                           loss_chunk=0, attn_impl="full")
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, req)
    jnames, jleaves, _ = jflat(jg)
    assert jnames == names
    for n, g, j in zip(names, grads, jleaves):
        assert g.abs().max() > 0, n
        _close(g, j, SCALED, n)


def test_gemma3_chunked_attention_past_2048_matches_jax():
    """Past 2048 tokens ``attn_impl="chunked"`` runs blockwise attention
    in both packages; ``gemma3-1b``'s local blocks then visit only the
    key chunks inside their 512-token window.  Narrow widths, the
    source's 6-block pattern and window, 3072 tokens: the logits against
    JAX's."""
    jcfg, cfg = _cfgs("gemma3-1b", "grouped", num_layers=6, window_size=512,
                      d_model=32, head_dim=16, d_ff=64, vocab_size=128)
    jparams = jmodel.init_params(jax.random.PRNGKey(5), jcfg)
    params = _port(jparams)
    tokens = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (1, 3072)).astype(np.int32)
    jlog, _, _ = jax.jit(lambda p: jmodel.forward(
        p, jcfg, {"tokens": jnp.asarray(tokens)}, attn_impl="chunked"))(
        jparams)
    with torch.no_grad():
        got = tmodel.forward(params, cfg, _t(tokens).long(),
                             attn_impl="chunked")
    _close(got, jlog, F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_blockllm_trajectory_matches_jax(arch):
    """``tests/test_torch_blockllm.py``'s trajectory for 4 steps (the mask
    refresh, three masked steps and the reselection after the last) on
    the grouped cut: losses, selections (the port must select what JAX
    selects, every step), masks and the final selected rows, with its
    bounds.  ``gemma3-1b``'s pattern is cut to one local and one global
    block (JAX's train step compiles each pattern position; the remainder
    stage is held in the gradient test), with an 8-token window shorter
    than the 32-token batch rows."""
    kw = {**NARROW, **GROUPED[arch]}
    if arch == "gemma3-1b":
        kw.update(num_layers=2, pattern=(BLOCK_LOCAL_ATTN, BLOCK_GLOBAL_ATTN))
    jh, th = run_trajectory("off", arch, steps=4, **kw)
    assert th.state.meta["stack_idx"] == jh.state.meta["stack_idx"]


# ---------------------------------------------------------------- decoding


def _jax_greedy(jcfg, jparams, tokens, n_new, max_seq):
    jlast, jpre = jax.jit(lambda p, t: jmodel.prefill(
        p, jcfg, {"tokens": t}))(jparams, jnp.asarray(tokens))
    cache = jmodel.init_cache(jcfg, tokens.shape[0], max_seq,
                              dtype=jnp.float32)
    cache = {"stages": jax.tree.map(
        lambda a, b: a.at[:, :, :b.shape[2]].set(b), cache["stages"],
        jpre["stages"])}
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, jcfg, c, t, pos, attn_impl="full"))
    tok = np.asarray(jnp.argmax(jlast, -1), np.int32)
    out, logits = [tok], [np.asarray(jlast)]
    S = tokens.shape[1]
    for i in range(n_new):
        lg, cache = step(jparams, cache, jnp.asarray(tok[:, None]),
                         jnp.full((tokens.shape[0],), S + i, jnp.int32))
        tok = np.asarray(jnp.argmax(lg, -1), np.int32)
        out.append(tok)
        logits.append(np.asarray(lg))
    return np.stack(out, 1), logits, jpre


@pytest.mark.parametrize("arch,variant", [
    c for c in CASES if c.values[1] == "grouped"
    or c.values[0] == "gemma3-1b"])
def test_prefill_and_greedy_decode_match_jax(arch, variant):
    """Whole-sequence ``prefill`` (its last logits and every K/V row: a
    local block's last ``window`` rows in the ring layout, the prompt
    longer than the window so the ring has wrapped), the rows copied into
    ``init_cache``, then greedy ``decode_step``s past the prompt (the
    local rings wrap again): every step's logits against JAX's, for
    ``full`` attention and the decode kernel's plain version, and the
    greedy streams equal JAX's.  The reduced cut runs for ``gemma3-1b``
    alone (its 64-token window; the other two are the grouped cut's
    shapes with one head)."""
    jcfg, cfg, jparams, params = _model(arch, variant)
    S = 80 if cfg.window_size == 64 else 20
    n_new, max_seq = 12, 96
    tokens = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    want, jlogits, jpre = _jax_greedy(jcfg, jparams, tokens, n_new, max_seq)
    with torch.no_grad():
        last, pre = tmodel.prefill(params, cfg, {"tokens": _t(tokens).long()})
    names, leaves, _ = _flatten_with_names(pre["stages"])
    jnames, jleaves, _ = jflat(jpre["stages"])
    assert names == jnames
    for n, a, b in zip(names, leaves, jleaves):
        assert tuple(a.shape) == tuple(b.shape), n
        _close(a, b, F32_TOL, n)
    _close(last, jlogits[0], F32_TOL)
    for impl in ("full", "kernel"):
        cache = tmodel.init_cache(cfg, 2, max_seq, dtype=torch.float32,
                                  device="cpu")
        for a, b in zip(_flatten_with_names(cache["stages"])[1], leaves):
            a[:, :, :b.shape[2]] = b
        tok = _t(want[:, 0]).long()
        with torch.no_grad():
            for i in range(n_new):
                lg, _ = tmodel.decode_step(
                    params, cfg, cache, tok[:, None],
                    np.full(2, S + i, np.int32), attn_impl=impl)
                _close(lg, jlogits[i + 1], F32_TOL, f"{impl} step {i}")
                tok = lg.argmax(-1)
                assert torch.equal(tok, _t(want[:, i + 1]).long()), (impl, i)


# ------------------------------------------------------------- the servers

LENS = (19, 5, 26, 11, 17)


def _prompts(cfg, lens, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _port_serve(cfg, params, prompts, *, new=6, registry=None, tenancy=None,
                **kw):
    srv = DecodeServer(cfg, params, ServeConfig(
        batch_slots=3, max_seq=48, attn_impl="full", prefill_chunk=16, **kw),
        registry=registry, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new,
                    adapter_id=None if tenancy is None else tenancy[i])
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    assert all(r.done for r in reqs)
    return [tuple(r.out) for r in reqs], srv


def _jax_serve(jcfg, jparams, prompts, *, new=6, registry=None,
               tenancy=None, **kw):
    srv = JServer(jcfg, jparams, JServeConfig(
        batch_slots=3, max_seq=48, attn_impl="full", prefill_chunk=16, **kw),
        registry=registry)
    # wait on each of JAX's dispatches: its per-token priming rewrites a
    # host buffer that a zero-copy jnp.asarray may still read (ROADMAP C)
    decode = srv._decode
    srv._decode = lambda *a: jax.block_until_ready(decode(*a))
    reqs = [JRequest(rid=i, prompt=p, max_new_tokens=new,
                     adapter_id=None if tenancy is None else tenancy[i])
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return [tuple(r.out) for r in reqs], srv


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_server_streams_match_jax(arch, layout):
    """Five requests over three slots (so slots are reused), prompts of 5
    to 27 tokens primed by chunked slot prefill in 16-token chunks (twice
    ``gemma3-1b``'s 8-token window: a chunk's own ring writes wrap, and
    its history rows are read before they are overwritten; the rings wrap
    again while a prompt decodes), the grouped cut: the port's
    ``DecodeServer`` streams equal JAX's on the same weights, dense and
    paged (page size 8); paged equals dense in the port; the paged
    server's page tables and kv counters are JAX's.  ``gemma3-1b``'s paged
    server keeps its local blocks' dense rings beside the global blocks'
    page pools and shares no prefix; the all-global models share one."""
    jcfg, cfg, jparams, params = _model(arch, "grouped")
    prompts = _prompts(cfg, LENS)
    # the fourth request, admitted after the first wave, shares the
    # first one's two leading pages
    prompts[3] = np.concatenate([prompts[0][:16], prompts[3]])
    kv = {} if layout == "dense" else dict(kv=KVConfig(layout="paged",
                                                       page_size=8))
    jkv = {} if layout == "dense" else dict(kv=JKV(layout="paged",
                                                   page_size=8))
    got, srv = _port_serve(cfg, params, prompts, **kv)
    want, jsrv = _jax_serve(jcfg, jparams, prompts, **jkv)
    assert got == want
    assert srv.steps == jsrv.steps
    if layout == "dense":
        return
    dense, _ = _port_serve(cfg, params, prompts)
    assert got == dense
    local = BLOCK_LOCAL_ATTN in cfg.pattern
    assert srv.alloc.share_prefix is (not local) is jsrv.alloc.share_prefix
    assert srv.alloc.table().tolist() == jsrv.alloc.table().tolist()
    assert srv.stats()["kv"] == jsrv.stats()["kv"]
    assert (srv.stats()["kv"]["prefix_hit_pages"] > 0) is (not local)
    kinds = {n.split("/")[-1] for n in _flatten_with_names(
        srv.cache_state)[0]}
    assert kinds == ({"k", "v", "pk", "pv"} if local else {"pk", "pv"})


def test_gemma3_refuses_speculation_as_jax():
    """Speculative decoding raises for ``gemma3-1b`` in both packages (a
    rejected draft row would clobber a live ring row), dense and paged."""
    jcfg, cfg, jparams, params = _model("gemma3-1b", "grouped")
    for layout in ("dense", "paged"):
        with pytest.raises(ValueError, match="speculate"):
            DecodeServer(cfg, params, ServeConfig(
                batch_slots=2, max_seq=48, kv=KVConfig(layout=layout),
                spec=SpecConfig(draft=2)), device="cpu")
        with pytest.raises(ValueError, match="speculate"):
            JServer(jcfg, jparams, JServeConfig(
                batch_slots=2, max_seq=48, kv=JKV(layout=layout),
                spec=JSpec(draft=2)))


def test_gemma3_reused_ring_slot_equals_a_fresh_server():
    """One slot, two requests longer than the window: the second request
    primes a ring the first left full, and its stream equals a fresh
    server's (ring rows are masked by position, none is reset)."""
    _, cfg, _, params = _model("gemma3-1b", "grouped")
    first, second = _prompts(cfg, (21, 14), seed=9)
    for layout in ("dense", "paged"):
        kv = KVConfig(layout=layout, page_size=8)
        srv = DecodeServer(cfg, params, ServeConfig(
            batch_slots=1, max_seq=48, attn_impl="full", prefill_chunk=16,
            kv=kv), device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate((first, second))]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        alone, _ = _port_serve(cfg, params, [second], kv=kv)
        assert tuple(reqs[1].out) == alone[0], layout


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_gemma2b_speculation_and_prefix_share_match_jax(layout):
    """``gemma-2b`` (all global) takes speculative decoding, dense and
    paged with prefix sharing: base and tenant requests over one
    perturbed tenant, the base drafting 3 tokens a round; the port's
    streams equal its plain streams and, paged, JAX's speculative
    streams (JAX's dense server: ``test_server_streams_match_jax``)."""
    jcfg, cfg, jparams, params = _model("gemma-2b", "grouped")
    reg = InMemoryRegistry()
    reg.put("t", extract_delta(params, perturb_rows(params, rows=(1,),
                                                    scale=0.05, seed=3),
                               meta={"adapter_id": "t"}))
    prompts = _prompts(cfg, LENS, seed=11)
    tenancy = ["t", None, "t", "t", None]
    kv = {} if layout == "dense" else dict(kv=KVConfig(layout="paged",
                                                       page_size=8))
    jkv = {} if layout == "dense" else dict(kv=JKV(layout="paged",
                                                   page_size=8))
    plain, _ = _port_serve(cfg, params, prompts, registry=reg,
                           tenancy=tenancy, **kv)
    spec, srv = _port_serve(cfg, params, prompts, registry=reg,
                            tenancy=tenancy, spec=SpecConfig(draft=3), **kv)
    assert spec == plain
    st = srv.stats()["spec"]
    assert st["rounds"] > 0 and st["drafted"] > 0
    if layout == "dense":
        return
    from repro.adapters import InMemoryRegistry as JRegistry
    from repro.adapters import extract_delta as jextract
    from repro.adapters.testing import perturb_rows as jperturb
    jreg = JRegistry()
    jreg.put("t", jextract(jparams, jperturb(jparams, rows=(1,), scale=0.05,
                                             seed=3),
                           meta={"adapter_id": "t"}))
    want, _ = _jax_serve(jcfg, jparams, prompts, registry=jreg,
                         tenancy=tenancy, spec=JSpec(draft=3), **jkv)
    assert spec == want


# ------------------------------------------------------------ the launchers


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_the_arch_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch <arch> --reduce 8
    --device cpu`` (finite losses near ln(vocab)) and ``python -m
    repro_torch.launch.serve --arch <arch> --reduce 8 --device cpu``,
    dense and ``--paged`` (every request complete; ``gemma3-1b`` shares
    no prefix pages, the all-global models do)."""
    out = tlaunch.main(["--device", "cpu", "--arch", arch, "--reduce", "8",
                        "--steps", "2", "--batch", "2", "--seq", "16"])
    losses = np.asarray(out["losses"])
    assert np.isfinite(losses).all() and len(losses) == 2
    assert abs(losses[0] - np.log(2048)) < 1.0
    for extra in ([], ["--paged"]):
        reqs = tserve.main(["--device", "cpu", "--arch", arch, "--reduce",
                            "8", "--requests", "4", "--new-tokens", "4",
                            "--slots", "2", "--steps-per-turn", "2"]
                           + extra)
        assert all(r.done and len(r.out) == 4 for r in reqs)
    printed = capsys.readouterr().out
    line = next(l for l in printed.splitlines() if l.startswith("paged KV:"))
    hits = int(line.split("prefix hits ")[1].split()[0])
    assert (hits == 0) is (arch == "gemma3-1b")
