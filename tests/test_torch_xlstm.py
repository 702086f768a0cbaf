"""The xLSTM family (``xlstm-1.3b``) in the port against the JAX package,
and its serving in the port.

The architecture is ``xlstm-1.3b`` cut to d_model 64, 2 heads, vocab 256
and 8 layers: one whole pattern, 7 mLSTM blocks (inner width 128, head
dim 64) and an sLSTM block (head dim 32).  Both packages get the same
weights (the port's ``init_params`` from a seed, carried to JAX through
``repro_torch.interop``; JAX's own init costs a compile and is held
against the port's by its shapes) and the same numpy inputs.
Tolerances, and why:

- mLSTM chunkwise outputs and final ``(C, n, m)``: atol 5e-5, the bound
  of JAX's own chunkwise-vs-recurrent test (``tests/test_models.py``);
  the two frameworks sum the same f32 products in other orders;
- block functions, ``mlstm_step``, ``_slstm_cell`` and decode logits:
  rtol 1e-4 / atol 2e-5, the model tolerance of the other port tests;
- ``loss_fn``: rtol 1e-5;
- gradients and decode states: rtol 1e-4 and atol 2e-5 times the
  leaf's largest magnitude where that exceeds 1 (``SCALED``).  An
  element far below its leaf's largest carries the leaf's rounding, not
  its own: ``embed``'s gradient (3.6 at S = 16, as the first RMSNorm
  divides the 0.02-scale rows by their RMS) was 5.5e-5 apart in an
  element, 1.5e-5 of the largest, and an mLSTM ``C`` of largest 2.2 was
  2.6e-5 apart in an element of 0.028 after 3 decode steps.  Every
  other gradient leaf was within 3.2e-5 of its largest (JAX's init,
  measured when writing this test);
- token streams: equal.

Serving: the port primes xLSTM token by token and gives a reused slot
the state of a fresh cache; the JAX server does not reset a reused slot
(ROADMAP C), so the JAX server is held to first-admission requests
only, and a reused slot to a fresh port server.
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
from repro.launch.train import reduce_config as jreduce
from repro.models import model as jmodel
from repro.models import xlstm as jx
from repro.runtime.serve_config import ServeConfig as JServeConfig
from repro.runtime.serve_loop import DecodeServer as JServer
from repro.runtime.serve_loop import Request as JRequest
from repro_torch import interop
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.configs import base as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.models import xlstm as tx
from repro_torch.runtime.serve_config import KVConfig, ServeConfig, SpecConfig
from repro_torch.runtime.serve_loop import DecodeServer, Request
from tests.test_torch_blockllm import run_trajectory

torch.set_num_threads(2)

CHUNK_ATOL = 5e-5
F32_TOL = dict(rtol=1e-4, atol=2e-5)
SCALED = "scaled"     # F32_TOL with atol times max(1, max |want|)
SMALL = dict(num_layers=8, d_model=64, num_heads=2, num_kv_heads=2,
             vocab_size=256)


def _cfgs(dtype="float32", **kw):
    jcfg = jget_config("xlstm-1.3b").replace(dtype=dtype, **{**SMALL, **kw})
    return jcfg, tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


def _port(tree):
    return interop.tree_to_torch(jax.tree.map(np.asarray, tree),
                                 device="cpu")


def _weights(cfg, seed):
    """The port's ``init_params`` from ``seed`` and the same leaves as a
    JAX tree."""
    params = tmodel.init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return jax.tree.map(jnp.asarray, interop.tree_to_numpy(params)), params


@pytest.fixture(scope="module")
def f32_model():
    jcfg, cfg = _cfgs(remat=False)
    return (jcfg, cfg) + _weights(cfg, 0)


def _close(got, want, tol, msg=""):
    want = np.asarray(want)
    if tol == SCALED:
        tol = dict(F32_TOL, atol=F32_TOL["atol"] * max(
            1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else got, want,
        **tol, err_msg=msg)


# ------------------------------------------------------------- config, init


def test_config_and_reduction_match_jax():
    """The port's ``xlstm-1.3b`` equals JAX's field for field (``ssm``,
    no FFN, the 7:1 pattern, vocab 50304), and ``reduce_config`` builds
    the same reduced shape."""
    j = jget_config("xlstm-1.3b")
    t = tconfigs.get_config("xlstm-1.3b")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.family, t.mlp_type, t.d_ff, t.vocab_size) == (
        "ssm", "none", 0, 50304)
    assert t.pattern == ("mlstm",) * 7 + ("slstm",)
    for f in (2, 8):
        assert (dataclasses.asdict(tconfigs.reduce_config(t, f))
                == dataclasses.asdict(jreduce(j, f)))
    tmodel.check_supported(t)


def test_init_layout_and_constants(f32_model):
    """The port's own ``init_params`` has JAX's leaf paths and shapes (an
    xLSTM row has no ``ln1`` / ``ln2``), JAX's bias constants and zero
    norm scales, and its random leaves JAX's scales."""
    jcfg, cfg, _, mine = f32_model
    jshapes = jax.eval_shape(lambda k: jmodel.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    tn, tl, _ = _flatten_with_names(mine)
    jn, jl, _ = jflat(jshapes)
    assert tn == jn
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    p = dict(zip(tn, tl))
    m, s = "stages/0/pos0/", "stages/0/pos7/"
    assert not any("ln1" in n or "ln2" in n for n in tn)
    assert p[m + "wq"].shape == (1, 2, 64, 64)
    assert p[s + "r_i"].shape == (1, 2, 32, 32)
    assert torch.equal(p[m + "b_i"], torch.full((1, 2), -2.0))
    assert torch.equal(p[m + "b_f"], torch.full((1, 2), 3.0))
    assert torch.equal(p[s + "b_f"], torch.full((1, 64), 3.0))
    for g in "izo":
        assert not p[s + f"b_{g}"].any()
    for n in tn:
        if n.endswith("scale"):
            assert not p[n].any(), n
    L = cfg.num_layers
    for name, want in ((m + "wq", 1 / 8), (m + "w_if", 0.02),
                       (m + "w_up", 1 / 8),
                       (m + "w_down", 1 / np.sqrt(128) / np.sqrt(2 * L)),
                       (s + "w_f", 0.02), (s + "r_z", 1 / np.sqrt(32)),
                       (s + "w_down", 1 / 8 / np.sqrt(2 * L))):
        assert abs(float(p[name].std()) / want - 1) < 0.1, name


# ------------------------------------------------------------------ mLSTM


def _mlstm_inputs(seed, B=2, S=64, H=2, hd=16):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H, hd).astype(np.float32) for _ in range(3))
    li = (rng.randn(B, S, H) * 0.5).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(rng.randn(B, S, H).astype(
        np.float32) + 2))
    return q, k, v, li, lf


_jchunkwise = jax.jit(jx.mlstm_chunkwise, static_argnames="chunk")


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunkwise_matches_jax(chunk, carried):
    """Outputs and the final ``(C, n, m)`` within atol 5e-5 of JAX's, from
    a fresh state and from a state carried over a first 32 tokens; and
    within the same bound of the port's per-step oracle."""
    q, k, v, li, lf = _mlstm_inputs(0)
    jstate = state = None
    if carried:
        pre = _mlstm_inputs(1, S=32)
        _, jstate = _jchunkwise(*map(jnp.asarray, pre), chunk=16)
        state = tuple(_t(*jstate))
    jh, jst = _jchunkwise(*map(jnp.asarray, (q, k, v, li, lf)),
                          chunk=chunk, state=jstate)
    h, st = tx.mlstm_chunkwise(*_t(q, k, v, li, lf), chunk=chunk, state=state)
    tol = dict(rtol=0, atol=CHUNK_ATOL)
    _close(h, jh, tol)
    for a, b in zip(st, jst):
        _close(a, b, tol)
    hr, sr = tx.mlstm_recurrent_ref(*_t(q, k, v, li, lf), state=state)
    _close(h, hr.numpy(), tol)
    for a, b in zip(st, sr):
        _close(a, b.numpy(), tol)


def test_mlstm_chunkwise_refuses_a_ragged_length():
    with pytest.raises(ValueError, match="multiple"):
        tx.mlstm_chunkwise(*_t(*_mlstm_inputs(0, S=40)), chunk=16)


def test_mlstm_step_matches_jax():
    """Three decode steps from a fresh state (``m = -inf``), then from a
    carried one."""
    q, k, v, li, lf = _mlstm_inputs(2, S=3)
    B, _, H, hd = q.shape
    jst = (jnp.zeros((B, H, hd, hd)), jnp.zeros((B, H, hd)),
           jnp.full((B, H), -jnp.inf))
    st = tuple(_t(*jst))
    jstep = jax.jit(jx.mlstm_step)
    for t in range(3):
        jh, jst = jstep(*(jnp.asarray(a[:, t]) for a in (q, k, v, li, lf)),
                        jst)
        h, st = tx.mlstm_step(*_t(*(a[:, t] for a in (q, k, v, li, lf))), st)
        _close(h, jh, F32_TOL, f"step {t}")
        for a, b in zip(st, jst):
            _close(a, b, F32_TOL, f"step {t}")


# ------------------------------------------------------------------ sLSTM


def _slstm_params(f32_model):
    _, _, jparams, params = f32_model
    row = lambda tree: jax.tree.map(lambda a: a[0], tree)  # noqa: E731
    return (row(jparams["stages"][0]["pos7"]),
            {k: (v[0] if torch.is_tensor(v) else {"scale": v["scale"][0]})
             for k, v in params["stages"][0]["pos7"].items()})


@pytest.mark.parametrize("hoisted", [False, True])
def test_slstm_cell_matches_jax(f32_model, hoisted):
    """``_slstm_cell`` with the per-gate input projections of decode and
    with the ``wx`` hoisted for the sequence path, over 4 steps from a
    fresh state."""
    jcfg, cfg, _, _ = f32_model
    jp, p = _slstm_params(f32_model)
    rng = np.random.RandomState(3)
    xs = rng.randn(4, 2, 64).astype(np.float32)
    jst = jx.slstm_init_cache(jcfg, 2)
    st = tuple(a[0] for a in tx.slstm_init_cache(cfg, 2, groups=1).values())
    for t in range(4):
        jwx = twx = None
        if hoisted:
            jwx = jnp.stack([xs[t] @ jp[f"w_{g}"] for g in "ifzo"], axis=1)
            twx = torch.from_numpy(np.array(jwx))
        jst, jh = jx._slstm_cell(jp, jnp.asarray(xs[t]), jst, 2, wx=jwx)
        st, h = tx._slstm_cell(p, torch.from_numpy(xs[t]), st, 2, wx=twx)
        _close(h, jh, F32_TOL, f"step {t}")
        for a, b in zip(st, jst):
            _close(a, b, F32_TOL, f"step {t}")


def _block_params(tree, j):
    return jax.tree.map(lambda a: a[0], tree["stages"][0][f"pos{j}"])


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_apply_matches_jax(f32_model, kind, mode):
    """Both block functions in ``train`` (16 tokens from a fresh state)
    and ``decode`` (one token from a carried state) mode."""
    jcfg, cfg, jparams, params = f32_model
    j = 0 if kind == "mlstm" else 7
    jp = _block_params(jparams, j)
    p = {k: (v[0] if torch.is_tensor(v) else {"scale": v["scale"][0]})
         for k, v in params["stages"][0][f"pos{j}"].items()}
    rng = np.random.RandomState(4)
    S = 16 if mode == "train" else 1
    x = rng.randn(2, S, 64).astype(np.float32)
    fresh = tx.MLSTM_FRESH if kind == "mlstm" else tx.SLSTM_FRESH
    if kind == "mlstm":
        apply = lambda p, x, c, mode: jx.mlstm_block_apply(  # noqa: E731
            p, x, mode=mode, cache=c)
    else:
        apply = lambda p, x, c, mode: jx.slstm_block_apply(  # noqa: E731
            p, x, jcfg, mode=mode, cache=c)
    jblock = jax.jit(apply, static_argnums=3)
    jcache = cache = None
    if mode == "decode":
        # a non-trivial state: 5 tokens through JAX's prefill form
        pre = jnp.asarray(rng.randn(2, 5, 64).astype(np.float32))
        _, jcache = jblock(jp, pre, None, "prefill")
        cache = dict(zip(fresh, _t(*jcache)))
    jy, jnew = jblock(jp, jnp.asarray(x), jcache, mode)
    if kind == "mlstm":
        y, new = tx.mlstm_block_apply(p, torch.from_numpy(x), mode=mode,
                                      cache=cache)
    else:
        y, new = tx.slstm_block_apply(p, torch.from_numpy(x), cfg, mode=mode,
                                      cache=cache)
    _close(y, jy, F32_TOL)
    assert (new is None) == (jnew is None) == (mode == "train")
    if new is not None:
        assert list(new) == list(fresh)
        for a, b in zip(new.values(), jnew):
            _close(a, b, F32_TOL)


# ---------------------------------------------------------- model, loss


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(S):
    """JAX's loss and gradients at sequence length ``S`` (remat off; one
    compile per length, shared by the port's remat cases)."""
    jcfg, cfg = _cfgs(remat=False)
    jparams, _ = _weights(cfg, 1)
    tokens = np.random.RandomState(5).randint(
        0, jcfg.vocab_size, (2, S)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)},
                                 loss_chunk=0),
        has_aux=True))(jparams)
    return jparams, tokens, jl, jg


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("S", [16, 512])
def test_loss_and_grads_match_jax(S, remat):
    """``loss_fn``, with ``remat`` off and on (every block recomputed in
    the backward pass), and its gradient with respect to every leaf
    against ``jax.value_and_grad`` of JAX's (f32; at S = 512 the mLSTM
    runs two 256-token chunks, the first from ``m = -inf``), and no NaN
    or inf in any gradient.  JAX's side runs without remat, which
    changes no value there."""
    _, cfg = _cfgs(remat=remat)
    jparams, tokens, jl, jg = _jax_loss_and_grads(S)
    names, leaves, td = _flatten_with_names(_port(jparams))
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
        assert torch.isfinite(g).all(), n
        _close(g, j, SCALED, n)


def _jax_decode(jcfg):
    return jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, jcfg, c, t,
                                                           pos))


def _state_pairs(cache, jcache):
    """``(name, port leaf, JAX leaf)`` of every state: the port's dicts
    in ``*_FRESH`` order against JAX's tuples."""
    out = []
    for si, st in enumerate(cache["stages"]):
        for pos, blk in st.items():
            for i, name in enumerate(blk):
                out.append((f"{si}/{pos}/{name}", blk[name],
                            jcache["stages"][si][pos][i]))
    return out


def test_teacher_forced_decode_matches_jax_and_forward(f32_model):
    """16 teacher-forced ``decode_step``s from a fresh cache: logits and
    every state leaf against JAX's at each step, and the logits against
    the port's own ``forward`` over the same tokens."""
    jcfg, cfg, jparams, params = f32_model
    B, steps = 2, 16
    fed = np.random.RandomState(6).randint(
        0, cfg.vocab_size, (B, steps)).astype(np.int32)
    jc = jmodel.init_cache(jcfg, B, 32, dtype=jnp.float32)
    tc = tmodel.init_cache(cfg, B, 32, dtype=torch.float32, device="cpu")
    decode = _jax_decode(jcfg)
    outs = []
    for t in range(steps):
        pos = np.full(B, t, np.int32)
        jlg, jc = decode(jparams, jc, jnp.asarray(fed[:, t:t + 1]),
                         jnp.asarray(pos))
        tlg, _ = tmodel.decode_step(params, cfg, tc,
                                    torch.from_numpy(fed[:, t:t + 1]).long(),
                                    pos)
        _close(tlg, jlg, F32_TOL, f"step {t}")
        outs.append(tlg)
        for name, a, b in _state_pairs(tc, jc):
            _close(a, b, SCALED, f"step {t} {name}")
    full = tmodel.forward(params, cfg, torch.from_numpy(fed).long())
    _close(torch.stack(outs, 1), full.numpy(), F32_TOL)


def test_init_cache_states_are_f32_under_a_bf16_cache(f32_model):
    """Every xLSTM state is f32 whatever the cache dtype (as JAX's
    ``*_init_cache``), with the fresh values ``m = -inf`` (mLSTM) and
    ``n = 1e-6``, ``m = -1e30`` (sLSTM)."""
    jcfg, cfg, _, _ = f32_model
    cache = tmodel.init_cache(cfg, 3, 32, dtype=torch.bfloat16, device="cpu")
    jcache = jmodel.init_cache(jcfg, 3, 32, dtype=jnp.bfloat16)
    pairs = _state_pairs(cache, jcache)
    assert len(pairs) == 7 * 3 + 4
    for name, a, b in pairs:
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    m = cache["stages"][0]["pos0"]
    assert list(m) == ["C", "n", "m"] and m["C"].shape == (1, 3, 2, 64, 64)
    assert torch.isneginf(m["m"]).all()
    s = cache["stages"][0]["pos7"]
    assert list(s) == ["c", "n", "m", "h"]
    assert (s["n"] == 1e-6).all() and (s["m"] == -1e30).all()


def _run_steps(cfg, params, cache, rng, steps, B):
    for t in range(steps):
        tmodel.decode_step(params, cfg, cache, torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (B, 1))).long(),
            np.full(B, t, np.int32))


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_decode_inactive_slot_state_stays_bit_exact(f32_model):
    """A decode step with an active mask leaves the inactive slot's
    mLSTM and sLSTM states bit-exact, and the active slots equal an
    unmasked step."""
    _, cfg, _, params = f32_model
    B = 3
    rng = np.random.RandomState(8)
    cache = tmodel.init_cache(cfg, B, 32, device="cpu")
    _run_steps(cfg, params, cache, rng, 4, B)
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
        assert torch.equal(_bits(now[:, 1]), _bits(before[:, 1]))
        assert torch.equal(now[:, 0], full[:, 0])
        assert torch.equal(now[:, 2], full[:, 2])
        assert not torch.equal(now[:, 0], before[:, 0])
    assert torch.equal(lg[active], lg_all[active])


def test_reset_recurrent_state_gives_a_fresh_cache_bitwise(f32_model):
    """After some decode steps, ``reset_recurrent_state`` gives the reset
    slots the bits of a fresh cache (not zeros: ``m`` is -inf / -1e30,
    the sLSTM ``n`` 1e-6) and leaves the other slots alone."""
    _, cfg, _, params = f32_model
    B = 3
    cache = tmodel.init_cache(cfg, B, 32, device="cpu")
    fresh = _flatten_with_names(tmodel.init_cache(cfg, B, 32,
                                                  device="cpu"))[1]
    _run_steps(cfg, params, cache, np.random.RandomState(9), 3, B)
    before = [t.clone() for t in _flatten_with_names(cache)[1]]
    tmodel.reset_recurrent_state(cache, [0, 2])
    for f, b, a in zip(fresh, before, _flatten_with_names(cache)[1]):
        for s in (0, 2):
            assert torch.equal(_bits(a[:, s]), _bits(f[:, s]))
        assert torch.equal(_bits(a[:, 1]), _bits(b[:, 1]))


# ---------------------------------------------------------------- serving


def _reqs(cls, vocab, seed, n, new=6):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, 3 + (5 * i) % 7),
                max_new_tokens=new + i % 3) for i in range(n)]


def _serve(cfg, params, reqs, slots):
    srv = DecodeServer(cfg, params, ServeConfig(batch_slots=slots,
                                                max_seq=32), device="cpu")
    assert not srv._slot_prefill      # xLSTM primes per token
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return srv, [r.out for r in reqs]


def _port_greedy(cfg, params, prompt, n_new):
    """Model-level greedy decode of one request from a fresh bf16-typed
    cache (the server's; the states are f32 all the same)."""
    cache = tmodel.init_cache(cfg, 1, 32, device="cpu")
    out = []
    for t in range(len(prompt) + n_new - 1):
        cur = int(prompt[t]) if t < len(prompt) else out[-1]
        lg, _ = tmodel.decode_step(params, cfg, cache, torch.tensor([[cur]]),
                                   np.array([t], np.int32))
        if t >= len(prompt) - 1:
            out.append(int(lg[0].argmax()))
    return out


def test_server_streams_equal_model_greedy_and_jax(f32_model):
    """Three requests over three slots (each admitted once, into a fresh
    slot): the port server's streams equal the model-level greedy decode
    and JAX's ``DecodeServer`` on the same weights."""
    jcfg, cfg, jparams, params = f32_model
    reqs = _reqs(Request, cfg.vocab_size, 1, 3)
    srv, outs = _serve(cfg, params, reqs, 3)
    assert srv.prefill_dispatches == sum(len(r.prompt) for r in reqs)
    for r, out in zip(reqs, outs):
        assert out == _port_greedy(cfg, params, r.prompt,
                                   r.max_new_tokens), r.rid
    jsrv = JServer(jcfg, jparams, JServeConfig(batch_slots=3, max_seq=32))
    # JAX's per-token priming hands a host buffer it then rewrites to a
    # zero-copy jnp.asarray (ROADMAP C): wait for each dispatch, so each
    # step reads the token it was given
    decode = jsrv._decode
    jsrv._decode = lambda *a: jax.block_until_ready(decode(*a))
    jreqs = _reqs(JRequest, cfg.vocab_size, 1, 3)
    for r in jreqs:
        jsrv.submit(r)
    jsrv.run_until_drained()
    assert outs == [r.out for r in jreqs]


def test_reused_slot_equals_fresh_server(f32_model):
    """One slot: the second request runs in the slot the first left with
    a non-fresh mLSTM and sLSTM state, and gives the stream a fresh
    server gives it (zeroing the state instead of resetting it to a
    fresh cache's values changes the stream)."""
    _, cfg, _, params = f32_model
    first, second = _reqs(Request, cfg.vocab_size, 2, 2, new=8)
    _, outs = _serve(cfg, params, [first, second], 1)
    fresh = Request(rid=9, prompt=second.prompt,
                    max_new_tokens=second.max_new_tokens)
    _, (alone,) = _serve(cfg, params, [fresh], 1)
    assert outs[1] == alone


def test_xlstm_refuses_slot_prefill_paged_and_spec(f32_model):
    """As JAX's predicates: no chunked prefill, paged KV, prefix sharing
    or speculative decoding for xLSTM blocks."""
    jcfg, cfg, _, params = f32_model
    for f in ("supports_slot_prefill", "supports_paged_kv",
              "supports_spec_decode", "supports_prefix_share"):
        assert getattr(tmodel, f)(cfg) is getattr(jmodel, f)(jcfg) is False
    cache = tmodel.init_cache(cfg, 2, 32, device="cpu")
    with pytest.raises(ValueError, match="prefill_slots does not support"):
        tmodel.prefill_into_slots(params, cfg, cache,
                                  torch.zeros(2, 4, dtype=torch.long),
                                  np.array([4, 4]))
    with pytest.raises(ValueError, match="recurrent"):
        tmodel.verify_into_slots(params, cfg, cache,
                                 torch.zeros(2, 2, dtype=torch.long),
                                 np.array([0, 0]), np.array([True, True]))
    with pytest.raises(ValueError, match="paged"):
        tmodel.init_paged_cache(cfg, 2, 9, 16, 32, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        DecodeServer(cfg, params, ServeConfig(
            batch_slots=2, max_seq=32, kv=KVConfig(layout="paged")),
            device="cpu")
    with pytest.raises(ValueError, match="speculate"):
        DecodeServer(cfg, params, ServeConfig(
            batch_slots=2, max_seq=32, spec=SpecConfig(draft=2)),
            device="cpu")


# ---------------------------------------------------------------- training


def test_blockllm_trajectory_xlstm_matches_jax():
    """``tests/test_torch_blockllm.py``'s trajectory for 4 steps (the
    mask refresh, three masked steps, and the reselection after the
    last) on an xLSTM of one mLSTM and one sLSTM block (the pattern cut
    to one row of each kind), d_model 64, 2 heads: losses, selections,
    masks and the final selected rows.  Each selection costs JAX two
    compiles of its train step (about 20 s each at 8 layers), hence the
    depth and the 4 steps."""
    run_trajectory("off", "xlstm-1.3b", steps=4, d_model=64, num_heads=2,
                   num_kv_heads=2, num_layers=2, pattern=("mlstm", "slstm"))
