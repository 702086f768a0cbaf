"""The encoder-decoder family (``whisper-large-v3``) in the port against
the JAX package.

The architecture is ``whisper-large-v3`` cut to 2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16 (MHA), d_ff 128 (``gelu_mlp``), vocab
256 and 24 frames of 40 stub features; sinusoidal absolute positions
(``rope_theta = 0``).  Both packages get the same weights (the port's
``init_params`` from a seed, carried to JAX through
``repro_torch.interop``) and the same numpy tokens and frames.
Tolerances, and why:

- ``sinusoidal_positions``: within 4 f32 epsilons of the angle
  (``max(1, pos * div)``) of JAX's.  Not bitwise: XLA's CPU ``exp``,
  ``sin`` and ``cos`` are approximations of their own, none of them
  PyTorch's, numpy's or the correctly rounded value (at S 1500, d 1280,
  65 of JAX's 640 frequencies differ from PyTorch's by an ulp, and with
  JAX's own frequencies 42453 of 960000 sines differ; the largest
  difference, 1.2e-4 at position 1500, is one ulp of the frequency times
  the position).  Within the port the decode step's rows are bitwise the
  table's rows at the same positions;
- ``_encode``, ``forward``, the prefill cache, decode logits: rtol 1e-4
  / atol 2e-5, the model tolerance of the other port tests;
- ``loss_fn``: rtol 1e-5;
- gradients: rtol 1e-4 and atol 2e-5 times the leaf's largest magnitude
  where that exceeds 1 (``SCALED``, as ``tests/test_torch_xlstm.py``);
- token streams and everything the reference computes exactly (zero
  gradients, unchanged rows, applied deltas): equal.

The reference's fault (ROADMAP C, "Faults of the reference"): under
BlockLLM's overlay JAX's ``forward`` computes ``_cross_kv`` from the
stop-gradient base, so a selected decoder row's ``xattn.wk`` /
``xattn.wv`` get an exactly zero gradient and never train; the port
reproduces it (``test_overlay_and_merge_gradients_match_jax``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adapters import delta as jdelta
from repro.checkpoint import checkpointer as jckpt
from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro.configs.base import get_config as jget_config
from repro.core import units as junits
from repro.launch.train import reduce_config as jreduce
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import interop
from repro_torch import trainers
from repro_torch.adapters import delta as tdelta
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.configs import base as tconfigs
from repro_torch.core import units as tunits
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.runtime.serve_config import ServeConfig
from repro_torch.runtime.serve_loop import DecodeServer
from repro_torch.trainers import api as tapi
from tests.test_torch_blockllm import run_trajectory

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=2e-5)
SCALED = "scaled"     # F32_TOL with atol times max(1, max |want|)
SMALL = dict(num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
             num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
             encoder_seq_len=24, encoder_feature_dim=40)
B, S = 2, 12


def _cfgs(dtype="float32", **kw):
    jcfg = jget_config("whisper-large-v3").replace(dtype=dtype,
                                                   **{**SMALL, **kw})
    return jcfg, tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


def _weights(cfg, seed):
    """The port's ``init_params`` from ``seed`` and the same leaves as a
    JAX tree."""
    params = tmodel.init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return jax.tree.map(jnp.asarray, interop.tree_to_numpy(params)), params


def _inputs(cfg, seed, b=B, s=S):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = rng.randn(b, cfg.encoder_seq_len,
                       cfg.encoder_feature_dim).astype(np.float32)
    return tokens, frames


def _t(a):
    return torch.from_numpy(np.array(a))


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


def test_config_reduction_and_support_match_jax():
    """The port's ``whisper-large-v3`` equals JAX's field for field (32 +
    32 layers, MHA 20 x 64, 1500 frames of 1280, ``rope_theta = 0``),
    ``reduce_config`` builds JAX's reduced shapes, ``check_supported``
    admits it, and the full tree holds 1,602,629,120 parameters (JAX's
    shapes, through ``jax.eval_shape``)."""
    j = jget_config("whisper-large-v3")
    t = tconfigs.get_config("whisper-large-v3")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.is_encoder_decoder, t.num_encoder_layers, t.encoder_seq_len,
            t.rope_theta) == (True, 32, 1500, 0.0)
    for f in (2, 8):
        assert (dataclasses.asdict(tconfigs.reduce_config(t, f))
                == dataclasses.asdict(jreduce(j, f)))
    tmodel.check_supported(t)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, j),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape))
               for a in jax.tree.leaves(shapes)) == 1_602_629_120
    for fn in (tmodel.supports_slot_prefill, tmodel.supports_paged_kv,
               tmodel.supports_spec_decode):
        assert not fn(t)
    assert [fn(j) for fn in (jmodel.supports_slot_prefill,
                             jmodel.supports_paged_kv,
                             jmodel.supports_spec_decode)] == [False] * 3


def test_init_layout_and_scales():
    """The port's ``init_params`` has JAX's leaf paths and shapes (every
    decoder row with ``lnx`` and an MHA ``xattn``; the ``encoder`` with
    ``frontend``, its stages and ``final_norm``), zero norm scales, and
    JAX's scales: the frontend 1 / sqrt(features), the encoder's output
    projections from ``num_encoder_layers`` and the decoder's (``xattn``
    too) from ``num_layers`` (depths 6 and 2 here, so they differ)."""
    jcfg, cfg = _cfgs(num_encoder_layers=6)
    jshapes = jax.eval_shape(lambda k: jmodel.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    mine = tmodel.init_params(cfg, device="cpu")
    tn, tl, _ = _flatten_with_names(mine)
    jn, jl, _ = jflat(jshapes)
    assert tn == jn
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    p = dict(zip(tn, tl))
    assert p["stages/0/pos0/xattn/wk"].shape == (2, 64, 64)
    assert p["encoder/stages/0/pos0/attn/wq"].shape == (6, 64, 64)
    assert p["encoder/frontend"].shape == (40, 64)
    for n in tn:
        if n.endswith("scale"):
            assert not p[n].any(), n
    out = 1 / np.sqrt(64)
    for name, want in (("encoder/frontend", 1 / np.sqrt(40)),
                       ("encoder/stages/0/pos0/attn/wq", 1 / 8),
                       ("encoder/stages/0/pos0/attn/wo", out / np.sqrt(12)),
                       ("encoder/stages/0/pos0/mlp/w_down",
                        1 / np.sqrt(128) / np.sqrt(12)),
                       ("stages/0/pos0/attn/wo", out / 2),
                       ("stages/0/pos0/xattn/wk", 1 / 8),
                       ("stages/0/pos0/xattn/wo", out / 2),
                       ("stages/0/pos0/mlp/w_down", 1 / np.sqrt(128) / 2)):
        assert abs(float(p[name].std()) / want - 1) < 0.1, name


@pytest.mark.parametrize("S_, d", [(24, 64), (448, 1280), (1500, 1280)])
def test_sinusoidal_positions_match_jax(S_, d):
    """The port's table against JAX's (see the module docstring for the
    bound), and the port's decode rows (``layers.sinusoid`` at per-slot
    positions) bitwise its table's rows."""
    got = tlayers.sinusoidal_positions(S_, d)
    want = np.asarray(jlayers.sinusoidal_positions(S_, d))
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    ang = np.repeat(np.arange(S_)[:, None] * div[None], 2, axis=1)
    bound = 4 * np.finfo(np.float32).eps * np.maximum(1.0, ang)
    assert got.dtype == torch.float32 and got.shape == (S_, d)
    assert (np.abs(got.numpy() - want) <= bound).all()
    pos = torch.tensor([0, S_ - 1, S_ // 3, 7 % S_], dtype=torch.int32)
    assert torch.equal(tlayers.sinusoid(pos.float(), d), got[pos.long()])
    assert torch.equal(tlayers.sinusoidal_positions(S_, d, torch.bfloat16),
                       got.to(torch.bfloat16))


# ------------------------------------------------------------ model, loss


def test_encode_and_forward_match_jax(f32_model):
    """``_encode`` (the frontend, the sinusoid, two non-causal MHA blocks,
    the final norm), the cross k/v and ``forward``'s logits against
    JAX's."""
    jcfg, cfg, jparams, params = f32_model
    tokens, frames = _inputs(cfg, 1)
    jenc = jax.jit(lambda p, f: jmodel._encode(p, jcfg, f))(
        jparams, jnp.asarray(frames))
    with torch.no_grad():
        enc = tmodel._encode(params, cfg, _t(frames))
        _close(enc, jenc, F32_TOL)
        jx = jmodel._cross_kv(jparams, jcfg, jenc)
        x = tmodel._cross_kv(params, cfg, enc)
        for n in ("k", "v"):
            _close(x[0]["pos0"][n], jx[0]["pos0"][n], F32_TOL, n)
        jl, _, _ = jax.jit(lambda p, b: jmodel.forward(p, jcfg, b))(
            jparams, {"tokens": jnp.asarray(tokens),
                      "frames": jnp.asarray(frames)})
        lg = tmodel.forward(params, cfg, _t(tokens).long(),
                            frames=_t(frames))
    assert lg.shape == (B, S, cfg.vocab_size)
    _close(lg, jl, F32_TOL)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    """JAX's loss and gradients (remat off; one compile, shared by the
    port's remat cases)."""
    jcfg, cfg = _cfgs(remat=False)
    jparams, _ = _weights(cfg, 1)
    tokens, frames = _inputs(cfg, 2)
    batch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, batch, loss_chunk=0),
        has_aux=True))(jparams)
    return jparams, tokens, frames, jl, jg


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    """``loss_fn`` with the batch's ``frames``, with ``remat`` off and on
    (every encoder and decoder block recomputed in the backward pass),
    and its gradient with respect to every leaf, ``encoder`` and
    ``xattn`` included, against ``jax.value_and_grad`` of JAX's."""
    _, cfg = _cfgs(remat=remat)
    jparams, tokens, frames, jl, jg = _jax_loss_and_grads()
    names, leaves, td = _flatten_with_names(
        interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                              device="cpu"))
    for leaf in leaves:
        leaf.requires_grad_()
    tl, _ = tmodel.loss_fn(td.unflatten(leaves), cfg,
                           {"tokens": _t(tokens).long(),
                            "frames": _t(frames)}, loss_chunk=0)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, leaves)
    jnames, jleaves, _ = jflat(jg)
    assert jnames == names
    assert any(n.startswith("encoder/stages") for n in names)
    for n, g, j in zip(names, grads, jleaves):
        assert torch.isfinite(g).all(), n
        _close(g, j, SCALED, n)


def _plan(units, index):
    """Decoder row 1 selected, row 0 a probe, the ``encoder`` leaf
    active."""
    return units.Plan(units.PlanStructure(
        k_per_stack=(("s0/pos0", 1),), probe_per_stack=(("s0/pos0", 1),),
        active_leaves=("encoder",)),
        {"s0/pos0": np.asarray([1], np.int32)},
        {"s0/pos0": np.asarray([0], np.int32)})


def test_overlay_and_merge_gradients_match_jax(f32_model):
    """The gradient with respect to BlockLLM's active tree (a selected
    decoder row, a probe row and the ``encoder`` leaf), through the
    overlay both packages' trainers use and through the explicit
    ``merge_active`` scatter, against JAX's (``SCALED``).  Through the
    overlay the rows' ``xattn.wk`` / ``xattn.wv`` get an exactly zero
    gradient in both packages (``_cross_kv`` reads the frozen base: the
    reference's fault); through the merge they get a nonzero one."""
    jcfg, cfg, jparams, params = f32_model
    tokens, frames = _inputs(cfg, 3)
    jbatch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    tbatch = {"tokens": _t(tokens).long(), "frames": _t(frames)}
    jidx = junits.build_unit_index(jcfg, jparams)
    tidx = tunits.build_unit_index(cfg, params)
    jplan = _plan(junits, jidx)
    tplan = _plan(tunits, tidx)
    tplan.stack_idx = {k: torch.as_tensor(v)
                       for k, v in tplan.stack_idx.items()}
    tplan.probe_idx = {k: torch.as_tensor(v)
                       for k, v in tplan.probe_idx.items()}
    jact = junits.extract_active(jparams, jidx, jplan)
    tact = tunits.extract_active(params, tidx, tplan)

    def jloss(act, overlay):
        if not overlay:
            return jmodel.loss_fn(junits.merge_active(
                jparams, jidx, jplan, act), jcfg, jbatch, loss_chunk=0)[0]
        ov = {"s0/pos0": {"idx": jnp.asarray([1]),
                          "rows": act["sel"]["stacks"]["s0/pos0"],
                          "pidx": jnp.asarray([0]),
                          "probe": act["probe"]["s0/pos0"]}}
        merged = dict(jax.tree.map(jax.lax.stop_gradient, jparams))
        merged["encoder"] = act["sel"]["leaves"]["encoder"]
        return jmodel.loss_fn(merged, jcfg, jbatch, loss_chunk=0,
                              overlay=ov)[0]

    for overlay in (True, False):
        jg = jax.jit(jax.grad(functools.partial(jloss, overlay=overlay)))(
            jact)
        names, leaves, td = _flatten_with_names(tact)
        req = [a.detach().clone().requires_grad_() for a in leaves]
        act = td.unflatten(req)
        if overlay:
            ov = {"s0/pos0": {"idx": [1],
                              "rows": act["sel"]["stacks"]["s0/pos0"],
                              "pidx": [0], "probe": act["probe"]["s0/pos0"]}}
            merged = dict(params)
            merged["encoder"] = act["sel"]["leaves"]["encoder"]
            loss, _ = tmodel.loss_fn(merged, cfg, tbatch, loss_chunk=0,
                                     overlay=ov)
        else:
            loss, _ = tmodel.loss_fn(tunits.merge_active(
                params, tidx, tplan, act), cfg, tbatch, loss_chunk=0)
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
        jnames, jleaves, _ = jflat(jg)
        assert jnames == names
        for n, g, j in zip(names, grads, jleaves):
            cross = "xattn/wk" in n or "xattn/wv" in n
            if cross and overlay:
                assert not np.asarray(j).any(), n
                assert not g.any(), n
            else:
                assert g.abs().max() > 0, n
                _close(g, j, SCALED, f"overlay={overlay} {n}")


def _frames_batch(cfg, step):
    return {"frames": np.random.RandomState(100 + step).randn(
        4, cfg.encoder_seq_len, cfg.encoder_feature_dim).astype(np.float32)}


def test_blockllm_trajectory_whisper_matches_jax():
    """``tests/test_torch_blockllm.py``'s trajectory for 4 steps (the mask
    refresh, three masked steps, the reselection after the last) on
    ``whisper-large-v3`` reduced by 8 (4 decoder and 4 encoder layers,
    64 frames), the same frames in both packages: losses, selections,
    masks and final rows.  Every decoder row's ``xattn.wk`` / ``xattn.wv``
    ends bitwise where it began in both packages (zero gradient), while
    the selected rows' ``xattn.wq``, ``xattn.wo`` and ``lnx`` moved."""
    jh, th = run_trajectory("off", "whisper-large-v3", steps=4,
                            batch_extra=_frames_batch)
    first = jh.state.meta["reselections"]
    assert first == 2
    from tests.test_torch_blockllm import _setup
    _, _, jparams0, _ = _setup("whisper-large-v3")
    start = dict(zip(*jflat(jparams0)[:2]))
    jend = dict(zip(*jflat(jh.state.arrays["params"])[:2]))
    tn, tl, _ = _flatten_with_names(th.state.arrays["params"])
    moved = set()
    for n, t in zip(tn, tl):
        if "/xattn/" not in n and "/lnx/" not in n:
            continue
        a0, aj = np.asarray(start[n]), np.asarray(jend[n])
        if n.endswith(("xattn/wk", "xattn/wv")):
            np.testing.assert_array_equal(aj, a0, n)
            np.testing.assert_array_equal(t.numpy(), a0, n)
        elif not np.array_equal(aj, a0):
            moved.add(n)
            assert not np.array_equal(t.numpy(), a0), n
    assert moved == {"stages/0/pos0/xattn/wq", "stages/0/pos0/xattn/wo",
                     "stages/0/pos0/lnx/scale"}, moved


# ---------------------------------------------------------------- decoding


def _jax_greedy(jcfg, jparams, jcache, prompt, n_new):
    """Model-level greedy decode in JAX: the prompt fed token by token,
    then each argmax fed back."""
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, jcfg, c, t,
                                                           pos))
    out, logits = [], []
    for t in range(prompt.shape[1] + n_new - 1):
        cur = (prompt[:, t:t + 1] if t < prompt.shape[1]
               else np.asarray(out[-1], np.int32)[:, None])
        lg, jcache = step(jparams, jcache, jnp.asarray(cur),
                          jnp.full((prompt.shape[0],), t, jnp.int32))
        logits.append(lg)
        if t >= prompt.shape[1] - 1:
            out.append(np.asarray(jnp.argmax(lg, -1)))
    return np.stack(out, 1), logits


def _port_greedy(cfg, params, cache, prompt, n_new):
    out, logits = [], []
    for t in range(prompt.shape[1] + n_new - 1):
        cur = (_t(prompt[:, t:t + 1]) if t < prompt.shape[1]
               else out[-1][:, None])
        lg, _ = tmodel.decode_step(params, cfg, cache, cur.long(),
                                   np.full(prompt.shape[0], t, np.int32))
        logits.append(lg)
        if t >= prompt.shape[1] - 1:
            out.append(lg.argmax(-1))
    return torch.stack(out, 1).numpy(), logits


def test_prefill_cross_kv_decode_and_greedy_match_jax(f32_model):
    """``prefill`` (JAX's only route to a filled ``cross_kv``): its last
    logits, its K/V rows and ``cross_kv`` against JAX's; then
    ``init_cache`` with that ``cross_kv`` (f32), a 4-token prompt fed
    token by token and 8 greedy tokens: every step's logits against
    JAX's, the streams equal, and the teacher-forced logits equal to the
    port's ``forward`` over the stream."""
    jcfg, cfg, jparams, params = f32_model
    tokens, frames = _inputs(cfg, 4, s=4)
    jlast, jc = jax.jit(lambda p, b: jmodel.prefill(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(tokens),
                  "frames": jnp.asarray(frames)})
    with torch.no_grad():
        last, c = tmodel.prefill(params, cfg, {"tokens": _t(tokens).long(),
                                               "frames": _t(frames)})
    _close(last, jlast, F32_TOL)
    assert set(c) == {"stages", "cross_kv"}
    for n in ("k", "v"):
        assert c["stages"][0]["pos0"][n].shape == (2, B, 4, 4, 16)
        _close(c["stages"][0]["pos0"][n], jc["stages"][0]["pos0"][n],
               F32_TOL, n)
        assert c["cross_kv"][0]["pos0"][n].shape == (2, B, 24, 4, 16)
        _close(c["cross_kv"][0]["pos0"][n], jc["cross_kv"][0]["pos0"][n],
               F32_TOL, n)
    jcache = jmodel.init_cache(jcfg, B, 16, dtype=jnp.float32)
    jcache["cross_kv"] = jc["cross_kv"]
    cache = tmodel.init_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
    assert [{p: {n: a.shape for n, a in kv.items()} for p, kv in st.items()}
            for st in cache["cross_kv"]] == [
        {p: {n: tuple(a.shape) for n, a in kv.items()} for p, kv in
         st.items()} for st in jcache["cross_kv"]]
    assert not any(a.any() for a in _flatten_with_names(
        cache["cross_kv"])[1])
    cache["cross_kv"] = c["cross_kv"]
    prompt = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (B, 4)).astype(np.int32)
    jout, jlogits = _jax_greedy(jcfg, jparams, jcache, prompt, 8)
    with torch.no_grad():
        out, logits = _port_greedy(cfg, params, cache, prompt, 8)
        for t, (a, b) in enumerate(zip(logits, jlogits)):
            _close(a, b, F32_TOL, f"step {t}")
        np.testing.assert_array_equal(out, jout)
        fed = torch.cat([_t(prompt), torch.from_numpy(out[:, :-1])], 1)
        full = tmodel.forward(params, cfg, fed.long(), frames=_t(frames))
    _close(torch.stack(logits, 1), full.numpy(), F32_TOL)


def test_cache_helpers_pass_cross_kv_through(f32_model):
    """``reset_recurrent_state`` and a decode step with an active mask
    leave ``cross_kv`` bitwise as it was; the server refuses an
    encoder-decoder model (its requests carry no frames), as the
    launchers do."""
    _, cfg, _, params = f32_model
    cache = tmodel.init_cache(cfg, 3, 8, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(6)
    for st in cache["cross_kv"]:
        for kv in st.values():
            for a in kv.values():
                a.copy_(torch.randn(a.shape, generator=g))
    before = [a.clone() for a in _flatten_with_names(cache["cross_kv"])[1]]
    tmodel.reset_recurrent_state(cache, [0, 2])
    with torch.no_grad():
        tmodel.decode_step(params, cfg, cache, torch.ones(3, 1).long(),
                           np.zeros(3, np.int32),
                           active=torch.tensor([True, False, True]))
    for a, b in zip(_flatten_with_names(cache["cross_kv"])[1], before):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="decode_step"):
        DecodeServer(cfg, params, ServeConfig(batch_slots=2, max_seq=16),
                     device="cpu")
    with pytest.raises(ValueError, match="paged"):
        tmodel.init_paged_cache(cfg, 2, 8, 4, 16, device="cpu")


# ------------------------------------------------------ launcher, resume


def test_launch_train_whisper_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --device cpu --arch
    whisper-large-v3 --reduce 8 --steps 2``: every batch carries frames
    of the reduced shape, the losses are finite and near ln(vocab)."""
    seen = []
    step = tapi.TrainerHandle.train_step

    def spy(self, batch):
        seen.append(tuple(batch["frames"].shape))
        return step(self, batch)

    tapi.TrainerHandle.train_step = spy
    try:
        out = tlaunch.main(["--device", "cpu", "--arch", "whisper-large-v3",
                            "--reduce", "8", "--steps", "2", "--batch", "2",
                            "--seq", "16"])
    finally:
        tapi.TrainerHandle.train_step = step
    assert seen == [(2, 64, 80)] * 2
    losses = np.asarray(out["losses"])
    assert np.isfinite(losses).all() and len(losses) == 2
    assert abs(losses[0] - np.log(2048)) < 1.0
    assert "final loss" in capsys.readouterr().out


def test_resumed_run_sees_the_same_frames(tmp_path):
    """A run checkpointed at step 2 and resumed to step 4 draws at steps
    2 and 3 bitwise the frames an uninterrupted 4-step run drew, and its
    losses there are the uninterrupted run's."""
    argv = ["--device", "cpu", "--arch", "whisper-large-v3", "--reduce", "8",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    seen, run = {}, []
    step = tapi.TrainerHandle.train_step

    def spy(self, batch):
        seen.setdefault(run[-1], {})[int(self.state.meta["step"])] = \
            batch["frames"].clone()
        return step(self, batch)

    tapi.TrainerHandle.train_step = spy
    ckpt = ["--ckpt-dir", str(tmp_path / "c")]
    try:
        run.append("whole")
        whole = tlaunch.main(argv + ["--steps", "4"])
        run.append("first")
        tlaunch.main(argv + ckpt + ["--steps", "2"])
        run.append("resumed")
        resumed = tlaunch.main(argv + ckpt + ["--steps", "4"])
    finally:
        tapi.TrainerHandle.train_step = step
    assert sorted(seen["resumed"]) == [2, 3]
    for s in (2, 3):
        assert torch.equal(seen["resumed"][s], seen["whole"][s])
    assert not torch.equal(seen["whole"][2], seen["whole"][3])
    assert resumed["losses"] == whole["losses"][2:]


# -------------------------------------------------- interop, checkpoints


def test_names_round_trip_interop_and_checkpointers(f32_model, tmp_path):
    """The ``encoder/...`` and ``.../xattn/...`` leaves keep their names
    and bits through ``interop`` and through both checkpointers
    (``manifest.json`` + ``arrays.npz``): the port's save restored by JAX
    and JAX's save restored by the port."""
    _, _, jparams, params = f32_model
    names = _flatten_with_names(params)[0]
    assert "encoder/frontend" in names
    assert "encoder/stages/0/pos0/mlp/w_up" in names
    assert "stages/0/pos0/xattn/wv" in names
    assert "stages/0/pos0/lnx/scale" in names
    assert names == jflat(jparams)[0]
    tckpt.save(tmp_path / "t", 1, params)
    jtree, _ = jckpt.restore(tmp_path / "t", 1, jparams)
    jckpt.save(tmp_path / "j", 2, jtree)
    ttree, _ = tckpt.restore(tmp_path / "j", 2, params)
    for n, a, j, b in zip(names, _flatten_with_names(params)[1],
                          jflat(jtree)[1], _flatten_with_names(ttree)[1]):
        np.testing.assert_array_equal(np.asarray(j), a.numpy(), n)
        assert torch.equal(a, b), n


def test_whisper_tenant_apply_equals_merged_weights(tmp_path):
    """A tenant trained with ``blockllm`` on a whisper (decoder rows and,
    selected at the start, the ``encoder`` leaf) is exported, saved,
    loaded and applied to the base through ``ops.scatter_swap``: the
    applied tree equals the trainer's merged weights bitwise, and so do
    the greedy streams decoded over ``prefill``'s ``cross_kv``; JAX's
    ``apply_delta`` of the port's saved delta gives the same leaves."""
    jcfg, cfg = _cfgs(num_layers=4)
    _, base = _weights(cfg, 7)
    h = trainers.handle("blockllm", cfg, tdelta.copy_tree(base),
                        device="cpu", patience=100, k_frac=0.5)
    for s in range(3):
        tokens, frames = _inputs(cfg, 10 + s, b=2, s=8)
        h.train_step({"tokens": tokens, "frames": frames})
    merged = h.merged_params()
    delta = tdelta.delta_from_trainer(h, base, meta={"adapter_id": "w"})
    rows = {n for n, e in delta.entries.items() if e.idx is not None}
    assert rows and any(n.startswith("encoder/") for n in delta.entries)
    tdelta.save_delta(tmp_path / "w", delta)
    loaded = tdelta.load_delta(tmp_path / "w")
    applied, _ = tdelta.apply_delta(tdelta.copy_tree(base), loaded)
    for n, a, m in zip(*_flatten_with_names(applied)[:2],
                       _flatten_with_names(merged)[1]):
        assert torch.equal(a, m), n
    jbase = jax.tree.map(jnp.asarray, interop.tree_to_numpy(base))
    japplied, _ = jdelta.apply_delta(jbase, jdelta.load_delta(tmp_path / "w"))
    for n, j, m in zip(*jflat(japplied)[:2], _flatten_with_names(merged)[1]):
        np.testing.assert_array_equal(np.asarray(j), m.numpy(), n)
    tokens, frames = _inputs(cfg, 20, b=2, s=4)
    streams = []
    with torch.no_grad():
        for p in (applied, merged):
            _, c = tmodel.prefill(p, cfg, {"tokens": _t(tokens).long(),
                                           "frames": _t(frames)})
            cache = tmodel.init_cache(cfg, 2, 16, dtype=torch.float32,
                                      device="cpu")
            cache["cross_kv"] = c["cross_kv"]
            streams.append(_port_greedy(cfg, p, cache, tokens, 6)[0])
    np.testing.assert_array_equal(streams[0], streams[1])
