"""The VLM family (``pixtral-12b``) in the port against the JAX package.

The architecture is ``pixtral-12b`` cut to 2 layers, d_model 64, 8 query
heads over 2 kv heads of 8 (pixtral's GQA group of 4), d_ff 128 (SwiGLU),
vocab 256 and 8 stub patch embeddings of 32 features; rotary positions at
pixtral's theta 1e9.  Both packages get the same weights (the port's
``init_params`` from a seed, carried to JAX through
``repro_torch.interop``; JAX's own init only through ``jax.eval_shape``)
and the same numpy tokens and patch embeddings.  Tolerances, and why:

- ``_embed``, ``forward``, the prefill cache, decode logits: rtol 1e-4 /
  atol 2e-5, the model tolerance of the other port tests;
- ``loss_fn``: rtol 1e-5;
- gradients: rtol 1e-4 and atol 2e-5 times the leaf's largest magnitude
  where that exceeds 1 (``SCALED``, as ``tests/test_torch_xlstm.py``);
- the rotary frequencies at theta 1e9: bitwise (XLA's CPU ``pow`` and
  PyTorch's agree there at head_dim 8, 16 and 128);
- token streams and everything computed exactly (the packed positions
  past the patches, checkpoint bits): equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro.configs.base import get_config as jget_config
from repro.core import units as junits
from repro.launch.train import reduce_config as jreduce
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import interop
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.configs import base as tconfigs
from repro_torch.core import units as tunits
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.trainers import api as tapi
from tests.test_torch_blockllm import run_trajectory

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=2e-5)
SCALED = "scaled"     # F32_TOL with atol times max(1, max |want|)
SMALL = dict(num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
             head_dim=8, d_ff=128, vocab_size=256, vision_embed_dim=32,
             num_patches=8)
B, S = 2, 12


def _cfgs(dtype="float32", **kw):
    jcfg = jget_config("pixtral-12b").replace(dtype=dtype, **{**SMALL, **kw})
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
    patches = rng.randn(b, cfg.num_patches,
                        cfg.vision_embed_dim).astype(np.float32)
    return tokens, patches


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


def test_config_param_count_and_support_match_jax():
    """The port's ``pixtral-12b`` equals JAX's field for field (40 layers,
    d_model 5120, GQA 32 / 8 at hd 128, vocab 131072, 256 patches of
    1024, theta 1e9), ``reduce_config`` builds JAX's reduced shapes (the
    patches cut to 8 of 64), ``param_count`` gives 12,253,020,160 in both
    packages (JAX's tree, through ``jax.eval_shape``, holds that plus the
    final norm's 5120), and
    ``check_supported`` admits it while slot prefill, paged KV and
    speculation are refused in both packages."""
    j = jget_config("pixtral-12b")
    t = tconfigs.get_config("pixtral-12b")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.family, t.vision_embed_dim, t.num_patches, t.rope_theta) == (
        "vlm", 1024, 256, 1e9)
    for f in (2, 8):
        r = tconfigs.reduce_config(t, f)
        assert dataclasses.asdict(r) == dataclasses.asdict(jreduce(j, f))
    assert (r.vision_embed_dim, r.num_patches) == (64, 8)
    assert t.param_count() == j.param_count() == 12_253_020_160
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, j),
                            jax.random.PRNGKey(0))
    # the tree adds the final norm's scale, which param_count leaves out
    assert sum(int(np.prod(a.shape))
               for a in jax.tree.leaves(shapes)) == 12_253_020_160 + 5120
    tmodel.check_supported(t)
    for fn in ("supports_slot_prefill", "supports_paged_kv",
               "supports_spec_decode"):
        assert not getattr(tmodel, fn)(t) and not getattr(jmodel, fn)(j), fn


def test_init_layout_scale_and_units_match_jax():
    """The port's ``init_params`` has JAX's leaf paths and shapes, with a
    ``vision_proj`` [vision_embed_dim, d_model] at JAX's ``dense_init``
    scale 1 / sqrt(fan_in) (fan-in 256 here, so the scale is not 1 /
    sqrt(d_model)); the draw order of every other leaf is that of the
    same config without a vision frontend.  BlockLLM's units label it as
    JAX's ``param_labels`` do: one whole-leaf unit ``vision_proj``."""
    jcfg, cfg = _cfgs(vision_embed_dim=256)
    jshapes = jax.eval_shape(lambda k: jmodel.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    mine = tmodel.init_params(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    tn, tl, _ = _flatten_with_names(mine)
    jn, jl, _ = jflat(jshapes)
    assert tn == jn and "vision_proj" in tn
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    vp = dict(zip(tn, tl))["vision_proj"]
    assert vp.shape == (256, 64)
    assert abs(float(vp.std()) * np.sqrt(256) - 1) < 0.05
    assert abs(float(vp.mean())) < 0.01 / np.sqrt(256) * 10
    text = tmodel.init_params(cfg.replace(vision_embed_dim=0,
                                          num_patches=0), device="cpu",
                              generator=torch.Generator().manual_seed(3))
    for n, a in zip(*_flatten_with_names(text)[:2]):
        assert torch.equal(dict(zip(tn, tl))[n], a), n
    labels = set(tunits.build_unit_index(cfg, mine).unit_sizes())
    jp = jax.tree.map(jnp.asarray, interop.tree_to_numpy(mine))
    assert labels == set(jmodel.param_labels(jcfg, jp))
    assert junits.build_unit_index(jcfg, jp).unit_sizes() == \
        tunits.build_unit_index(cfg, mine).unit_sizes()


@pytest.mark.parametrize("hd", [8, 16, 128])
def test_rope_at_theta_1e9_matches_jax(hd):
    """Pixtral's rotary base 1e9 (earlier families used 1e4 and 1e6): the
    frequencies ``theta ** -(2i / hd)`` bitwise JAX's, and ``apply_rope``
    at positions up to 4096 within the model tolerance."""
    want = np.asarray(jlayers.rope_freqs(hd, 1e9))
    got = tlayers.rope_freqs(hd, 1e9)
    np.testing.assert_array_equal(got.numpy(), want)
    x = np.random.RandomState(hd).randn(2, 6, 3, hd).astype(np.float32)
    pos = np.asarray([[0, 1, 255, 256, 1000, 4095]] * 2, np.int32)
    _close(tlayers.apply_rope(_t(x), _t(pos), 1e9),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e9),
           F32_TOL)


# ------------------------------------------------------------ model, loss


def test_embed_packing_matches_jax_and_short_sequences_raise(f32_model):
    """``_embed`` with ``patch_embeds``: the first P positions are the
    projected patches (against JAX's), the rest bitwise the token
    embeddings; a sequence shorter than the patches raises (JAX's
    concatenation would lengthen it)."""
    jcfg, cfg, jparams, params = f32_model
    tokens, patches = _inputs(cfg, 1)
    want = jax.jit(lambda p, t, e: jmodel._embed(p, jcfg, t,
                                                 patch_embeds=e))(
        jparams, jnp.asarray(tokens), jnp.asarray(patches))
    with torch.no_grad():
        got = tmodel._embed(params, cfg, _t(tokens).long(),
                            patch_embeds=_t(patches))
        plain = tmodel._embed(params, cfg, _t(tokens).long())
    assert got.shape == (B, S, cfg.d_model)
    _close(got, want, F32_TOL)
    P = cfg.num_patches
    assert torch.equal(got[:, P:], plain[:, P:])
    assert not torch.equal(got[:, :P], plain[:, :P])
    _close(got[:, :P], patches @ params["vision_proj"].numpy(), F32_TOL)
    short = _t(tokens[:, :P - 1]).long()
    with pytest.raises(ValueError, match="patch"):
        tmodel._embed(params, cfg, short, patch_embeds=_t(patches))
    with pytest.raises(ValueError, match="patch"):
        tmodel.forward(params, cfg, short, patch_embeds=_t(patches))
    # exactly P positions: every position is a patch
    full = tmodel._embed(params, cfg, _t(tokens[:, :P]).long(),
                         patch_embeds=_t(patches))
    assert torch.equal(full, got[:, :P])


def test_forward_matches_jax(f32_model):
    """``forward``'s logits with the batch's patch embeddings against
    JAX's, and different from a text-only forward of the same tokens."""
    jcfg, cfg, jparams, params = f32_model
    tokens, patches = _inputs(cfg, 2)
    jl, _, _ = jax.jit(lambda p, b: jmodel.forward(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(tokens),
                  "patch_embeds": jnp.asarray(patches)})
    with torch.no_grad():
        lg = tmodel.forward(params, cfg, _t(tokens).long(),
                            patch_embeds=_t(patches))
        text = tmodel.forward(params, cfg, _t(tokens).long())
    assert lg.shape == (B, S, cfg.vocab_size)
    _close(lg, jl, F32_TOL)
    assert not torch.allclose(lg, text)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    """JAX's loss and gradients (remat off; one compile, shared by the
    port's remat cases)."""
    jcfg, cfg = _cfgs(remat=False)
    jparams, _ = _weights(cfg, 1)
    tokens, patches = _inputs(cfg, 3)
    batch = {"tokens": jnp.asarray(tokens),
             "patch_embeds": jnp.asarray(patches)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, batch, loss_chunk=0),
        has_aux=True))(jparams)
    return jparams, tokens, patches, jl, jg


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    """``loss_fn`` with the batch's ``patch_embeds`` (the patch positions
    keep their next-token labels, as JAX's ``_labels_mask`` keeps them),
    remat off and on, and its gradient with respect to every leaf,
    ``vision_proj`` included, against ``jax.value_and_grad`` of JAX's."""
    _, cfg = _cfgs(remat=remat)
    jparams, tokens, patches, jl, jg = _jax_loss_and_grads()
    names, leaves, td = _flatten_with_names(
        interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                              device="cpu"))
    for leaf in leaves:
        leaf.requires_grad_()
    batch = {"tokens": _t(tokens).long(), "patch_embeds": _t(patches)}
    tl, metrics = tmodel.loss_fn(td.unflatten(leaves), cfg, batch,
                                 loss_chunk=0)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(metrics["tokens"]) == B * (S - 1)
    grads = torch.autograd.grad(tl, leaves)
    jnames, jleaves, _ = jflat(jg)
    assert jnames == names and "vision_proj" in names
    for n, g, j in zip(names, grads, jleaves):
        assert torch.isfinite(g).all() and g.abs().max() > 0, n
        _close(g, j, SCALED, n)


def _plan(units, index):
    """Row 1 of the stack selected, row 0 a probe, the ``vision_proj``
    leaf active."""
    return units.Plan(units.PlanStructure(
        k_per_stack=(("s0/pos0", 1),), probe_per_stack=(("s0/pos0", 1),),
        active_leaves=("vision_proj",)),
        {"s0/pos0": np.asarray([1], np.int32)},
        {"s0/pos0": np.asarray([0], np.int32)})


def test_active_tree_gradients_match_jax(f32_model):
    """The gradient with respect to BlockLLM's active tree (a selected
    row, a probe row and the ``vision_proj`` leaf) through the overlay
    the trainers use and through the explicit ``merge_active`` scatter,
    against JAX's (``SCALED``): ``vision_proj`` swaps in whole, as
    ``embed`` and ``head`` do."""
    jcfg, cfg, jparams, params = f32_model
    tokens, patches = _inputs(cfg, 4)
    jbatch = {"tokens": jnp.asarray(tokens),
              "patch_embeds": jnp.asarray(patches)}
    tbatch = {"tokens": _t(tokens).long(), "patch_embeds": _t(patches)}
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
        merged["vision_proj"] = act["sel"]["leaves"]["vision_proj"]
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
            merged["vision_proj"] = act["sel"]["leaves"]["vision_proj"]
            loss, _ = tmodel.loss_fn(merged, cfg, tbatch, loss_chunk=0,
                                     overlay=ov)
        else:
            loss, _ = tmodel.loss_fn(tunits.merge_active(
                params, tidx, tplan, act), cfg, tbatch, loss_chunk=0)
        grads = torch.autograd.grad(loss, req)
        jnames, jleaves, _ = jflat(jg)
        assert jnames == names and "sel/leaves/vision_proj" in names
        for n, g, j in zip(names, grads, jleaves):
            assert g.abs().max() > 0, n
            _close(g, j, SCALED, f"overlay={overlay} {n}")


def _patch_batch(cfg, step):
    return {"patch_embeds": np.random.RandomState(200 + step).randn(
        4, cfg.num_patches, cfg.vision_embed_dim).astype(np.float32)}


def test_blockllm_trajectory_pixtral_matches_jax():
    """``tests/test_torch_blockllm.py``'s trajectory for 4 steps (the mask
    refresh, three masked steps, the reselection after the last) on
    ``pixtral-12b`` reduced by 8 and cut to 2 layers, the same patch
    embeddings in both packages: losses, selections, masks and final
    rows (``run_trajectory`` holds the active leaf units equal at every
    step).  ``vision_proj`` is a selectable unit that trains: it moves in
    both packages, in the same elements (its masked update), by at most
    the steps' learning rate, and the two packages' ends agree."""
    jh, th = run_trajectory("off", "pixtral-12b", steps=4,
                            batch_extra=_patch_batch, num_layers=2)
    from tests.test_torch_blockllm import _setup
    _, _, jparams0, _ = _setup("pixtral-12b", num_layers=2)
    start = np.asarray(jparams0["vision_proj"])
    jend = np.asarray(jh.state.arrays["params"]["vision_proj"])
    tend = th.merged_params()["vision_proj"].numpy()
    moved_j, moved_t = jend != start, tend != start
    assert moved_j.mean() > 0.05
    assert (moved_j == moved_t).mean() >= 0.999
    assert np.abs(jend - start).max() <= 4 * 1e-3 + 1e-6
    close = np.abs(tend - jend) <= 1e-5 + 1e-3 * np.abs(jend)
    assert close.mean() >= 0.995


# ---------------------------------------------------------------- decoding


def _into(init, pre):
    """A decode cache from ``init_cache`` with ``prefill``'s rows copied
    into its first rows (JAX trees: functional)."""
    return jax.tree.map(
        lambda a, b: a.at[:, :, :b.shape[2]].set(b.astype(a.dtype)),
        init, pre)


def test_prefill_and_greedy_decode_match_jax(f32_model):
    """``prefill`` over the patches and a 12-token prompt (its last
    logits and every K/V row against JAX's), the rows copied into
    ``init_cache(B, 24)``, then 8 greedy ``decode_step``s: every step's
    logits against JAX's and the streams (9 tokens, the first from the
    prefill) equal; the teacher-forced logits equal the port's
    ``forward`` over prompt and stream."""
    jcfg, cfg, jparams, params = f32_model
    tokens, patches = _inputs(cfg, 5)
    jlast, jpre = jax.jit(lambda p, b: jmodel.prefill(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(tokens),
                  "patch_embeds": jnp.asarray(patches)})
    with torch.no_grad():
        last, pre = tmodel.prefill(params, cfg, {
            "tokens": _t(tokens).long(), "patch_embeds": _t(patches)})
    _close(last, jlast, F32_TOL)
    names, leaves, _ = _flatten_with_names(pre)
    jnames, jleaves, _ = jflat(jpre)
    assert names == jnames
    for n, a, b in zip(names, leaves, jleaves):
        assert tuple(a.shape) == tuple(b.shape) == (2, B, S, 2, 8), n
        _close(a, b, F32_TOL, n)
    jcache = _into(jmodel.init_cache(jcfg, B, 24, dtype=jnp.float32), jpre)
    cache = tmodel.init_cache(cfg, B, 24, dtype=torch.float32, device="cpu")
    for a, b in zip(_flatten_with_names(cache)[1], leaves):
        a[:, :, :S] = b
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, jcfg, c, t,
                                                           pos))
    jtok = np.asarray(jnp.argmax(jlast, -1), np.int32)
    tok = last.argmax(-1)
    jout, out, logits = [jtok], [tok], [last]
    with torch.no_grad():
        for t in range(S, S + 8):
            jlg, jcache = step(jparams, jcache, jnp.asarray(jtok[:, None]),
                               jnp.full((B,), t, jnp.int32))
            lg, _ = tmodel.decode_step(params, cfg, cache, tok[:, None],
                                       np.full(B, t, np.int32))
            _close(lg, jlg, F32_TOL, f"position {t}")
            jtok = np.asarray(jnp.argmax(jlg, -1), np.int32)
            tok = lg.argmax(-1)
            jout.append(jtok)
            out.append(tok)
            logits.append(lg)
        np.testing.assert_array_equal(torch.stack(out, 1).numpy(),
                                      np.stack(jout, 1))
        fed = torch.cat([_t(tokens).long(), torch.stack(out[:-1], 1)], 1)
        full = tmodel.forward(params, cfg, fed, patch_embeds=_t(patches))
    _close(torch.stack(logits, 1), full[:, S - 1:].numpy(), F32_TOL)


def test_serving_refuses_a_vlm(f32_model):
    """The serve and fleet launchers refuse a VLM, as JAX's do (requests
    carry no patch embeddings); decoding is model-level."""
    from repro_torch.launch import fleet as tfleet
    for main in (tserve.main, tfleet.main):
        with pytest.raises(SystemExit, match="LM-family"):
            main(["--device", "cpu", "--arch", "pixtral-12b", "--reduce",
                  "8"])


# ------------------------------------------------------ launcher, resume

ARGV = ["--device", "cpu", "--arch", "pixtral-12b", "--reduce", "8",
        "--layers", "2", "--batch", "2", "--seq", "16"]


def test_launch_train_pixtral_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --device cpu --arch
    pixtral-12b --reduce 8 --layers 2 --steps 2``: every batch carries
    patch embeddings of the reduced shape (``patch_embeds_for``), the
    model has 2 layers, the losses are finite and near ln(vocab)."""
    seen = []
    step = tapi.TrainerHandle.train_step

    def spy(self, batch):
        seen.append((tuple(batch["patch_embeds"].shape),
                     self.core.cfg.num_layers))
        return step(self, batch)

    tapi.TrainerHandle.train_step = spy
    try:
        out = tlaunch.main(ARGV + ["--steps", "2"])
    finally:
        tapi.TrainerHandle.train_step = step
    assert seen == [((2, 8, 64), 2)] * 2
    losses = np.asarray(out["losses"])
    assert np.isfinite(losses).all() and len(losses) == 2
    assert abs(losses[0] - np.log(2048)) < 1.0
    assert "final loss" in capsys.readouterr().out
    a = tlaunch.patch_embeds_for(out["trainer"].cfg, 2, 0, 1, "cpu")
    assert torch.equal(a, tlaunch.patch_embeds_for(out["trainer"].cfg, 2,
                                                   0, 1, "cpu"))
    assert not torch.equal(a, tlaunch.patch_embeds_for(
        out["trainer"].cfg, 2, 1, 1, "cpu"))


def test_resumed_run_sees_the_same_patch_embeddings(tmp_path):
    """A run checkpointed at step 2 and resumed to step 4 draws at steps
    2 and 3 bitwise the patch embeddings an uninterrupted 4-step run
    drew, and its losses there are the uninterrupted run's."""
    seen, run = {}, []
    step = tapi.TrainerHandle.train_step

    def spy(self, batch):
        seen.setdefault(run[-1], {})[int(self.state.meta["step"])] = \
            batch["patch_embeds"].clone()
        return step(self, batch)

    tapi.TrainerHandle.train_step = spy
    argv = ARGV + ["--ckpt-every", "2"]
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
    """``vision_proj`` keeps its name and bits through ``interop`` and
    through both checkpointers (``manifest.json`` + ``arrays.npz``): the
    port's save restored by JAX and JAX's save restored by the port."""
    _, _, jparams, params = f32_model
    names = _flatten_with_names(params)[0]
    assert "vision_proj" in names and names == jflat(jparams)[0]
    tckpt.save(tmp_path / "t", 1, params)
    jtree, _ = jckpt.restore(tmp_path / "t", 1, jparams)
    jckpt.save(tmp_path / "j", 2, jtree)
    ttree, _ = tckpt.restore(tmp_path / "j", 2, params)
    for n, a, j, b in zip(names, _flatten_with_names(params)[1],
                          jflat(jtree)[1], _flatten_with_names(ttree)[1]):
        np.testing.assert_array_equal(np.asarray(j), a.numpy(), n)
        assert torch.equal(a, b), n
