"""The paper's baseline trainers in the port (``galore``, ``lora``,
``badam``, ``badam+q8``) against the JAX package, and the memory gate of
all eight trainer cores.

- **Memory gate.**  For every registered core, ``memory_report`` at
  ``tools/check_memory.py``'s ``GATE_ARCH`` / ``GATE_HYPER`` equals
  ``benchmarks/memory_baselines.json`` byte for byte (the test only
  reads those two files).
- **Trajectories**, from JAX's initial weights (LoRA: and one factor
  tree drawn from a fixed numpy seed, put into both packages' states:
  JAX's ``lora_init`` folds Python's salted ``hash`` of the leaf path
  into its key, so its own draw differs from process to process), on the
  same ``TokenPipeline``
  batches, f32 on the CPU:
  - GaLore inside one projection window (``update_proj_gap`` > steps):
    losses within rtol 1e-5 and parameters within atol 1e-5 (the
    projections and the model differ only in summation order);
  - GaLore across refreshes: the refreshed subspaces agree
    (|P_portᵀ P_jax| within 1e-4 of a signed identity), but LAPACK in
    the two packages picks other signs for some projector columns, and
    moments carried across a refresh are not sign invariant, so the
    trajectories part after the second refresh (ROADMAP C).  With both
    packages' projections put into one sign convention (the largest
    entry of each column positive, patched into both in the test) they
    agree within the in-window tolerance again: the signs are the whole
    difference;
  - LoRA, BAdam and BAdam+q8: losses within rtol 1e-4 at every step
    (the bound of the other trainers' trajectory tests), BAdam's block
    selections equal.
- **Checkpoints.**  A port run crashed at step 5 and resumed from its
  step-3 checkpoint equals the uninterrupted run bitwise, and a JAX
  checkpoint resumes in the port, the next losses within rtol 1e-4 of
  JAX's.  GaLore's ``proj`` and LoRA's factor tree hold None leaves,
  which both packages skip in their leaf names.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import trainers as jtrainers
from repro.baselines.galore import GaLore as JGaLore
from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro.data.pipeline import DataConfig, TokenPipeline
from repro.models import model as jmodel
from repro.optim.adam import Adam as JAdam
from repro.runtime import train_loop as jloop
from repro_torch import interop, trainers
from repro_torch.baselines.galore import GaLore
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.configs import base as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.optim.adam import Adam
from repro_torch.runtime import train_loop as tloop

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ["galore", "lora", "badam", "badam+q8"]


def _gate():
    spec = importlib.util.spec_from_file_location(
        "check_memory", ROOT / "tools" / "check_memory.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GATE_ARCH, mod.GATE_HYPER


@pytest.mark.parametrize("name", ["adam", "adam+q8", "badam", "badam+q8",
                                  "blockllm", "blockllm+q8", "galore",
                                  "lora"])
def test_memory_report_equals_committed_baselines(name):
    arch, hyper = _gate()
    want = json.loads((ROOT / "benchmarks" / "memory_baselines.json")
                      .read_text())
    assert sorted(want) == trainers.names() == jtrainers.names()
    cfg = tconfigs.ModelConfig(**arch)
    params = tmodel.init_params(cfg, generator=torch.Generator(
        "cpu").manual_seed(0), device="cpu")
    core = trainers.make(name, cfg, device="cpu", **hyper)
    state = core.init(torch.Generator("cpu").manual_seed(0), params)
    trainers.check_state(core, state)
    assert core.memory_report(state) == want[name]


@pytest.fixture(scope="module")
def setup(tiny_cfg):
    jcfg = tiny_cfg.replace(dtype="float32")
    tcfg = tconfigs.ModelConfig(**dataclasses.asdict(jcfg))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    pipe = TokenPipeline(DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                    global_batch=4, seed=0))
    return jcfg, tcfg, jparams, pipe


def _port(tree):
    return interop.tree_to_torch(jax.tree.map(np.asarray, tree),
                                 device="cpu")


def _handles(name, setup, *, gap=100, switch_every=2):
    """JAX and port handles of one baseline from the same weights."""
    jcfg, tcfg, jparams, _ = setup
    if name == "galore":
        kw = dict(rank=4, lr=1e-3, update_proj_gap=gap)
        jh = jtrainers.handle("galore", jcfg, jparams, galore=JGaLore(**kw))
        th = trainers.handle("galore", tcfg, _port(jparams), device="cpu",
                             galore=GaLore(**kw))
        return jh, th
    kw = dict(rank=4) if name == "lora" else dict(switch_every=switch_every)
    jh = jtrainers.handle(name, jcfg, jparams, adam=JAdam(lr=1e-3), **kw)
    th = trainers.handle(name, tcfg, _port(jparams), device="cpu",
                         adam=Adam(lr=1e-3), **kw)
    if name == "lora":
        # JAX's lora_init draws A under Python's salted hash of the leaf
        # path, so each process would start from other factors: both
        # packages start from one numpy draw instead (B = 0, A ~ N(0,
        # 1/m), lora_init's distributions), the same under every salt
        jf = _pinned_factors(jh.state.arrays["factors"])
        jh.state.arrays["factors"] = jf
        jh.state.arrays["opt"] = jh.core.adam.init(jf)
        factors = _port(jf)
        th.state.arrays["factors"] = factors
        th.state.arrays["opt"] = th.core.adam.init(factors)
    return jh, th


def _pinned_factors(tree, seed=0):
    """LoRA factors shaped as ``tree`` drawn from a fixed numpy seed: each
    ``A`` [..., m, r] normal / sqrt(m) in the tree's leaf order, each
    ``B`` zero."""
    rng = np.random.RandomState(seed)

    def draw(f):
        if f is None:
            return None
        m = f["A"].shape[-2]
        a = rng.standard_normal(f["A"].shape) / np.sqrt(m)
        return {"A": jnp.asarray(a, jnp.float32),
                "B": jnp.zeros(f["B"].shape, jnp.float32)}

    return jax.tree.map(draw, tree, is_leaf=lambda x: x is None or (
        isinstance(x, dict) and "A" in x))


def _losses(jh, th, pipe, steps, rtol, start=0):
    lj, lt = [], []
    for s in range(start, start + steps):
        b = pipe.batch(s)
        lj.append(jh.train_step(b)["loss"])
        lt.append(th.train_step({"tokens": np.asarray(b["tokens"])})["loss"])
        if rtol is not None:
            np.testing.assert_allclose(lt[-1], lj[-1], rtol=rtol,
                                       err_msg=f"step {s}")
    return lj, lt


def _params_close(jh, th, atol):
    got = interop.named_numpy(th.state.arrays["params"])
    names, leaves, _ = jflat(jh.state.arrays["params"])
    assert list(got) == names
    for n, leaf in zip(names, leaves):
        np.testing.assert_allclose(got[n], np.asarray(leaf), rtol=0,
                                   atol=atol, err_msg=n)


def test_galore_trajectory_inside_one_window(setup):
    jh, th = _handles("galore", setup, gap=100)
    _losses(jh, th, setup[3], 6, rtol=1e-5)
    _params_close(jh, th, atol=1e-5)
    jn, _, _ = jflat(jh.state.arrays["opt"].proj)
    tn, _, _ = _flatten_with_names(th.state.arrays["opt"].proj)
    # the embedding and the head qualify: they are projected too
    assert tn == jn and "embed" in tn and "head" in tn


def _subspace(jh, th):
    """Per projected leaf: (how far |P_portᵀ P_jax| is from the identity,
    the share of columns whose signs agree)."""
    jn, jl, _ = jflat(jh.state.arrays["opt"].proj)
    tn, tl, _ = _flatten_with_names(th.state.arrays["opt"].proj)
    assert tn == jn
    out = {}
    for n, a, b in zip(jn, jl, tl):
        m = np.einsum("...mr,...ms->...rs", np.asarray(a), b.numpy())
        d = np.diagonal(m, axis1=-2, axis2=-1)
        eye = np.eye(m.shape[-1])
        out[n] = (np.abs(np.abs(m) - eye).max(), float((d > 0).mean()))
    return out


_JAX_SVD_PROJ = JGaLore._svd_proj
_PORT_SVD_PROJ = GaLore._svd_proj


def _canonical_jax(self, g, side, r):
    """JAX's projection with each column flipped so that its largest
    entry is positive."""
    jnp = jax.numpy
    p = _JAX_SVD_PROJ(self, g, side, r)
    idx = jnp.argmax(jnp.abs(p), axis=-2)[..., None, :]
    return p * jnp.sign(jnp.take_along_axis(p, idx, axis=-2))


def _canonical_port(self, g, side, r):
    """The port's projection in the same sign convention."""
    p = _PORT_SVD_PROJ(self, g, side, r)
    idx = p.abs().argmax(dim=-2, keepdim=True)
    return p * torch.sign(torch.gather(p, -2, idx))


def test_galore_across_refreshes_parts_only_by_svd_signs(setup,
                                                         monkeypatch):
    pipe = setup[3]
    jh, th = _handles("galore", setup, gap=3)
    lj, lt = _losses(jh, th, pipe, 3, rtol=1e-5)    # the first window
    _losses(jh, th, pipe, 1, rtol=1e-5, start=3)   # second refresh here
    sub = _subspace(jh, th)
    assert max(e for e, _ in sub.values()) <= 1e-4, sub
    signs_agree = min(a for _, a in sub.values()) == 1.0
    lj, lt = _losses(jh, th, pipe, 2, rtol=None, start=4)
    if signs_agree:
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
    # one sign convention in both packages: the trajectories agree across
    # the refreshes
    monkeypatch.setattr(JGaLore, "_svd_proj", _canonical_jax)
    monkeypatch.setattr(GaLore, "_svd_proj", _canonical_port)
    jh, th = _handles("galore", setup, gap=3)
    _losses(jh, th, pipe, 7, rtol=1e-5)
    _params_close(jh, th, atol=1e-5)


@pytest.mark.parametrize("name", ["lora", "badam", "badam+q8"])
def test_baseline_trajectory_matches_jax(setup, name):
    jh, th = _handles(name, setup, switch_every=2)
    for s in range(6):
        b = setup[3].batch(s)
        lj = jh.train_step(b)["loss"]
        lt = th.train_step({"tokens": np.asarray(b["tokens"])})["loss"]
        np.testing.assert_allclose(lt, lj, rtol=1e-4, err_msg=f"step {s}")
        if name != "lora":
            for key in ("stack_idx", "active_leaves", "reselections"):
                assert th.state.meta[key] == jh.state.meta[key], (s, key)
    if name == "lora":
        # the merged weights (the export hook) agree too
        got = interop.named_numpy(th.merged_params())
        names, leaves, _ = jflat(jh.merged_params())
        for n, leaf in zip(names, leaves):
            np.testing.assert_allclose(got[n], np.asarray(leaf), rtol=0,
                                       atol=1e-5, err_msg=n)
    else:
        assert th.state.meta["reselections"] == 4     # a switch every 2


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_crash_resume_is_bitwise(setup, tmp_path, name, one_thread):
    """BAdam switches blocks every 100 steps here: a restore takes the
    fresh state's tree, so the selected block must not change before the
    checkpoint (both packages, ROADMAP C)."""
    pipe = setup[3]

    def handle():
        return _handles(name, setup, gap=2, switch_every=100)[1]

    whole = handle()
    tloop.run(whole, pipe.batch, tloop.TrainLoopConfig(total_steps=6,
                                                       log_every=0))
    cfg = tloop.TrainLoopConfig(total_steps=6, ckpt_every=3, log_every=0,
                                ckpt_dir=str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="simulated node failure"):
        tloop.run(handle(), pipe.batch, cfg, crash_at=5)
    resumed = handle()
    out = tloop.run(resumed, pipe.batch, cfg)
    assert len(out["losses"]) == 3
    assert resumed.state.meta == whole.state.meta
    na, la, _ = _flatten_with_names(whole.state.arrays)
    nb, lb, _ = _flatten_with_names(resumed.state.arrays)
    assert na == nb
    for n, a, b in zip(na, la, lb):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), n


@pytest.mark.parametrize("name", BASELINES)
def test_jax_checkpoint_of_baseline_resumes_in_port(setup, tmp_path, name):
    pipe = setup[3]
    jh, th = _handles(name, setup, gap=100, switch_every=100)
    ckpt = str(tmp_path / "ckpt")
    jloop.run(jh, pipe.batch, jloop.TrainLoopConfig(
        total_steps=3, ckpt_every=3, ckpt_dir=ckpt, log_every=0))
    names = jflat(jh.state.arrays)[0]
    assert names == _flatten_with_names(th.state.arrays)[0]
    out = tloop.run(th, pipe.batch, tloop.TrainLoopConfig(
        total_steps=6, ckpt_every=100, ckpt_dir=ckpt, log_every=0))
    want = [jh.train_step(pipe.batch(s))["loss"] for s in range(3, 6)]
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4)
    assert th.state.meta["step"] == 6
