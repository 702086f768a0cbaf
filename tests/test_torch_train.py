"""The port's training loop: crash-resume, JAX checkpoints, delta export
to serving, the launcher, and full Adam against the JAX package.

- A port run checkpointed at step 3 and crashed at step 5, then resumed
  to step 6, equals the uninterrupted run bitwise (arrays and host meta).
- A checkpoint written by the JAX ``train_loop`` resumes in the port; the
  next 3 losses equal the JAX run's within rtol 1e-4.
- ``TrainLoopConfig(adapter_dir=...)`` exports a BlockDelta; the port's
  ``DecodeServer`` serves that tenant, and its tokens equal a server
  whose base has the trained rows written in.
- ``python -m repro_torch.launch.train --device cpu`` runs ``blockllm``
  and ``blockllm+q8``; ``adam`` on ``llama-60m --reduce 8`` follows the
  JAX loss curve within rtol 1e-4 (no masks: only summation order).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import trainers as jtrainers
from repro.configs.base import get_config as jget_config
from repro.data.pipeline import DataConfig, TokenPipeline
from repro.launch.train import reduce_config as jreduce
from repro.models import model as jmodel
from repro.optim.adam import Adam as JAdam
from repro.runtime import train_loop as jloop
from repro_torch import interop, trainers
from repro_torch.adapters import AdapterRegistry
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.configs import base as tconfigs
from repro_torch.core.blockllm import BlockLLMConfig
from repro_torch.core.selection import SelectorConfig
from repro_torch.launch import train as tlaunch
from repro_torch.optim.adam import Adam
from repro_torch.runtime import train_loop as tloop
from repro_torch.runtime.serve_config import ServeConfig
from repro_torch.runtime.serve_loop import DecodeServer, Request

torch.set_num_threads(2)


def _setup(arch="internlm2-1.8b", dtype="float32"):
    jcfg = jreduce(jget_config(arch), 8).replace(dtype=dtype)
    tcfg = tconfigs.ModelConfig(**dataclasses.asdict(jcfg))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    pipe = TokenPipeline(DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                    global_batch=4, seed=0))
    return jcfg, tcfg, jparams, tparams, pipe


def _port_handle(name, tcfg, tparams):
    """Patience 2 (reselections within the run) with the leaf units
    always active: restore takes the fresh state's tree structure (in
    both packages), so the active leaf set must not change (ROADMAP C)."""
    params = jax.tree.map(lambda a: a.clone(), tparams)
    bcfg = BlockLLMConfig(selector=SelectorConfig(
        patience=2, always_active_leaves=("final_norm", "embed", "head")))
    return trainers.handle(name, tcfg, params, device="cpu",
                           adam=Adam(lr=1e-3), bcfg=bcfg)


@pytest.fixture
def one_thread():
    """Bitwise comparisons between runs in one process run on one CPU
    thread.  The multi-threaded CPU kernels promise no fixed summation
    order: on a loaded machine the first step of one run in six differed
    in the last bits with several threads.  One thread has one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("name", ["blockllm", "blockllm+q8"])
def test_crash_resume_is_bitwise(tmp_path, name, one_thread):
    _, tcfg, _, tparams, pipe = _setup()
    batch_fn = pipe.batch
    whole = _port_handle(name, tcfg, tparams)
    tloop.run(whole, batch_fn, tloop.TrainLoopConfig(total_steps=6,
                                                     log_every=0))
    cfg = tloop.TrainLoopConfig(total_steps=6, ckpt_every=3, log_every=0,
                                ckpt_dir=str(tmp_path / "ckpt"))
    crashed = _port_handle(name, tcfg, tparams)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        tloop.run(crashed, batch_fn, cfg, crash_at=5)
    resumed = _port_handle(name, tcfg, tparams)
    out = tloop.run(resumed, batch_fn, cfg)
    assert len(out["losses"]) == 3 and len(out["step_ms"]) == 3
    assert resumed.state.meta == whole.state.meta
    assert whole.state.meta["reselections"] > 1     # patience 2 reselected
    na, la, _ = _flatten_with_names(whole.state.arrays)
    nb, lb, _ = _flatten_with_names(resumed.state.arrays)
    assert na == nb
    for n, a, b in zip(na, la, lb):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), n


def test_jax_checkpoint_resumes_in_port(tmp_path):
    jcfg, tcfg, jparams, tparams, pipe = _setup()
    kw = dict(sparsity=0.9, k_frac=0.34)
    jh = jtrainers.handle("blockllm", jcfg, jparams, adam=JAdam(lr=1e-3),
                          **kw)
    ckpt = str(tmp_path / "ckpt")
    jloop.run(jh, pipe.batch, jloop.TrainLoopConfig(
        total_steps=3, ckpt_every=3, ckpt_dir=ckpt, log_every=0))
    th = trainers.handle("blockllm", tcfg, tparams, device="cpu",
                         adam=Adam(lr=1e-3), **kw)
    out = tloop.run(th, pipe.batch, tloop.TrainLoopConfig(
        total_steps=6, ckpt_every=100, ckpt_dir=ckpt, log_every=0))
    want = [jh.train_step(pipe.batch(s))["loss"] for s in range(3, 6)]
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4)
    assert th.state.meta["step"] == 6


def test_export_then_serve_trained_tenant(tmp_path, one_thread):
    _, tcfg, _, tparams, pipe = _setup(dtype="bfloat16")
    base = jax.tree.map(lambda a: a.clone(), tparams)
    th = trainers.handle("blockllm", tcfg, tparams, device="cpu",
                         adam=Adam(lr=1e-2), sparsity=0.9, k_frac=0.34)
    reg_dir = tmp_path / "adapters"
    tloop.run(th, pipe.batch, tloop.TrainLoopConfig(
        total_steps=4, ckpt_every=2, ckpt_dir=str(tmp_path / "ckpt"),
        adapter_dir=str(reg_dir), adapter_id="tuned", log_every=0))
    registry = AdapterRegistry(reg_dir)
    assert registry.list_adapters() == ["tuned"]
    delta = registry.get("tuned")
    assert delta.num_rows() > 0
    assert delta.meta["step"] == 4
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, 5 + i) for i in range(4)]

    def serve(params, reg, tenant):
        srv = DecodeServer(tcfg, params, ServeConfig(
            batch_slots=2, max_seq=32, attn_impl="kernel"), registry=reg,
            device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6, adapter_id=tenant)
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        return [r.out for r in reqs], srv

    got, srv = serve(base, registry, "tuned")
    assert srv.stats()["sched"]["swaps"] >= 1
    want, _ = serve(th.merged_params(), None, None)
    assert got == want


@pytest.mark.parametrize("opt", ["blockllm", "blockllm+q8"])
def test_launcher_on_cpu(capsys, opt):
    out = tlaunch.main(["--device", "cpu", "--arch", "llama-60m",
                        "--reduce", "8", "--steps", "12", "--batch", "4",
                        "--seq", "32", "--optimizer", opt])
    text = capsys.readouterr().out
    assert "step 10: loss=" in text and "final loss:" in text
    assert "memory report:" in text
    assert len(out["losses"]) == 12 and np.isfinite(out["losses"]).all()
    assert out["trainer"].core.quantize_state == (opt == "blockllm+q8")


def test_full_adam_matches_jax_on_llama60m():
    jcfg, tcfg, jparams, tparams, pipe = _setup("llama-60m")
    jh = jtrainers.handle("adam", jcfg, jparams, adam=JAdam(lr=1e-3))
    th = trainers.handle("adam", tcfg, tparams, device="cpu",
                         adam=Adam(lr=1e-3))
    for step in range(6):
        b = pipe.batch(step)
        lj = jh.train_step(b)["loss"]
        lt = th.train_step({"tokens": np.asarray(b["tokens"])})["loss"]
        np.testing.assert_allclose(lt, lj, rtol=1e-4, err_msg=str(step))
    rep = th.memory_report()
    assert rep["opt_state_bytes"] == 2 * rep["params_bytes"]


def test_unported_paths_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="A8"):
        tlaunch.main(["--device", "cpu", "--reduce", "8", "--steps", "1",
                      "--optimizer", "lora"])
    with pytest.raises(NotImplementedError, match="A4"):
        tloop.TrainLoopConfig(quantize_deltas=True)
    # no silent CPU: without a card the default device raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = _setup()[1]
    for name in ("blockllm", "blockllm+q8", "adam"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainers.make(name, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--reduce", "8", "--steps", "1"])
