"""Port serving stack (``repro_torch.runtime`` / ``launch``) against JAX.

A port ``DecodeServer`` serving the base model plus two demo adapter
tenants emits exactly the token streams of the JAX ``DecodeServer``
(``attn_impl="full"``, f32 compute) on the same weights and requests,
in the adapter-aware and round-robin schedulers, with chunked and with
per-token priming; its ``stats()`` sections carry the same keys.  Also:
the launcher runs on the CPU when asked, and nothing runs on the CPU
unless asked.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.adapters import InMemoryRegistry as JInMemory
from repro.adapters import extract_delta as jextract
from repro.adapters.testing import perturb_rows as jperturb
from repro.models import model as jmodel
from repro.runtime.serve_config import SchedConfig as JSched
from repro.runtime.serve_config import ServeConfig as JServeConfig
from repro.runtime.serve_loop import DecodeServer as JServer
from repro.runtime.serve_loop import Request as JRequest
from repro_torch import interop
from repro_torch.adapters import InMemoryRegistry, extract_delta
from repro_torch.adapters.testing import perturb_rows
from repro_torch.configs import base as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.runtime.serve_config import SchedConfig, ServeConfig
from repro_torch.runtime.serve_loop import DecodeServer, Request

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TENANTS = [None, "demo0", "demo1"]


@pytest.fixture(scope="module")
def setup(tiny_cfg):
    import dataclasses
    jcfg = tiny_cfg.replace(dtype="float32")
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = tconfigs.ModelConfig(**dataclasses.asdict(jcfg))
    params = interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    jreg, reg = JInMemory(), InMemoryRegistry()
    for i, aid in enumerate(TENANTS[1:]):
        jreg.put(aid, jextract(jparams, jperturb(jparams, rows=(1 + i % 2, 3),
                                                 seed=i)))
        reg.put(aid, extract_delta(params, perturb_rows(
            params, rows=(1 + i % 2, 3), seed=i)))
    return jcfg, jparams, jreg, cfg, params, reg


def _requests(cls, vocab):
    rng = np.random.default_rng(7)
    return [cls(rid=i, prompt=rng.integers(0, vocab, 3 + (5 * i) % 8),
                max_new_tokens=4 + i % 3, adapter_id=TENANTS[i % 3])
            for i in range(7)]


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


@pytest.mark.parametrize("aware", [True, False])
@pytest.mark.parametrize("chunk", [4, 0])
def test_streams_match_jax_server(setup, aware, chunk):
    """Per-token priming (``chunk=0``) is held against the JAX server's
    chunked streams: the JAX per-token path hands host numpy buffers to
    ``jnp.asarray``, which aliases small arrays on the CPU, and mutates
    them while the dispatch may still read them, so its streams depend
    on timing (ROADMAP queue C)."""
    jcfg, jparams, jreg, cfg, params, reg = setup
    kw = dict(batch_slots=3, max_seq=32, attn_impl="full",
              prefill_chunk=chunk)
    jsrv = JServer(jcfg, jparams, JServeConfig(
        sched=JSched(steps_per_turn=2, adapter_aware=aware),
        **dict(kw, prefill_chunk=4)), registry=jreg)
    srv = DecodeServer(cfg, params, ServeConfig(
        sched=SchedConfig(steps_per_turn=2, adapter_aware=aware), **kw),
        registry=reg, device="cpu")
    jreqs = _requests(JRequest, jcfg.vocab_size)
    reqs = _requests(Request, cfg.vocab_size)
    for jr, r in zip(jreqs, reqs):
        jsrv.submit(jr)
        srv.submit(r)
    jsrv.run_until_drained()
    srv.run_until_drained()
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert srv.steps == jsrv.steps and srv.swaps == jsrv.swaps
    if chunk:
        assert srv.prefill_dispatches == jsrv.prefill_dispatches
    else:
        assert srv.prefill_dispatches == srv.prefill_prompt_tokens
    st, jst = srv.stats(), jsrv.stats()
    assert _keys(st) == _keys(jst)
    assert st["stats_version"] == 2 and st["sched"]["compiles"] == 0
    # the resident weights revert to the base bit-exactly
    srv.restore_base()
    got = interop.named_numpy(srv.params)
    for name, arr in interop.named_numpy(params).items():
        assert got[name].tobytes() == arr.tobytes(), name


def test_kernel_attention_server_runs_and_streams(setup):
    """``attn_impl="kernel"`` (the plain version on the CPU) serves the
    same requests to completion, streaming every token."""
    _, _, _, cfg, params, reg = setup
    srv = DecodeServer(cfg, params, ServeConfig(batch_slots=3, max_seq=32),
                       registry=reg, device="cpu")
    seen = {}
    reqs = _requests(Request, cfg.vocab_size)
    for r in reqs:
        r.on_token = lambda t, rid=r.rid: seen.setdefault(rid, []).append(t)
        srv.submit(r)
    srv.run_until_drained()
    assert all(r.done and len(r.out) == r.max_new_tokens for r in reqs)
    assert {r.rid: r.out for r in reqs} == seen


def test_device_is_never_silently_cpu(setup, monkeypatch):
    _, _, _, cfg, params, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeServer(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--quick"])


@pytest.mark.parametrize("change", [
    dict(kv={"layout": "paged"}), dict(spec={"draft": 2}),
    dict(sched={"cache_bytes": 1 << 20})])
def test_unported_serving_features_raise(setup, change):
    _, _, _, cfg, params, reg = setup
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeServer(cfg, params, ServeConfig(**change), registry=reg,
                     device="cpu")


def test_spec_accept_equals_jax():
    from repro.runtime.serve_loop import spec_accept as jaccept
    from repro_torch.runtime.serve_loop import spec_accept
    for draft, verify in [([1, 2, 3], [1, 2, 3, 4]), ([1, 2, 3], [1, 5, 3, 4]),
                          ([], [7]), ([4], [5, 6])]:
        assert spec_accept(draft, verify) == jaccept(draft, verify)
    with pytest.raises(ValueError):
        spec_accept([1, 2], [1, 2])


def test_serve_config_choices_and_round_trip():
    cfg = ServeConfig(attn_impl="full", sched=SchedConfig(swap_mode="plain"))
    assert ServeConfig.from_json(cfg.to_json()) == cfg
    assert ServeConfig().attn_impl == "kernel"
    with pytest.raises(ValueError, match="attn_impl"):
        ServeConfig(attn_impl="pallas")
    with pytest.raises(ValueError, match="swap_mode"):
        SchedConfig(swap_mode="xla")


def test_launcher_quick_on_cpu(capsys, tmp_path):
    trace = tmp_path / "t.json"
    reqs = tserve.main(["--device", "cpu", "--quick", "--demo-adapters", "2",
                        "--trace", str(trace)])
    out = capsys.readouterr().out
    assert len(reqs) == 6 and all(r.done for r in reqs)
    assert "served 6 requests" in out and "adapter swaps:" in out
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"decode_step", "swap_apply", "prefill"} <= names
    # the JAX package's trace checker reads the port's trace unchanged
    r = subprocess.run([sys.executable, str(ROOT / "tools/check_trace.py"),
                        "--kind", "serve", str(trace)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port (and chip_smoke.py) in a fresh
    interpreter pulls in neither ``jax`` nor any ``repro.`` module; the
    training slice's modules are among them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "need = {'repro_torch.' + m for m in (\n"
        "    'core.blockllm', 'core.selection', 'core.units', 'optim.adam',\n"
        "    'optim.q8adam', 'optim.schedule', 'kernels.masked_adam',\n"
        "    'trainers.blockllm', 'trainers.full_adam', 'data.pipeline',\n"
        "    'runtime.train_loop', 'runtime.compression', 'launch.train',\n"
        "    'obs.emit', 'runtime.straggler')}\n"
        "missing = sorted(need - set(mods))\n"
        "print(len(mods), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(mods) < 55 else 0)\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
