"""Port self-speculative serving (``model.verify_into_slots``,
``adapters.flip_delta``, the speculative ``DecodeServer`` step) against
the JAX package and against plain decoding.

- ``verify_into_slots`` logits and written K/V rows against JAX's, dense
  and paged: rtol 1e-4 / atol 2e-5 (f32 model and caches; the packages
  multiply in different orders; JAX scores the chunk in one pass, the
  port through K decode steps).  Within the port the verify gives the
  logits and rows of K per-token decode steps bit for bit, with either
  attention.
- Speculative streams equal plain streams (dense and paged, round-robin
  and adapter-aware), including mid-stream rejections that roll pages
  back; ``flip_delta`` is a bitwise involution.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jmodel
from repro_torch import interop
from repro_torch.adapters import (InMemoryRegistry, apply_delta,
                                  extract_delta, flip_delta)
from repro_torch.adapters.testing import perturb_rows
from repro_torch.configs import base as tconfigs
from repro_torch.configs.base import BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN
from repro_torch.models import model as tmodel
from repro_torch.runtime.paged_kv import PageAllocator, pages_for
from repro_torch.runtime.serve_config import (KVConfig, SchedConfig,
                                              ServeConfig, SpecConfig)
from repro_torch.runtime.serve_loop import DecodeServer, Request

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-4, atol=2e-5)
B, MAX_SEQ, PS, L, S0 = 3, 48, 8, 6, 2


@pytest.fixture(scope="module")
def setup(tiny_cfg):
    jcfg = tiny_cfg.replace(dtype="float32")
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = tconfigs.ModelConfig(**dataclasses.asdict(jcfg))
    params = interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jcfg, jparams, cfg, params


def _table():
    per_slot = MAX_SEQ // PS
    perm = 1 + np.random.RandomState(2).permutation(B * per_slot)
    return perm.reshape(B, per_slot).astype(np.int32)


def _toks():
    return np.random.default_rng(0).integers(1, 128, (B, L)).astype(np.int32)


def _port_cache(cfg, layout):
    if layout == "paged":
        return tmodel.init_paged_cache(cfg, B, B * MAX_SEQ // PS + 1, PS,
                                       MAX_SEQ, dtype=torch.float32,
                                       device="cpu")
    return tmodel.init_cache(cfg, B, MAX_SEQ, dtype=torch.float32,
                             device="cpu")


def _port_decode(cfg, params, cache, toks, pos, layout, active=None,
                 impl="full"):
    kw = {"page_table": torch.from_numpy(_table())} if layout == "paged" \
        else {}
    lg, _ = tmodel.decode_step(params, cfg, cache, torch.from_numpy(toks),
                               torch.from_numpy(pos), attn_impl=impl,
                               active=active, **kw)
    return lg.numpy()


def _port_verify(cfg, params, layout, active=np.ones(B, bool), impl="full"):
    """Prime S0 tokens per slot per-token, then verify L - S0 at once."""
    cache = _port_cache(cfg, layout)
    toks = _toks()
    for i in range(S0):
        _port_decode(cfg, params, cache, toks[:, i:i + 1],
                     np.full(B, i, np.int32), layout, impl=impl)
    vlog, _ = tmodel.verify_into_slots(
        params, cfg, cache, torch.from_numpy(toks[:, S0:]),
        np.full(B, S0, np.int32), active,
        page_table=_table() if layout == "paged" else None, attn_impl=impl)
    return vlog.numpy(), cache


def _leaves(cache):
    return [a for st in cache["stages"] for blk in st.values()
            for a in blk.values()]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_into_slots_matches_jax(setup, layout):
    jcfg, jparams, cfg, params = setup
    toks = _toks()
    if layout == "paged":
        tbl = jnp.asarray(_table())
        jcache = jmodel.init_paged_cache(jcfg, B, B * MAX_SEQ // PS + 1, PS,
                                         MAX_SEQ, dtype=jnp.float32)
        kw = dict(page_table=tbl, active=jnp.ones(B, bool))
        vkw = dict(page_table=tbl)
    else:
        jcache = jmodel.init_cache(jcfg, B, MAX_SEQ, dtype=jnp.float32)
        kw, vkw = {}, {}
    for i in range(S0):
        _, jcache = jmodel.decode_step(jparams, jcfg, jcache,
                                       jnp.asarray(toks[:, i:i + 1]),
                                       jnp.full(B, i, jnp.int32),
                                       attn_impl="full", **kw)
    want, jcache = jmodel.verify_into_slots(
        jparams, jcfg, jcache, jnp.asarray(toks[:, S0:]),
        jnp.full(B, S0, jnp.int32), jnp.ones(B, bool), **vkw)
    got, cache = _port_verify(cfg, params, layout)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)
    for a, w in zip(_leaves(cache), jax.tree.leaves(jcache["stages"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("impl", ["full", "kernel"])
def test_verify_equals_per_token_decode(setup, layout, impl):
    """Verify scores what K decode steps would, bit for bit: logits and
    written rows (``kernel`` runs the kernels' plain versions here)."""
    _, _, cfg, params = setup
    cache = _port_cache(cfg, layout)
    toks = _toks()
    ref = [_port_decode(cfg, params, cache, toks[:, i:i + 1],
                        np.full(B, i, np.int32), layout, impl=impl)
           for i in range(L)]
    vlog, vcache = _port_verify(cfg, params, layout, impl=impl)
    for j in range(L - S0):
        assert np.array_equal(vlog[:, j], ref[S0 + j])
    for a, b in zip(_leaves(cache), _leaves(vcache)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_leaves_inactive_slots_untouched(setup, layout):
    _, _, cfg, params = setup
    act = np.asarray([True, False, True])
    _, cache = _port_verify(cfg, params, layout, active=act)
    ref = _port_cache(cfg, layout)
    toks = _toks()
    for i in range(S0):
        _port_decode(cfg, params, ref, toks[:, i:i + 1],
                     np.full(B, i, np.int32), layout)
    # slot 1's rows: its cache row (dense) or the pages its table maps
    rows = (slice(None), 1 if layout == "dense"
            else torch.from_numpy(_table()[1].astype(np.int64)))
    for a, r in zip(_leaves(cache), _leaves(ref)):
        assert torch.equal(a[rows], r[rows])


def test_flip_delta_is_a_bitwise_involution(setup):
    _, _, _, params = setup
    base = {k: v for k, v in params.items()}
    tuned = perturb_rows(params, rows=(1, 3), seed=4)
    d = extract_delta(params, tuned)
    live, disp = apply_delta(interop.tree_to_torch(
        interop.tree_to_numpy(params), device="cpu"), d)
    snap = interop.named_numpy(live)
    flipped, back = flip_delta(live, disp)
    assert flipped is not None
    for name, arr in interop.named_numpy(base).items():
        assert interop.named_numpy(flipped)[name].tobytes() == arr.tobytes()
    again, _ = flip_delta(flipped, back)
    for name, arr in snap.items():
        assert interop.named_numpy(again)[name].tobytes() == arr.tobytes()


def test_supports_spec_decode_gate(tiny_cfg):
    cfg = tconfigs.ModelConfig(**dataclasses.asdict(tiny_cfg.replace(
        pattern=(BLOCK_LOCAL_ATTN, BLOCK_GLOBAL_ATTN), window_size=8)))
    assert not tmodel.supports_spec_decode(cfg)
    params = tmodel.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="speculate"):
        DecodeServer(cfg, params, ServeConfig(spec=SpecConfig(draft=2)),
                     device="cpu")


# --------------------------------------------------------------------- #
# speculative serving
# --------------------------------------------------------------------- #


def _registry(params, scales=((0.02, 10), (0.4, 20))):
    reg = InMemoryRegistry()
    for i, (scale, seed) in enumerate(scales):
        aid = "AB"[i]
        reg.put(aid, extract_delta(params, perturb_rows(
            params, rows=(i, i + 2), scale=scale, seed=seed),
            meta={"adapter_id": aid}))
    return reg


def _drain(cfg, params, tenancy, reg, *, draft=0, layout="dense",
           aware=True, impl="kernel", new_tokens=7):
    srv = DecodeServer(cfg, params, ServeConfig(
        batch_slots=2, max_seq=64, attn_impl=impl,
        sched=SchedConfig(steps_per_turn=2, adapter_aware=aware),
        kv=KVConfig(layout=layout, page_size=8),
        spec=SpecConfig(draft=draft)), registry=reg, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, 128, 3 + (3 * i) % 9),
                    max_new_tokens=new_tokens, adapter_id=t)
            for i, t in enumerate(tenancy)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    assert all(r.done and len(r.out) == new_tokens for r in reqs)
    return {r.rid: tuple(r.out) for r in reqs}, srv


TENANCY = ["A", "B", None, "B", "A", None]


@pytest.mark.parametrize("layout,aware,impl", [
    ("dense", True, "kernel"), ("dense", False, "full"),
    ("paged", True, "kernel"), ("paged", False, "full")])
def test_spec_streams_equal_plain(setup, layout, aware, impl):
    _, _, cfg, params = setup
    reg = _registry(params)
    plain, psrv = _drain(cfg, params, TENANCY, reg, layout=layout,
                         aware=aware, impl=impl)
    spec, srv = _drain(cfg, params, TENANCY, reg, draft=3, layout=layout,
                       aware=aware, impl=impl)
    assert spec == plain
    st = srv.stats()["spec"]
    assert st["rounds"] > 0 and st["tokens_per_step"] > 1.0
    # n draft + n + 1 verify decode passes per round, n >= 1
    assert st["passes"] >= 3 * st["rounds"]
    assert st["flips"] >= 2 and srv.steps < psrv.steps
    assert srv.stats()["sched"]["swaps"] > 0
    if layout == "paged":
        # drained: the only pages still held are the prefix registry's
        assert srv.alloc.pages_in_use == len(set(srv.alloc._chain.values()))
        assert set(srv.stats()["kv"]) >= {"spec_rollback_pages",
                                          "page_size", "num_pages"}


def test_spec_midstream_rejection_rolls_back_paged(setup):
    """A strongly perturbed tenant rejects most drafts: the paged path
    unmaps the speculative pages and still emits the plain stream."""
    _, _, cfg, params = setup
    reg = InMemoryRegistry({"T": extract_delta(params, perturb_rows(
        params, rows=(1, 3), scale=2.0, seed=7), meta={"adapter_id": "T"})})
    tenancy = ["T", "T", None, "T"]
    plain, _ = _drain(cfg, params, tenancy, reg, layout="paged")
    spec, srv = _drain(cfg, params, tenancy, reg, draft=4, layout="paged")
    assert spec == plain
    st = srv.stats()["spec"]
    assert st["rollbacks"] > 0 and st["acceptance_rate"] < 1.0
    assert srv.alloc.n_rollback > 0
    assert srv.stats()["kv"]["spec_rollback_pages"] > 0


def test_spec_adaptive_draft_len_backs_off(setup):
    _, _, cfg, params = setup
    reg = InMemoryRegistry({"T": extract_delta(params, perturb_rows(
        params, rows=(1, 3), scale=2.0, seed=7), meta={"adapter_id": "T"})})
    _, srv = _drain(cfg, params, ["T", "T", "T", None, None], reg, draft=4)
    assert srv._spec_len.get("T", 4) < 4
    assert srv._spec_len.get(None, 4) == 4     # base group: drafter == verifier


def test_rollback_to_unmaps_and_restores_reservation():
    al = PageAllocator(10, 4, slots=2, max_seq=32, share_prefix=False)
    al.admit(0, al.plan(None, [1, 2, 3], 16))
    al.ensure_range(0, 0, 10)
    assert al.pages_in_use == 3
    resv0 = int(al._resv[0])
    assert al.rollback_to(0, 5) == 1 and al.pages_in_use == 2
    assert int(al.table()[0, 2]) == al.NULL_PAGE
    assert int(al._resv[0]) == resv0 + 1
    assert al.n_rollback == 1
    al.ensure_range(0, 0, 10)
    assert al.pages_in_use == 3
    assert pages_for(8, 4) == 2
    assert al.rollback_to(0, 8) == 1
    assert al.rollback_to(0, 8) == 0


def test_spec_launcher_on_cpu_and_trace(tmp_path, capsys):
    from repro_torch.launch import serve as tserve
    trace = tmp_path / "spec.json"
    reqs = tserve.main(["--device", "cpu", "--quick", "--paged",
                        "--speculate", "2", "--demo-adapters", "2",
                        "--trace", str(trace)])
    out = capsys.readouterr().out
    assert all(r.done for r in reqs)
    assert "speculative: " in out and "paged KV: " in out
    names = {e.get("name") for e in
             json.loads(trace.read_text())["traceEvents"]}
    assert {"spec_draft", "spec_verify"} <= names
    r = subprocess.run([sys.executable, str(ROOT / "tools/check_trace.py"),
                        "--kind", "serve", "--require-spec", str(trace)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
