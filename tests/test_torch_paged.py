"""Port paged KV serving (``repro_torch.runtime.paged_kv``, the paged
model branches, the fused paged op and the paged ``DecodeServer``)
against the JAX package.

- Allocator: the port's ``PageAllocator`` is a copy of JAX's; one seeded
  random sequence of plan / admit / ensure_range / register /
  release_slot / rollback_to calls gives equal tables, refcounts,
  copy-on-write pairs, ``kv/*`` counters and trace instants in both.
  The JAX package's allocator cases run against the port's copy.
- Paged op: the port's plain version (the CPU route of
  ``ops.paged_decode_attention``) against JAX's
  ``paged_decode_attention_fwd(interpret=True)`` and the port's oracle:
  ``o`` within rtol 1e-4 / atol 2e-5 (f32 sums in another order), pools
  bitwise outside the null page 0 (the TPU kernel flushes inactive slots
  there; the port writes nothing for them).
- Model: paged ``prefill_into_slots`` + ``decode_step`` logits against
  JAX's paged ones (``kernel`` vs ``pallas_interpret``, ``full`` vs the
  XLA path) within rtol 1e-4 / atol 2e-5 with f32 pools; paged against
  dense within the port bitwise.
- Server: paged streams equal dense streams within the port and the
  JAX chunked paged server's streams (per-token JAX streams are no
  reference: ROADMAP C); churn, tight pools, refusals, stats and trace.
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

from repro.kernels import decode_attention as jda
from repro.models import model as jmodel
from repro.obs import MetricsRegistry as JMetrics
from repro.obs import Tracer as JTracer
from repro.runtime.paged_kv import PageAllocator as JAllocator
from repro.runtime.serve_config import KVConfig as JKV
from repro.runtime.serve_config import ServeConfig as JServeConfig
from repro.runtime.serve_loop import DecodeServer as JServer
from repro.runtime.serve_loop import Request as JRequest
from repro_torch import interop
from repro_torch.adapters import InMemoryRegistry, extract_delta
from repro_torch.adapters.testing import perturb_rows
from repro_torch.configs import base as tconfigs
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import model as tmodel
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.runtime.paged_kv import AdmitPlan, PageAllocator, pages_for
from repro_torch.runtime.serve_config import KVConfig, SchedConfig, ServeConfig
from repro_torch.runtime.serve_loop import DecodeServer, Request

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-4, atol=2e-5)


# --------------------------------------------------------------------- #
# allocator: the port's copy against JAX's, call for call
# --------------------------------------------------------------------- #


def _drive(al, seed, n_ops=160):
    """A seeded random sequence of valid allocator calls; returns the
    trace of every observable result."""
    rng = np.random.default_rng(seed)
    ps = al.page_size
    bases = [list(rng.integers(1, 50, 3 * ps)) for _ in range(2)]
    live = {}                                   # slot -> [pos, total]
    log = []
    for _ in range(n_ops):
        op = rng.integers(0, 4)
        free = [s for s in range(al.slots) if s not in live]
        if op == 0 and free:
            slot = free[0]
            ad = [None, "a"][int(rng.integers(0, 2))]
            base = bases[int(rng.integers(0, 2))]
            plen = int(rng.integers(2, 2 * ps + 3))
            prompt = base[:plen - 2] + list(rng.integers(1, 50, 2))
            total = min(plen + int(rng.integers(1, 2 * ps)), al.max_seq)
            plan = al.plan(ad, prompt, total)
            log.append(("plan", plan.matched_len, list(plan.full_pages),
                        plan.partial_page, plan.need_pages))
            if al.can_admit(plan.need_pages):
                al.admit(slot, plan)
                log.append(("cow", al.ensure_range(slot, plan.matched_len,
                                                   plen)))
                al.register(slot, ad, prompt)
                live[slot] = [plen, total]
        elif op == 1 and live:
            slot = sorted(live)[int(rng.integers(0, len(live)))]
            pos, total = live[slot]
            if pos < total:
                log.append(("cow", al.ensure_range(slot, pos, pos + 1)))
                live[slot][0] += 1
        elif op == 2 and live:
            slot = sorted(live)[int(rng.integers(0, len(live)))]
            pos, total = live[slot]
            n = min(3, total - pos - 1)
            if n >= 1:
                log.append(("cow", al.ensure_range(slot, pos, pos + n + 1)))
                keep = pos + int(rng.integers(1, n + 2))
                log.append(("rollback", al.rollback_to(slot, keep)))
                live[slot][0] = keep
        elif op == 3 and live:
            slot = sorted(live)[int(rng.integers(0, len(live)))]
            al.release_slot(slot)
            del live[slot]
        log.append(("state", al.table().tolist(), al._ref.tolist(),
                    list(al._free), al._resv.tolist()))
    log.append(("counters", al.n_alloc, al.n_free, al.n_cow,
                al.n_prefix_pages, al.n_prefix_tokens, al.n_evict,
                al.n_rollback))
    return log


@pytest.mark.parametrize("seed,pages,share", [(0, 24, True), (1, 12, True),
                                              (2, 24, False)])
def test_allocator_equals_jax_call_for_call(seed, pages, share):
    m, jm = MetricsRegistry(), JMetrics()
    tr, jtr = Tracer(), JTracer()
    kw = dict(slots=4, max_seq=32, share_prefix=share)
    al = PageAllocator(pages, 4, metrics=m, tracer=tr, **kw)
    jal = JAllocator(pages, 4, metrics=jm, tracer=jtr, **kw)
    got, want = _drive(al, seed), _drive(jal, seed)
    assert got == want
    assert m.nested()["kv"] == jm.nested()["kv"]
    assert [(e.name, e.args) for e in tr.events()] == \
        [(e.name, e.args) for e in jtr.events()]
    # the sequences reached rollbacks and, sharing, prefix hits and splits
    assert al.n_rollback and (not share or (al.n_cow and al.n_prefix_pages))


def test_pages_for_and_null_page_reserved():
    assert [pages_for(n, 8) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]
    al = PageAllocator(5, 8, slots=2, max_seq=32, share_prefix=False)
    assert al.usable_pages == 4 and al.pages_in_use == 0
    al.admit(0, al.plan(None, [1, 2, 3], 32))
    got = set()
    for l in range(4):
        al.ensure_range(0, l * 8, l * 8 + 1)
        got.add(int(al.table()[0, l]))
    assert 0 not in got and got == {1, 2, 3, 4}


def test_free_list_exhaustion_and_recycle():
    al = PageAllocator(5, 4, slots=4, max_seq=16, share_prefix=False)
    p0 = al.plan(None, [1, 2], 8)
    assert p0.need_pages == 2
    al.admit(0, p0)
    al.admit(1, al.plan(None, [3, 4], 8))
    assert not al.can_admit(al.plan(None, [5, 6], 8).need_pages)
    al.ensure_range(0, 0, 2)
    al.ensure_range(1, 0, 2)
    assert al.pages_in_use == 2
    al.release_slot(0)
    assert al.can_admit(al.plan(None, [5, 6], 8).need_pages)
    al.admit(2, al.plan(None, [5, 6], 8))
    al.ensure_range(2, 0, 8)
    assert al.pages_in_use == 3 and al.n_free == 1


def test_overcommitted_alloc_raises():
    al = PageAllocator(3, 4, slots=2, max_seq=16, share_prefix=False)
    al.admit(0, AdmitPlan(matched_len=0, need_pages=2))
    al.ensure_range(0, 0, 8)
    al.admit(1, AdmitPlan(matched_len=0, need_pages=2))
    with pytest.raises(RuntimeError, match="exhausted"):
        al.ensure_range(1, 0, 8)


def test_cow_refcount_split_on_write():
    al = PageAllocator(8, 4, slots=3, max_seq=16, share_prefix=True)
    prompt = list(range(10, 16))
    al.admit(0, al.plan("t", prompt, 10))
    al.ensure_range(0, 0, 6)
    al.register(0, "t", prompt)
    tbl0 = al.table()[0]
    plan = al.plan("t", prompt + [77, 78], 10)
    assert plan.matched_len == 6 and len(plan.full_pages) == 1
    assert plan.partial_page == int(tbl0[1])
    al.admit(1, plan)
    assert np.array_equal(al.table()[1][:2], tbl0[:2])
    copies = al.ensure_range(1, 6, 7)
    assert len(copies) == 1 and copies[0][0] == int(tbl0[1])
    assert al.table()[1][1] != tbl0[1]
    # the donor's registered partial page is pinned: it splits too
    copies0 = al.ensure_range(0, 6, 7)
    assert len(copies0) == 1 and copies0[0][0] == int(tbl0[1])


def test_prefix_share_dedup_accounting():
    m, tr = MetricsRegistry(), Tracer()
    al = PageAllocator(16, 4, slots=4, max_seq=16, share_prefix=True,
                       metrics=m, tracer=tr)
    prompt = list(range(9))
    al.admit(0, al.plan("t", prompt, 12))
    al.ensure_range(0, 0, 9)
    allocs_for_donor = al.n_alloc
    al.register(0, "t", prompt)
    for slot in (1, 2, 3):
        plan = al.plan("t", prompt, 12)
        assert plan.matched_len == 8 and len(plan.full_pages) == 2
        al.admit(slot, plan)
        al.ensure_range(slot, plan.matched_len, 9)
    assert al.n_prefix_pages == 6 and al.n_prefix_tokens == 24
    assert al.n_alloc == allocs_for_donor + 3
    assert m.counter("kv/prefix_hit_pages").value == 6
    assert int(m.gauge("kv/shared_pages").value) == 3
    names = [e.name for e in tr.events()]
    assert "prefix_share" in names and "page_alloc" in names


def test_registry_lru_eviction_frees_pages():
    al = PageAllocator(4, 4, slots=2, max_seq=8, share_prefix=True)
    al.admit(0, al.plan("t", [1, 2, 3, 4, 5], 8))
    al.ensure_range(0, 0, 5)
    al.register(0, "t", [1, 2, 3, 4, 5])
    al.release_slot(0)
    assert al.pages_in_use == 2 and al._evictable() == 2
    plan = al.plan("t", [9, 9, 9], 8)
    assert al.can_admit(plan.need_pages)
    al.admit(1, plan)
    al.ensure_range(1, 0, 8)
    assert al.n_evict == 1 and al.pages_in_use == 3


def test_release_slot_keeps_shared_pages_for_other_mapper():
    al = PageAllocator(8, 4, slots=2, max_seq=8, share_prefix=True)
    prompt = [7, 7, 7, 7, 2]
    al.admit(0, al.plan("t", prompt, 8))
    al.ensure_range(0, 0, 5)
    al.register(0, "t", prompt)
    al.admit(1, al.plan("t", prompt, 8))
    al.release_slot(0)
    phys = int(al.table()[1][0])
    assert phys != 0 and al._ref[phys] >= 2


# --------------------------------------------------------------------- #
# the fused paged op: plain version vs JAX's kernel and the oracles
# --------------------------------------------------------------------- #


def _paged_inputs(B=4, G=2, KV=2, hd=8, ps=4, NP=8, P=40, pos=(5, 9, 4, 30),
                  act=(True, True, True, False), share=True, shuffle=False,
                  seed=0):
    """A valid paged decode state: shared prefix pages (page j=0 of slots
    b and b+2) only where no active slot writes, optionally a shuffled
    physical numbering.  Numpy arrays."""
    rng = np.random.default_rng(seed)
    tbl = np.zeros((B, NP), np.int32)
    nxt = 3
    for b in range(B):
        for j in range(NP):
            if share and j == 0:
                tbl[b, j] = (b % 2) + 1
            else:
                tbl[b, j] = nxt
                nxt += 1
    if shuffle:
        perm = np.concatenate([[0], 1 + rng.permutation(P - 1)])
        tbl = perm[tbl].astype(np.int32)
    if share:
        assert all(p >= ps for p, a in zip(pos, act) if a)
    H = KV * G
    return dict(
        q=rng.standard_normal((B, 1, H, hd)).astype(np.float32),
        nk=rng.standard_normal((B, KV, hd)).astype(np.float32),
        nv=rng.standard_normal((B, KV, hd)).astype(np.float32),
        kp=rng.standard_normal((P, ps, KV, hd)).astype(np.float32),
        vp=rng.standard_normal((P, ps, KV, hd)).astype(np.float32),
        pos=np.asarray(pos, np.int32), tbl=tbl, act=np.asarray(act))


def _port_op(x, dtype, mode="plain", **kw):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    kp, vp = t["kp"].to(dtype), t["vp"].to(dtype)
    o, kp2, vp2 = ops.paged_decode_attention(
        t["q"], t["nk"], t["nv"], kp, vp, t["pos"], t["tbl"], t["act"],
        mode=mode, **kw)
    assert kp2 is kp and vp2 is vp                 # updated in place
    return o.numpy(), kp.float().numpy(), vp.float().numpy()


@pytest.mark.parametrize("case", [
    dict(),                                          # shared + inactive
    dict(act=(True,) * 4),
    dict(share=False, pos=(5, 9, 0, 30)),            # pos 0 write
    dict(window=6),
    dict(softcap=30.0),
    dict(dtype="float32"),
    dict(pos=(7, 8, 4, 31), act=(True,) * 4),        # first/last page row
    dict(act=(False,) * 4),
    dict(G=1, shuffle=True),
    dict(G=8, hd=16, shuffle=True, act=(True, False, True, True)),
])
def test_paged_op_matches_jax_kernel_and_oracle(case):
    case = dict(case)
    window = case.pop("window", 0)
    softcap = case.pop("softcap", 0.0)
    dname = case.pop("dtype", "bfloat16")
    x = _paged_inputs(**case)
    jdt, tdt = getattr(jnp, dname), getattr(torch, dname)
    jo, jk, jv = jda.paged_decode_attention_fwd(
        jnp.asarray(x["q"]), jnp.asarray(x["nk"]), jnp.asarray(x["nv"]),
        jnp.asarray(x["kp"], jdt), jnp.asarray(x["vp"], jdt),
        jnp.asarray(x["pos"]), jnp.asarray(x["tbl"]), jnp.asarray(x["act"]),
        window=window, softcap=softcap, interpret=True)
    o, kp, vp = _port_op(x, tdt, window=window, softcap=softcap)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    ro, rk, rv = tref.paged_decode_attention_ref(
        t["q"], t["nk"], t["nv"], t["kp"].to(tdt), t["vp"].to(tdt),
        t["pos"], t["tbl"], t["act"], window=window, softcap=softcap)
    a = x["act"]
    np.testing.assert_allclose(o[a], np.asarray(jo)[a], **F32_TOL)
    np.testing.assert_allclose(o[a], ro.numpy()[a], **F32_TOL)
    for got, want in ((kp, jk), (vp, jv), (kp, rk), (vp, rv)):
        want = np.asarray(jnp.asarray(want, jnp.float32)) \
            if not torch.is_tensor(want) else want.float().numpy()
        np.testing.assert_array_equal(got[1:], want[1:])


def test_paged_op_write_lands_and_inactive_rows_stay():
    x = _paged_inputs(share=False, pos=(5, 9, 0, 30))
    _, kp, _ = _port_op(x, torch.float32)
    ps = x["kp"].shape[1]
    for b in range(4):
        phys = x["tbl"][b, x["pos"][b] // ps]
        row = kp[phys, x["pos"][b] % ps]
        want = x["nk"][b] if x["act"][b] else x["kp"][phys, x["pos"][b] % ps]
        np.testing.assert_array_equal(row, want)
    # nothing else moved, the null page included
    changed = np.argwhere((kp != x["kp"]).any(axis=(1, 2, 3)))[:, 0]
    assert set(changed) <= {x["tbl"][b, x["pos"][b] // ps]
                            for b in range(3)}


def test_paged_plain_equals_dense_plain_on_gathered_view():
    """The plain paged op is the dense plain op on the gathered view, bit
    for bit, at any page size (the k-block is ``block_k`` rows)."""
    x = _paged_inputs(ps=4, NP=8, share=False, shuffle=True,
                      pos=(5, 31, 17, 30), act=(True,) * 4)
    o, kp, vp = _port_op(x, torch.float32, block_k=16)
    ridx = (x["tbl"][:, :, None] * 4 + np.arange(4)).reshape(4, 32)
    P, ps, KV, hd = x["kp"].shape
    ck = torch.from_numpy(kp.reshape(P * ps, KV, hd)[ridx])
    cv = torch.from_numpy(vp.reshape(P * ps, KV, hd)[ridx])
    od = da.decode_attention_plain(torch.from_numpy(x["q"]), ck, cv,
                                   torch.from_numpy(x["pos"]), block_k=16)
    assert np.array_equal(o, od.numpy())


def test_paged_plain_refuses_shared_write_page():
    """The CPU plain path checks the allocator's copy-on-write invariant:
    an active slot never writes a page another table entry maps."""
    x = _paged_inputs(share=True)
    x["pos"][0] = 2                  # slot 0 writes page 1, which slot 2 maps
    with pytest.raises(RuntimeError, match="copy-on-write"):
        _port_op(x, torch.float32)


def test_paged_kernel_mode_needs_cuda():
    x = _paged_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        _port_op(x, torch.float32, mode="kernel")
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    with pytest.raises(ValueError, match="CUDA"):
        da.paged_decode_attention_cuda(t["q"], t["nk"], t["nv"], t["kp"],
                                       t["vp"], t["pos"], t["tbl"], t["act"])


@pytest.mark.parametrize("window", [0, 20])
def test_paged_cache_read_bytes_equals_jax(window):
    pos = np.asarray([0, 15, 16, 200, 1023], np.int32)
    kw = dict(num_pages_per_slot=64, page_size=16, kv_heads=8, head_dim=128,
              window=window)
    assert da.paged_cache_read_bytes(torch.from_numpy(pos), **kw) == \
        jda.paged_cache_read_bytes(jnp.asarray(pos), **kw)


# --------------------------------------------------------------------- #
# model: paged prefill + decode vs JAX, and vs dense within the port
# --------------------------------------------------------------------- #

B, MAX_SEQ, PS, STEPS = 4, 32, 8, 6


def _cfgs(tiny_cfg):
    jcfg = tiny_cfg.replace(dtype="float32")
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = tconfigs.ModelConfig(**dataclasses.asdict(jcfg))
    params = interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jcfg, jparams, cfg, params


def _model_inputs():
    rng = np.random.RandomState(0)
    lengths = np.asarray([12, 7, 0, 9], np.int32)
    prompt = rng.randint(0, 128, (B, 12)).astype(np.int32)
    fed = rng.randint(0, 128, (STEPS, B)).astype(np.int32)
    # a shuffled page numbering, every slot's pages private
    perm = 1 + np.random.RandomState(1).permutation(B * MAX_SEQ // PS)
    table = perm.reshape(B, MAX_SEQ // PS).astype(np.int32)
    return prompt, lengths, fed, table


def _jax_paged(jcfg, jparams, impl, prompt, lengths, fed, table):
    P = B * MAX_SEQ // PS + 1
    cache = jmodel.init_paged_cache(jcfg, B, P, PS, MAX_SEQ,
                                    dtype=jnp.float32)
    tbl = jnp.asarray(table)
    out = []
    lg, cache = jmodel.prefill_into_slots(
        jparams, jcfg, cache, jnp.asarray(prompt), jnp.asarray(lengths),
        page_table=tbl, begin=jnp.zeros(B, jnp.int32))
    out.append(np.asarray(lg))
    pos = lengths.copy()
    act = jnp.asarray(lengths > 0)
    for t in fed:
        lg, cache = jmodel.decode_step(jparams, jcfg, cache,
                                       jnp.asarray(t[:, None]),
                                       jnp.asarray(pos), attn_impl=impl,
                                       page_table=tbl, active=act)
        out.append(np.asarray(lg))
        pos = pos + 1
    return out


def _port_run(cfg, params, impl, prompt, lengths, fed, table=None,
              cache=None):
    paged = table is not None
    if cache is None:
        cache = (tmodel.init_paged_cache(cfg, B, B * MAX_SEQ // PS + 1, PS,
                                         MAX_SEQ, dtype=torch.float32,
                                         device="cpu") if paged else
                 tmodel.init_cache(cfg, B, MAX_SEQ, dtype=torch.float32,
                                   device="cpu"))
    kw = dict(page_table=table, begin=np.zeros(B, np.int32)) if paged else {}
    out = []
    lg, _ = tmodel.prefill_into_slots(params, cfg, cache,
                                      torch.from_numpy(prompt), lengths, **kw)
    out.append(lg.numpy())
    pos = lengths.copy()
    act = torch.from_numpy(lengths > 0)
    for t in fed:
        lg, _ = tmodel.decode_step(
            params, cfg, cache, torch.from_numpy(t[:, None]),
            torch.from_numpy(pos), attn_impl=impl, active=act,
            page_table=None if table is None else torch.from_numpy(table))
        out.append(lg.numpy())
        pos = pos + 1
    return out, cache


@pytest.mark.parametrize("impl", ["full", "kernel"])
def test_paged_prefill_and_decode_match_jax(tiny_cfg, impl):
    """Port ``kernel`` vs JAX ``pallas_interpret``, ``full`` vs JAX's XLA
    path (never across: ROADMAP C)."""
    jcfg, jparams, cfg, params = _cfgs(tiny_cfg)
    prompt, lengths, fed, table = _model_inputs()
    jimpl = {"full": "full", "kernel": "pallas_interpret"}[impl]
    want = _jax_paged(jcfg, jparams, jimpl, prompt, lengths, fed, table)
    got, _ = _port_run(cfg, params, impl, prompt, lengths, fed, table)
    act = lengths > 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[act], w[act], err_msg=f"step {i}",
                                   **F32_TOL)


@pytest.mark.parametrize("impl", ["full", "kernel"])
def test_paged_model_bitwise_equals_dense(tiny_cfg, impl):
    """Within the port, paged logits and K/V rows equal dense ones bit for
    bit: the same values through the same arithmetic."""
    _, _, cfg, params = _cfgs(tiny_cfg)
    prompt, lengths, fed, table = _model_inputs()
    dense, dcache = _port_run(cfg, params, impl, prompt, lengths, fed)
    paged, pcache = _port_run(cfg, params, impl, prompt, lengths, fed, table)
    act = lengths > 0
    for d, p in zip(dense, paged):
        assert np.array_equal(d[act], p[act])
    ridx = (table[:, :, None] * PS + np.arange(PS)).reshape(B, MAX_SEQ)
    for dst, pst in zip(dcache["stages"], pcache["stages"]):
        for name in dst:
            for kd, kp in (("k", "pk"), ("v", "pv")):
                G, P, ps, KV, hd = pst[name][kp].shape
                view = pst[name][kp].reshape(G, P * ps, KV, hd)[:, ridx]
                for b in np.flatnonzero(act):
                    n = lengths[b] + STEPS
                    assert torch.equal(view[:, b, :n], dst[name][kd][:, b, :n])


def test_copy_cache_pages_in_place(tiny_cfg):
    _, _, cfg, _ = _cfgs(tiny_cfg)
    cache = tmodel.init_paged_cache(cfg, 2, 9, 4, 16, dtype=torch.float32,
                                    device="cpu")
    g = torch.Generator().manual_seed(0)
    leaves = [a for st in cache["stages"] for blk in st.values()
              for a in blk.values()]
    for a in leaves:
        a.copy_(torch.randn(a.shape, generator=g))
    before = [a.clone() for a in leaves]
    out = tmodel.copy_cache_pages(cache, [3, 5], [7, 2])
    assert out is cache
    for a, b in zip(leaves, before):
        assert torch.equal(a[:, 7], b[:, 3]) and torch.equal(a[:, 2], b[:, 5])
        keep = [i for i in range(9) if i not in (7, 2)]
        assert torch.equal(a[:, keep], b[:, keep])


def test_supports_gates_equal_jax(tiny_cfg):
    from repro.configs.base import BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN
    local = tiny_cfg.replace(pattern=(BLOCK_LOCAL_ATTN, BLOCK_GLOBAL_ATTN),
                             window_size=8)
    for jcfg in (tiny_cfg, local):
        cfg = tconfigs.ModelConfig(**dataclasses.asdict(jcfg))
        for fn in ("supports_paged_kv", "supports_prefix_share",
                   "supports_spec_decode"):
            assert getattr(tmodel, fn)(cfg) == getattr(jmodel, fn)(jcfg)


# --------------------------------------------------------------------- #
# the paged server
# --------------------------------------------------------------------- #

LENS = [5, 11, 3, 9, 7, 4]


def _serve(cfg, params, lens, *, registry=None, tenancy=None, slots=3,
           new_tokens=6, seed=7, tracer=None, **kw):
    kv = kw.pop("kv", {})
    sched = kw.pop("sched", {})
    srv = DecodeServer(cfg, params, ServeConfig(
        batch_slots=slots, max_seq=64, kv=KVConfig(**kv),
        sched=SchedConfig(**sched), **kw), registry=registry,
        tracer=tracer, device="cpu")
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(1, 127, n).astype(np.int32),
                    max_new_tokens=new_tokens,
                    adapter_id=None if tenancy is None else tenancy[i])
            for i, n in enumerate(lens)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    assert all(r.done for r in reqs)
    return [tuple(r.out) for r in reqs], srv


@pytest.mark.parametrize("leg,kw", [
    ("chunked", dict(prefill_chunk=8, kv=dict(prefix_share=False))),
    ("tokenwise_share", dict(prefill_chunk=0)),
    ("tight_pool", dict(prefill_chunk=8,
                        kv=dict(prefix_share=False, pages=2 * 8 + 1))),
])
@pytest.mark.parametrize("impl", ["full", "kernel"])
def test_paged_streams_equal_dense(tiny_cfg, leg, kw, impl):
    _, _, cfg, params = _cfgs(tiny_cfg)
    kw = dict(kw)
    kv = dict(kw.pop("kv", {}), layout="paged", page_size=8)
    dense, _ = _serve(cfg, params, LENS, attn_impl=impl, **kw)
    paged, srv = _serve(cfg, params, LENS, attn_impl=impl, kv=kv, **kw)
    assert paged == dense, leg
    assert srv.alloc.pages_in_use <= srv.alloc.usable_pages


def test_paged_prefix_share_chunked_equals_dense(tiny_cfg):
    """The fixed chunk grid keeps shared rows bit-equal across requests,
    so prefix-shared chunked streams equal dense ones."""
    _, _, cfg, params = _cfgs(tiny_cfg)
    common = np.random.default_rng(3).integers(1, 127, 8).astype(np.int32)

    def run(**kw):
        srv = DecodeServer(cfg, params, ServeConfig(
            batch_slots=3, max_seq=64, attn_impl="full", prefill_chunk=8,
            **kw), device="cpu")
        reqs = [Request(rid=i, prompt=np.concatenate(
            [common, np.full(8, 20 + i, np.int32)]), max_new_tokens=5)
            for i in range(5)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        return [tuple(r.out) for r in reqs], srv

    dense, _ = run()
    paged, srv = run(kv=KVConfig(layout="paged", page_size=8))
    assert paged == dense
    assert srv.alloc.n_prefix_pages >= 1 and srv.alloc.n_prefix_tokens >= 8


def _jax_paged_server(jcfg, jparams, lens, prefix_share, seed=7):
    srv = JServer(jcfg, jparams, JServeConfig(
        batch_slots=3, max_seq=64, attn_impl="full", prefill_chunk=8,
        kv=JKV(layout="paged", page_size=8, prefix_share=prefix_share)))
    rng = np.random.default_rng(seed)
    reqs = [JRequest(rid=i, prompt=rng.integers(1, 127, n).astype(np.int32),
                     max_new_tokens=6) for i, n in enumerate(lens)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return [tuple(r.out) for r in reqs], srv


@pytest.mark.parametrize("share", [False, True])
def test_paged_streams_equal_jax_chunked_paged_server(tiny_cfg, share):
    jcfg, jparams, cfg, params = _cfgs(tiny_cfg)
    want, jsrv = _jax_paged_server(jcfg, jparams, LENS, share)
    got, srv = _serve(cfg, params, LENS, attn_impl="full", prefill_chunk=8,
                      kv=dict(layout="paged", page_size=8,
                              prefix_share=share))
    assert got == want
    assert srv.steps == jsrv.steps
    assert srv.alloc.table().tolist() == jsrv.alloc.table().tolist()
    kv, jkv = srv.stats()["kv"], jsrv.stats()["kv"]
    assert kv == jkv                       # same keys and the same counts


def test_paged_streams_under_adapter_churn(tiny_cfg):
    """Round-robin and adapter-aware scheduling over two tenants: paged
    streams equal the dense streams of the same leg; every page returns."""
    _, _, cfg, params = _cfgs(tiny_cfg)
    reg = InMemoryRegistry()
    for i, aid in enumerate(("A", "B")):
        reg.put(aid, extract_delta(params, perturb_rows(
            params, rows=(i, i + 2), seed=10 + i), meta={"adapter_id": aid}))
    tenancy = ["A", "B", None, "B", "A", None, "B", "A"]
    lens = [3 + i % 3 for i in range(8)]
    for aware in (False, True):
        kw = dict(registry=reg, tenancy=tenancy, slots=2, prefill_chunk=4,
                  attn_impl="kernel",
                  sched=dict(steps_per_turn=2, adapter_aware=aware))
        dense, _ = _serve(cfg, params, lens, **kw)
        paged, srv = _serve(cfg, params, lens, kv=dict(
            layout="paged", page_size=8, prefix_share=False), **kw)
        assert paged == dense, f"aware={aware}"
        assert srv.alloc.pages_in_use == 0 and srv.swaps > 0


def test_tight_pool_throttles_but_never_wedges(tiny_cfg):
    """A pool for ~1.5 requests serializes admission; the reservations
    keep the wedge guard from tripping, and streams equal dense ones."""
    _, _, cfg, params = _cfgs(tiny_cfg)
    dense, _ = _serve(cfg, params, [10] * 4, prefill_chunk=8)
    srv_kw = dict(prefill_chunk=8, kv=dict(layout="paged", page_size=8,
                                           pages=4, prefix_share=False))
    paged, srv = _serve(cfg, params, [10] * 4, **srv_kw)
    assert paged == dense
    assert srv.alloc.pages_in_use == 0
    assert srv.alloc.n_alloc == srv.alloc.n_free


def test_submit_refuses_request_larger_than_pool(tiny_cfg):
    _, _, cfg, params = _cfgs(tiny_cfg)
    srv = DecodeServer(cfg, params, ServeConfig(
        batch_slots=2, max_seq=64, kv=KVConfig(layout="paged", page_size=8,
                                               pages=3)), device="cpu")
    with pytest.raises(ValueError, match="pool"):
        srv.submit(Request(rid=0, prompt=np.arange(30, dtype=np.int32),
                           max_new_tokens=10))


def test_kv_stats_keys_and_trace_instants(tiny_cfg, tmp_path):
    """``stats()["kv"]`` has JAX's keys; the trace carries the page
    lifecycle instants and ``tools/check_trace.py --require-paging``
    accepts it."""
    jcfg, jparams, cfg, params = _cfgs(tiny_cfg)
    common = np.random.default_rng(1).integers(1, 100, 10).astype(np.int32)
    prompts = [np.concatenate([common, np.full(2 + i, 110 + i, np.int32)])
               for i in range(3)]
    tr = Tracer()
    srv = DecodeServer(cfg, params, ServeConfig(
        batch_slots=2, max_seq=64, prefill_chunk=8,
        kv=KVConfig(layout="paged", page_size=8)), tracer=tr, device="cpu")
    jsrv = JServer(jcfg, jparams, JServeConfig(
        batch_slots=2, max_seq=64, prefill_chunk=8,
        kv=JKV(layout="paged", page_size=8)))
    for i, p in enumerate(prompts):
        srv.submit(Request(rid=i, prompt=p, max_new_tokens=4))
        jsrv.submit(JRequest(rid=i, prompt=p, max_new_tokens=4))
    srv.run_until_drained()
    jsrv.run_until_drained()
    kv = srv.stats()["kv"]
    assert set(kv) == set(jsrv.stats()["kv"])
    assert kv["cow_split"] > 0 and kv["prefix_hit_pages"] > 0
    from repro_torch.obs import write_trace
    path = write_trace(str(tmp_path / "paged.json"), tr, srv.metrics)
    names = {e.get("name") for e in
             json.loads(Path(path).read_text())["traceEvents"]}
    assert {"page_alloc", "page_free", "cow_split", "prefix_share"} <= names
    r = subprocess.run([sys.executable, str(ROOT / "tools/check_trace.py"),
                        "--kind", "serve", "--require-paging", str(path)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_paged_launcher_quick_on_cpu(capsys):
    from repro_torch.launch import serve as tserve
    reqs = tserve.main(["--device", "cpu", "--reduce", "8", "--paged",
                        "--demo-adapters", "2", "--slots", "2",
                        "--requests", "9", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert all(r.done for r in reqs)
    assert "paged KV: " in out and "prefix hits" in out
    line = next(l for l in out.splitlines() if l.startswith("paged KV:"))
    assert " 0 pages" not in line.split("prefix hits")[1]


def test_paged_with_local_blocks_equals_dense(tiny_cfg):
    """Local-attention blocks keep their dense ring under the paged layout
    (prefix sharing is then off): streams equal the dense server's and
    JAX's paged server's."""
    from repro.configs.base import BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN
    jcfg = tiny_cfg.replace(dtype="float32", window_size=8,
                            pattern=(BLOCK_LOCAL_ATTN, BLOCK_GLOBAL_ATTN))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = tconfigs.ModelConfig(**dataclasses.asdict(jcfg))
    params = interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    want, _ = _jax_paged_server(jcfg, jparams, LENS, prefix_share=True)
    dense, _ = _serve(cfg, params, LENS, attn_impl="full", prefill_chunk=8)
    paged, srv = _serve(cfg, params, LENS, attn_impl="full", prefill_chunk=8,
                        kv=dict(layout="paged", page_size=8))
    assert not srv.alloc.share_prefix
    assert paged == dense == want
