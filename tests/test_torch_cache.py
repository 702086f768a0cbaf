"""The port's AdapterCache (``repro_torch.adapters.AdapterCache``) and
cached serving against the JAX package.

- The same schedule of ``get`` / ``put_back`` / re-``put`` / ``drop``
  drives a JAX ``AdapterCache`` and the port's (on the CPU), over the
  same seeded numpy deltas: after every operation the two ``stats()``
  dicts, the cached ids in LRU order and the returned rows are equal.
  The schedules mirror ``tests/test_serve_sched.py``: byte-budget LRU
  eviction, the bypass of a delta larger than the budget, q8 payloads
  dequantized once at promotion (``h2d_bytes`` counts the quantized
  bytes), the stale drop after a re-``put``, the refused capture of
  stale rows, and the zero-upload capture of a revert's displaced rows.
- ``DecodeServer`` with ``cache_bytes > 0`` (a budget that holds one
  of two tenants, so it evicts) emits the streams of uncached serving
  and of JAX's cached server, with f32 and with q8 tenants, and its
  weights revert to the base bit-exactly; its ``stats()["cache"]``
  equals JAX's.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import repro.adapters as jad
from repro.adapters.testing import perturb_rows as jperturb
from repro.models import model as jmodel
from repro.runtime.serve_config import SchedConfig as JSched
from repro.runtime.serve_config import ServeConfig as JServeConfig
from repro.runtime.serve_loop import DecodeServer as JServer
from repro.runtime.serve_loop import Request as JRequest
from repro_torch import adapters as tad
from repro_torch import interop
from repro_torch.configs import base as tconfigs
from repro_torch.runtime.serve_config import SchedConfig, ServeConfig
from repro_torch.runtime.serve_loop import DecodeServer, Request

torch.set_num_threads(2)

JAX = types.SimpleNamespace(pkg=jad, cache=jad.AdapterCache)
PORT = types.SimpleNamespace(
    pkg=tad, cache=lambda reg, **kw: tad.AdapterCache(reg, device="cpu",
                                                      **kw))


def _row_delta(side, i, rows=2, cols=64):
    return side.pkg.SparseDelta(
        {"w": side.pkg.DeltaEntry(idx=np.arange(rows, dtype=np.int32),
                                  rows=np.full((rows, cols), float(i),
                                               np.float32))},
        meta={"adapter_id": f"a{i}"})


def _q8_delta(side):
    rng = np.random.default_rng(0)
    fp = side.pkg.SparseDelta(
        {"w": side.pkg.DeltaEntry(idx=np.asarray([1, 4], np.int32),
                                  rows=rng.normal(size=(2, 300))
                                  .astype(np.float32))},
        meta={"adapter_id": "q"})
    return side.pkg.quantize_delta(fp)


def _rows(d):
    return {n: np.asarray(e.rows).tobytes() for n, e in d.entries.items()}


def _capture_pair(side):
    """A real apply -> revert on a small tree: the revert's displaced
    rows (what the serving loop hands ``put_back``)."""
    rng = np.random.default_rng(3)
    base = {"w": rng.normal(size=(8, 64)).astype(np.float32),
            "n": rng.normal(size=64).astype(np.float32)}
    tuned = {"w": base["w"].copy(), "n": base["n"] + 1.0}
    tuned["w"][[0, 2]] += 0.5
    if side is PORT:
        base = interop.tree_to_torch(base, device="cpu")
        tuned = interop.tree_to_torch(tuned, device="cpu")
    d = side.pkg.extract_delta(base, tuned, meta={"adapter_id": "A"})
    applied, disp = side.pkg.apply_delta(base, d)
    _, back = side.pkg.apply_delta(applied, disp, check_fingerprint=False)
    return d, back


def _schedule(side, name):
    """Run one schedule; yields a record after every operation."""
    if name == "lru":
        deltas = {f"a{i}": _row_delta(side, i) for i in range(3)}
        nb = deltas["a0"].nbytes
        reg = side.pkg.InMemoryRegistry(deltas)
        cache = side.cache(reg, cache_bytes=2 * nb + 8)
        ops = [("get", a) for a in ("a0", "a1", "a2", "a1", "a0", "a2")]
    elif name == "bypass":
        reg = side.pkg.InMemoryRegistry(
            {"big": _row_delta(side, 0, rows=16, cols=256)})
        cache = side.cache(reg, cache_bytes=64)
        ops = [("get", "big"), ("get", "big")]
    elif name == "q8":
        reg = side.pkg.InMemoryRegistry({"q": _q8_delta(side),
                                         "a1": _row_delta(side, 1)})
        cache = side.cache(reg, cache_bytes=1 << 20)
        ops = [("get", "q"), ("get", "q"), ("get", "a1"), ("drop", "q"),
               ("get", "q")]
    elif name == "republish":
        reg = side.pkg.InMemoryRegistry({"a": _row_delta(side, 1)})
        cache = side.cache(reg, cache_bytes=1 << 20)
        ops = [("get", "a"), ("put", "a", 7), ("get", "a"),
               ("drop", "a"), ("put_back_stale", "a"), ("get", "a")]
    else:   # capture
        d, back = _capture_pair(side)
        reg = side.pkg.InMemoryRegistry({"A": d, "b": _row_delta(side, 2)})
        cache = side.cache(reg, cache_bytes=1 << 24)
        ops = [("put_back", "A", back), ("get", "A"), ("get", "b"),
               ("put_back", "b", back), ("drop", "A"), ("get", "A")]
    for op in ops:
        kind, aid = op[0], op[1]
        got = None
        if kind == "get":
            got = _rows(cache.get(aid))
        elif kind == "put":
            reg.put(aid, _row_delta(side, op[2]))
        elif kind == "drop":
            cache.drop(aid)
        elif kind == "put_back":
            cache.put_back(aid, op[2])
        else:   # a capture of rows older than the registry's version
            stale = cache._promote(_row_delta(side, 1))
            stale.meta["registry_version"] = 0
            cache.put_back(aid, stale)
        yield op[:2], cache.stats(), cache.cached_ids(), got


@pytest.mark.parametrize("name", ["lru", "bypass", "q8", "republish",
                                  "capture"])
def test_cache_stats_equal_jax_over_one_schedule(name):
    want = list(_schedule(JAX, name))
    got = list(_schedule(PORT, name))
    assert len(got) == len(want)
    for (op, js, jids, jrows), (_, ts, tids, trows) in zip(want, got):
        assert ts == js, op
        assert tids == jids, op
        assert trows == jrows, op
    last = got[-1][1]
    expect = {"lru": ("evictions", 3), "bypass": ("bypasses", 2),
              "q8": ("hits", 1), "republish": ("stale_drops", 1),
              "capture": ("captures", 1)}[name]
    assert last[expect[0]] == expect[1], last


def test_q8_promotion_dequantizes_once_on_the_device_side():
    q8 = _q8_delta(PORT)
    cache = PORT.cache(tad.InMemoryRegistry({"q": q8}), cache_bytes=1 << 20)
    dev = cache.get("q")
    assert not dev.quantized
    assert torch.equal(dev.entries["w"].rows,
                       q8.entries["w"].materialize_rows())
    assert dev.entries["w"].idx.dtype == torch.int32
    assert cache.stats()["h2d_bytes"] == q8.nbytes
    assert cache.get("q").entries["w"].rows is dev.entries["w"].rows
    with pytest.raises(ValueError, match="cache_bytes"):
        tad.AdapterCache(tad.InMemoryRegistry(), cache_bytes=0,
                         device="cpu")


# --------------------------------------------------------------------- #
# cached serving
# --------------------------------------------------------------------- #

TENANCY = ["A", "B", None, "B", "A", "B", "A"]


@pytest.fixture(scope="module")
def setup(tiny_cfg):
    jcfg = tiny_cfg.replace(dtype="float32")
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = tconfigs.ModelConfig(**dataclasses.asdict(jcfg))
    params = interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    jd = {a: jad.extract_delta(jparams, jperturb(
        jparams, rows=rows, seed=seed, leaf=leaf), meta={"adapter_id": a})
        for a, rows, seed, leaf in (("A", (0, 2), 10, None),
                                    ("B", (1, 3), 20, "final_norm"))}
    return jcfg, jparams, cfg, params, jd


def _port_delta(jd):
    return tad.SparseDelta(
        {n: tad.DeltaEntry(idx=e.idx, rows=np.asarray(e.rows),
                           scale=(None if e.scale is None
                                  else np.asarray(e.scale)),
                           row_shape=e.row_shape, row_dtype=e.row_dtype)
         for n, e in jd.entries.items()}, dict(jd.meta))


def _serve(server_cls, request_cls, cfg, params, reg, vocab, **sched):
    kw = dict(batch_slots=2, max_seq=64, attn_impl="full", prefill_chunk=4)
    rng = np.random.default_rng(5)
    reqs = [request_cls(rid=i, prompt=rng.integers(0, vocab, 3 + i % 3),
                        max_new_tokens=5, adapter_id=t)
            for i, t in enumerate(TENANCY)]
    if server_cls is JServer:
        srv = JServer(cfg, params, JServeConfig(
            sched=JSched(steps_per_turn=2, **sched), **kw), registry=reg)
    else:
        srv = DecodeServer(cfg, params, ServeConfig(
            sched=SchedConfig(steps_per_turn=2, **sched), **kw),
            registry=reg, device="cpu")
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    assert all(r.done for r in reqs)
    return srv, [r.out for r in reqs]


@pytest.mark.parametrize("q8", [False, True])
def test_cached_serving_equals_uncached_and_jax(setup, q8):
    jcfg, jparams, cfg, params, jd = setup
    if q8:
        jd = {a: jad.quantize_delta(d) for a, d in jd.items()}
        assert all(d.quantized for d in jd.values())
    # a budget of one tenant's device rows: the two tenants evict each
    # other
    dev = {a: PORT.cache(tad.InMemoryRegistry({a: _port_delta(d)}),
                         cache_bytes=1 << 30).get(a).nbytes
           for a, d in jd.items()}
    budget = max(dev.values()) + 64
    assert budget < sum(dev.values())
    outs = {}
    for leg, cache_bytes in (("uncached", 0), ("cached", budget)):
        reg = tad.InMemoryRegistry({a: _port_delta(d)
                                    for a, d in jd.items()})
        srv, outs[leg] = _serve(DecodeServer, Request, cfg, params, reg,
                                cfg.vocab_size, cache_bytes=cache_bytes)
        if leg == "cached":
            st = srv.stats()["cache"]
            assert st["misses"] >= 2 and st["evictions"] >= 1
            srv.restore_base()
            got = interop.named_numpy(srv.params)
            for name, arr in interop.named_numpy(params).items():
                assert got[name].tobytes() == arr.tobytes(), name
            port_cache = st
    jsrv, jouts = _serve(JServer, JRequest, jcfg, jparams,
                         jad.InMemoryRegistry(dict(jd)), jcfg.vocab_size,
                         cache_bytes=budget)
    assert outs["cached"] == outs["uncached"] == jouts
    assert port_cache == jsrv.stats()["cache"]
    if q8:
        # h2d counts the quantized payloads of the promotions
        sizes = [_port_delta(d).nbytes for d in jd.values()]
        n = port_cache["misses"]
        assert any(k * sizes[0] + (n - k) * sizes[1]
                   == port_cache["h2d_bytes"] for k in range(n + 1))
        assert port_cache["h2d_bytes"] < n * min(dev.values())
