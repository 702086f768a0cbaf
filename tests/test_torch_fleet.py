"""The port's serving fleet (``repro_torch.runtime.fleet``) against the
JAX package's.

- The 13 tests of ``tests/test_fleet.py`` against the port: consistent
  hashing, the adapter directory, spill / steal / shed routing, the
  cross-replica capture, fleet streams equal to one ``DecodeServer``'s,
  the ``ServeConfig`` round trip, and the port's config-only API.
- Across the packages, on the same tiny f32 weights (JAX's
  ``init_params`` carried over by ``interop``), the same deltas and the
  same requests, with ``attn_impl="full"`` on both sides: ring placement
  and tenant homes equal, fault-free fleet streams bitwise equal, and
  the round-decided ``stats()["fleet"]`` fields and the cache counters
  equal.
- A whole-leaf tenant applied on two replicas at once leaves neither a
  tensor the other's swaps write in place: an in-place swap on one
  replica changes neither the other's weights nor its stream.
- The Router and ``python -m repro_torch.launch.fleet`` run on the card
  unless asked for the CPU, and the launcher's merged trace passes
  ``tools/check_trace.py --require-fleet --require-failover``.

Each test builds its own registries and Routers; the module fixture's
weights are only read.
"""
import dataclasses
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.adapters as jad
from repro.adapters.testing import perturb_rows as jperturb
from repro.models import model as jmodel
from repro.runtime import fleet as jfleet
from repro.runtime import serve_config as jsc
from repro.runtime import serve_loop as jsl
from repro_torch import adapters as tad
from repro_torch import interop
from repro_torch.adapters import delta as delta_lib
from repro_torch.adapters.testing import perturb_rows
from repro_torch.configs import base as tconfigs
from repro_torch.runtime.fleet import (ConsistentHashRing,
                                       FleetAdapterDirectory, Router)
from repro_torch.runtime.serve_config import (KVConfig, SchedConfig,
                                              ServeConfig, SpecConfig)
from repro_torch.runtime.serve_loop import DecodeServer, Request

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny(tiny_cfg):
    """(JAX config, JAX params, port config, port params), f32; read
    only."""
    jcfg = tiny_cfg.replace(dtype="float32")
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = tconfigs.ModelConfig(**dataclasses.asdict(jcfg))
    params = interop.tree_to_torch(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jcfg, jparams, cfg, params


# --------------------------------------------------------------------- #
# helpers (the port's side mirrors tests/test_fleet.py's)
# --------------------------------------------------------------------- #


def _registry(params, ids, seed=100):
    deltas = {}
    for i, aid in enumerate(ids):
        tuned = perturb_rows(params, rows=(i % 4, (i + 2) % 4),
                             scale=0.5 + 0.1 * i, seed=seed + i)
        deltas[aid] = tad.extract_delta(params, tuned,
                                        meta={"adapter_id": aid})
    return tad.InMemoryRegistry(deltas)


def _requests(cfg, tenancy, new_tokens=4, seed=0, cls=Request, **kw):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, 3 + i % 3),
                max_new_tokens=new_tokens, adapter_id=t, **kw)
            for i, t in enumerate(tenancy)]


def _fleet_cfg(**sched_kw):
    return ServeConfig(batch_slots=2, max_seq=64, attn_impl="full",
                       sched=SchedConfig(steps_per_turn=2, **sched_kw))


def _router(cfg, params, config, **kw):
    return Router(cfg, params, config, device="cpu", **kw)


# --------------------------------------------------------------------- #
# consistent hashing
# --------------------------------------------------------------------- #


def test_ring_add_moves_about_one_nth_of_keys():
    keys = [f"tenant:t{i}" for i in range(200)]
    ring = ConsistentHashRing([f"r{i}" for i in range(4)], vnodes=64)
    before = {k: ring.owner(k) for k in keys}
    ring.add("r4")
    after = {k: ring.owner(k) for k in keys}
    moved = [k for k in keys if before[k] != after[k]]
    assert all(after[k] == "r4" for k in moved)
    assert 0 < len(moved) < 0.45 * len(keys)
    ring.remove("r4")
    assert {k: ring.owner(k) for k in keys} == before


def test_ring_preference_is_owner_then_distinct_successors():
    nodes = ["a", "b", "c"]
    ring = ConsistentHashRing(nodes, vnodes=32)
    for key in ("tenant:base", "tenant:x", "tenant:y"):
        pref = ring.preference(key)
        assert pref[0] == ring.owner(key)
        assert sorted(pref) == sorted(nodes)


def test_ring_is_deterministic_across_instances():
    a = ConsistentHashRing(["r0", "r1", "r2"], vnodes=64)
    b = ConsistentHashRing(["r0", "r1", "r2"], vnodes=64)
    assert [a.owner(f"tenant:t{i}") for i in range(64)] == \
        [b.owner(f"tenant:t{i}") for i in range(64)]


@pytest.mark.parametrize("nodes,vnodes", [
    (["replica0", "replica1"], 64),
    (["replica0", "replica1", "replica2"], 64),
    ([f"r{i}" for i in range(5)], 16),
    (["a", "b", "c"], 1),
])
def test_ring_placement_equals_jax(nodes, vnodes):
    """Same md5 points: every key's owner and spill order equal JAX's,
    also across an add and a remove."""
    keys = ["tenant:base"] + [f"tenant:t{i}" for i in range(150)]
    ours = ConsistentHashRing(nodes, vnodes=vnodes)
    theirs = jfleet.ConsistentHashRing(nodes, vnodes=vnodes)
    for change in (None, ("add", "new"), ("remove", nodes[0])):
        if change is not None:
            getattr(ours, change[0])(change[1])
            getattr(theirs, change[0])(change[1])
        assert ours.nodes() == theirs.nodes()
        assert [ours.preference(k) for k in keys] == \
            [theirs.preference(k) for k in keys]


# --------------------------------------------------------------------- #
# adapter directory
# --------------------------------------------------------------------- #


def _delta(version=1, val=1.0):
    return tad.SparseDelta(
        {"w": tad.DeltaEntry(idx=np.arange(2, dtype=np.int32),
                             rows=np.full((2, 8), val, np.float32))},
        meta={"adapter_id": "a", "registry_version": version})


def test_directory_publish_lookup_unpublish():
    d = FleetAdapterDirectory()
    assert d.holders("a") == [] and d.lookup("a", 1) is None
    delta = _delta(version=1)
    d.publish("r0", "a", delta)
    assert d.holders("a") == ["r0"]
    assert d.lookup("a", 1) is delta
    assert d.lookup("a", 1, exclude="r0") is None
    assert d.lookup("a", 2) is None
    d.unpublish("r0", "a")
    assert d.holders("a") == [] and d.lookup("a", 1) is None
    d.unpublish("r0", "a")


# --------------------------------------------------------------------- #
# routing: spill, steal, shed
# --------------------------------------------------------------------- #


def test_hot_tenant_spills_then_returns_home(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["hot"])
    router = _router(cfg, params, _fleet_cfg(), replicas=2, registry=reg,
                     spill_depth=2)
    home = router.home("hot")
    reqs = _requests(cfg, ["hot"] * 6)
    placed = [router.submit(r) for r in reqs]
    assert placed[:2] == [home, home]
    assert set(placed) == set(router.replicas)
    router.run_until_drained()
    assert all(r.done for r in reqs)
    s = router.stats()["fleet"]
    assert s["spills"] >= 1 and s["routed_home"] >= 2
    late = _requests(cfg, ["hot"], seed=9)[0]
    late.rid = 99
    assert router.submit(late) == home


def test_idle_replica_steals_drain_tail(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["hot"])
    router = _router(cfg, params, _fleet_cfg(), replicas=2, registry=reg,
                     spill_depth=10 ** 6)
    home = router.home("hot")
    reqs = _requests(cfg, ["hot"] * 6)
    for r in reqs:
        assert router.submit(r) == home
    router.step()
    assert router.stats()["fleet"]["steals"] >= 1
    assert {router.routed_to(r.rid) for r in reqs} == set(router.replicas)
    router.run_until_drained()
    assert all(r.done for r in reqs)


def test_shed_on_slo_pressure_then_admit_when_idle(tiny):
    """Sheds are checked before any request finishes: the estimate is
    then the ``ms_per_step`` prior, not a wall-clock sample."""
    _, _, cfg, params = tiny
    config = ServeConfig(batch_slots=1, max_seq=64, attn_impl="full",
                         sched=SchedConfig(steps_per_turn=4,
                                           ms_per_step=1.0))
    router = _router(cfg, params, config, replicas=2)
    backlog = _requests(cfg, [None] * 10)
    for r in backlog:
        assert router.submit(r) is not None
    urgent = Request(rid=50, prompt=np.arange(3), max_new_tokens=2,
                     slo_ms=0.5)
    assert router.submit(urgent) is None
    assert router.stats()["fleet"]["sheds"] == 1
    assert router.routed_to(urgent.rid) is None
    router.run_until_drained()
    assert router.submit(urgent) is not None   # an idle fleet admits
    router.run_until_drained()
    assert urgent.done


# --------------------------------------------------------------------- #
# cross-replica adapter capture
# --------------------------------------------------------------------- #


def test_spilled_tenant_captures_peer_rows_not_disk(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["A"])
    router = _router(cfg, params, _fleet_cfg(cache_bytes=1 << 24),
                     replicas=2, registry=reg, spill_depth=2)
    home = router.home("A")
    other = next(n for n in router.replicas if n != home)
    router.submit(_requests(cfg, ["A"])[0])
    router.run_until_drained()
    assert router.replicas[home].server.cache.stats()["h2d_bytes"] > 0
    assert router.directory.holders("A") == [home]
    flood = _requests(cfg, ["A"] * 6, seed=3)
    for i, r in enumerate(flood):
        r.rid = 10 + i
        router.submit(r)
    assert any(router.routed_to(r.rid) == other for r in flood)
    router.run_until_drained()
    assert all(r.done for r in flood)
    peer = router.replicas[other].server.cache.stats()
    assert peer["peer_hits"] >= 1
    assert peer["xrep_bytes"] > 0
    assert peer["h2d_bytes"] == 0
    s = router.stats()["fleet"]
    assert s["peer_hits"] >= 1 and s["xrep_bytes"] > 0


# --------------------------------------------------------------------- #
# fleet-vs-single stream parity + stats schema
# --------------------------------------------------------------------- #


def test_fleet_streams_bit_identical_to_single_replica(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["A", "B", "C"])
    tenancy = ["A", "B", None, "C", "A", "B", "C", None, "A"]
    config = _fleet_cfg(cache_bytes=1 << 24)
    single_reqs = _requests(cfg, tenancy)
    srv = DecodeServer(cfg, params, config, registry=reg, device="cpu")
    for r in single_reqs:
        srv.submit(r)
    srv.run_until_drained()
    single = {r.rid: tuple(r.out) for r in single_reqs}
    for n in (2, 3):
        reqs = _requests(cfg, tenancy)
        router = _router(cfg, params, config, replicas=n, registry=reg,
                         spill_depth=2)
        for r in reqs:
            assert router.submit(r) is not None
        router.run_until_drained()
        assert {r.rid: tuple(r.out) for r in reqs} == single, \
            f"{n}-replica fleet diverged from single-replica serving"
    s = router.stats()
    assert s["stats_version"] == 2
    assert s["fleet"]["replicas"] == 3
    assert s["fleet"]["submitted"] == len(tenancy)
    assert s["fleet"]["tokens"] == sum(len(r.out) - 1 for r in single_reqs)
    assert set(s["replicas"]) == set(router.replicas)
    assert s["aggregate"]["decode/steps"] == \
        sum(p["decode"]["steps"] for p in s["replicas"].values())


# --------------------------------------------------------------------- #
# ServeConfig: round-trip, rejection, the config-only API
# --------------------------------------------------------------------- #


def test_serve_config_json_roundtrip_bit_exact():
    cfg = ServeConfig(
        batch_slots=3, max_seq=128, prefill_chunk=16,
        sched=SchedConfig(steps_per_turn=4, adapter_aware=True,
                          aging_steps=12, ms_per_step="auto",
                          cache_bytes=1 << 20),
        kv=KVConfig(layout="paged", page_size=8, pages=24),
        spec=SpecConfig(draft=2, adaptive=False))
    text = cfg.to_json()
    assert ServeConfig.from_json(text) == cfg
    assert ServeConfig.from_json(text).to_json() == text
    assert ServeConfig.from_json(ServeConfig().to_json()) == ServeConfig()


def test_serve_config_rejects_unknown_and_invalid():
    with pytest.raises(ValueError, match="unknown ServeConfig keys"):
        ServeConfig.from_dict({"batch_slots": 2, "bogus": 1})
    with pytest.raises(ValueError, match="unknown sched keys"):
        ServeConfig.from_dict({"sched": {"bogus": 1}})
    with pytest.raises(ValueError, match="version"):
        ServeConfig.from_dict({"version": 999})
    with pytest.raises(ValueError, match="layout"):
        KVConfig(layout="triangular")
    with pytest.raises(ValueError, match="ms_per_step"):
        SchedConfig(ms_per_step="sometimes")


def test_decode_server_takes_the_config_only(tiny):
    """The JAX server still maps legacy flat kwargs with a deprecation
    warning; the port never had them: a ``ServeConfig`` is the only
    way, and flat kwargs are a ``TypeError``."""
    _, _, cfg, params = tiny
    srv = DecodeServer(cfg, params, ServeConfig(batch_slots=2, max_seq=64),
                       device="cpu")
    assert srv.config.batch_slots == 2
    with pytest.raises(TypeError):
        DecodeServer(cfg, params, batch_slots=2, max_seq=64, device="cpu")


def test_port_has_no_legacy_trainer_classes():
    """The JAX package's removed trainer classes raise ``ImportError``
    pointing at ``trainers.handle``; the port never had them, and
    ``trainers.handle`` is its only trainer API."""
    import repro_torch.baselines.badam as badam
    import repro_torch.baselines.galore as galore
    import repro_torch.baselines.lora as lora
    import repro_torch.core.blockllm as core_blockllm
    import repro_torch.trainers as trainers
    removed = ((core_blockllm, "BlockLLMTrainer"),
               (core_blockllm, "FullAdamTrainer"),
               (galore, "GaLoreTrainer"), (lora, "LoRATrainer"),
               (badam, "BAdamTrainer"))
    for mod, name in removed:
        assert not hasattr(mod, name), f"{mod.__name__}.{name}"
    assert callable(trainers.handle)


# --------------------------------------------------------------------- #
# across the packages: homes, fault-free streams, round-decided stats
# --------------------------------------------------------------------- #

JAX = types.SimpleNamespace(Router=jfleet.Router, Server=jsl.DecodeServer,
                            Request=jsl.Request)
PORT = types.SimpleNamespace(
    Router=lambda *a, **kw: Router(*a, device="cpu", **kw),
    Server=lambda *a, **kw: DecodeServer(*a, device="cpu", **kw),
    Request=Request)

# fleet fields decided by rounds (wall-time ones, the health EMAs and
# the slow flags, are not compared)
ROUND_KEYS = ("submitted", "routed_home", "spills", "sheds", "steals",
              "rounds", "tokens", "fences", "failovers", "ring_resizes",
              "live_replicas", "replicas", "spill_depth", "tps_per_round",
              "swaps", "swap_bytes", "peer_hits", "xrep_bytes",
              "h2d_bytes", "fenced_replicas", "recover_rounds",
              "recoveries")


def _jax_delta(jparams, i, aid, leaf=None):
    tuned = jperturb(jparams, rows=(i % 4, (i + 2) % 4),
                     scale=0.5 + 0.1 * i, seed=100 + i, leaf=leaf)
    return jad.extract_delta(jparams, tuned, meta={"adapter_id": aid})


def _port_delta(jd):
    return tad.SparseDelta(
        {n: tad.DeltaEntry(idx=e.idx, rows=np.asarray(e.rows))
         for n, e in jd.entries.items()}, dict(jd.meta))


def _paired_registries(jparams, ids, whole=()):
    jd = {a: _jax_delta(jparams, i, a, "final_norm" if a in whole else None)
          for i, a in enumerate(ids)}
    return (jad.InMemoryRegistry(dict(jd)),
            tad.InMemoryRegistry({a: _port_delta(d) for a, d in jd.items()}))


def _fleet_view(router):
    s = router.stats()
    f = {k: s["fleet"][k] for k in ROUND_KEYS}
    per = {n: (p["decode"]["steps"], p["decode"]["tokens"],
               p["prefill"]["dispatches"], p["sched"]["swaps"],
               p["sched"]["swap_bytes"], p["sched"]["finished"],
               p.get("cache"))
           for n, p in s["replicas"].items()}
    return f, per


def _serve_both(tiny, tenancy, replicas, cache_bytes, whole=()):
    jcfg, jparams, cfg, params = tiny
    jreg, reg = _paired_registries(jparams, sorted(
        {t for t in tenancy if t is not None}), whole)
    out = {}
    for name, side, mcfg, p, r, config in (
            ("jax", JAX, jcfg, jparams, jreg, jsc.ServeConfig(
                batch_slots=2, max_seq=64, sched=jsc.SchedConfig(
                    steps_per_turn=2, cache_bytes=cache_bytes))),
            ("port", PORT, cfg, params, reg,
             _fleet_cfg(cache_bytes=cache_bytes))):
        reqs = _requests(mcfg, tenancy, cls=side.Request)
        if replicas == 0:
            srv = side.Server(mcfg, p, config, registry=r)
            for q in reqs:
                srv.submit(q)
            srv.run_until_drained()
            out[name] = ({q.rid: tuple(q.out) for q in reqs},
                         srv.stats().get("cache"), None)
            continue
        router = side.Router(mcfg, p, config, replicas=replicas,
                             registry=r, spill_depth=2)
        homes = [router.home(t) for t in (None, "A", "B", "C", "W")]
        for q in reqs:
            assert router.submit(q) is not None
        router.run_until_drained()
        assert all(q.done for q in reqs)
        out[name] = ({q.rid: tuple(q.out) for q in reqs},
                     _fleet_view(router), homes)
    return out


TENANCY = ["A", "B", None, "C", "A", "B", "C", None, "A", "W", "W", "A"]


@pytest.mark.parametrize("replicas,cache_bytes", [
    (0, 1 << 24), (1, 1 << 24), (2, 1 << 24), (3, 1 << 24), (2, 0),
])
def test_fleet_streams_and_stats_equal_jax(tiny, replicas, cache_bytes):
    """One server (``replicas=0``) and fleets of 1-3 replicas, cached and
    uncached, with a whole-leaf tenant ``W``: the port's streams, homes,
    round-decided fleet stats and per-replica counters equal JAX's."""
    got = _serve_both(tiny, TENANCY, replicas, cache_bytes, whole=("W",))
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]


# --------------------------------------------------------------------- #
# no tensor one replica writes in place is reachable from another
# --------------------------------------------------------------------- #


def _storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


def _live(srv):
    return _storages(interop._flatten_with_names(srv.params)[1])


def _cached(srv):
    return _storages(e.rows for aid in srv.cache.cached_ids()
                     for e in srv.cache._slots[aid].entries.values())


def test_whole_leaf_tenant_on_two_replicas_shares_no_written_tensor(tiny):
    """A whole-leaf tenant applied on two replicas at once (the second
    takes the first's cached rows as a peer hit): no live leaf of one
    replica (what its swaps write in place) lies in the other's live
    tree or cache.  Then an in-place swap on replica0's live
    ``final_norm`` (``flip_delta``, as a speculative draft does) and its
    revert leave replica1's weights and stream unchanged."""
    _, _, cfg, params = tiny
    tuned = perturb_rows(params, rows=(0, 2), seed=11, leaf="final_norm")
    d = tad.extract_delta(params, tuned, meta={"adapter_id": "W"})
    assert d.entries["final_norm/scale"].idx is None     # a whole-leaf entry
    config = _fleet_cfg(cache_bytes=1 << 24)
    reqs = _requests(cfg, ["W"] * 3, new_tokens=6, seed=4)
    ref = DecodeServer(cfg, params, config,
                       registry=tad.InMemoryRegistry({"W": d}),
                       device="cpu")
    for r in reqs:
        ref.submit(r)
    ref.run_until_drained()
    want = [tuple(r.out) for r in reqs]

    router = _router(cfg, params, config, replicas=2,
                     registry=tad.InMemoryRegistry({"W": d}))
    s0 = router.replicas["replica0"].server
    s1 = router.replicas["replica1"].server
    s0._ensure_adapter("W")
    s1._ensure_adapter("W")
    assert s1.cache.stats()["peer_hits"] == 1
    for a, b in ((s0, s1), (s1, s0)):
        assert not _live(a) & (_live(b) | _cached(b))
    weights1 = {k: v.copy() for k, v in
                interop.named_numpy(s1.params).items()}

    # an in-place swap on replica0 while W is applied there
    bump = tad.SparseDelta({"final_norm/scale": tad.DeltaEntry(
        idx=np.asarray([0, 1], np.int32),
        rows=np.asarray([7.0, -7.0], np.float32))})
    s0.params, back = delta_lib.flip_delta(s0.params, bump)
    again = [tuple(r.out) for r in _serve_on(s1, cfg, seed=4)]
    s0.params, _ = delta_lib.flip_delta(s0.params, back)
    s0.restore_base()
    for name, arr in interop.named_numpy(s1.params).items():
        assert arr.tobytes() == weights1[name].tobytes(), name
    assert again == want
    got0 = interop.named_numpy(s0.params)
    for name, arr in interop.named_numpy(params).items():
        assert got0[name].tobytes() == arr.tobytes(), name
    cached = s0.cache._slots["W"].entries["final_norm/scale"].rows
    assert cached.numpy().tobytes() == \
        d.entries["final_norm/scale"].rows.numpy().tobytes()


def _serve_on(srv, cfg, seed):
    reqs = _requests(cfg, ["W"] * 3, new_tokens=6, seed=seed)
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return reqs


# --------------------------------------------------------------------- #
# device, launcher, merged trace
# --------------------------------------------------------------------- #


def test_router_runs_on_the_card_unless_asked(tiny, monkeypatch):
    _, _, cfg, params = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Router(cfg, params, _fleet_cfg(), replicas=2)
    from repro_torch.launch import fleet as lfleet
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lfleet.run(["--quick", "--replicas", "2", "--demo-adapters", "1"])
    router = Router(cfg, params, _fleet_cfg(), replicas=2, device="cpu")
    assert all(r.server.device.type == "cpu"
               for r in router.replicas.values())


def test_fleet_launcher_chaos_leg_on_cpu(tmp_path, capsys):
    """The launcher's kill-and-replace leg on the CPU: parity asserted,
    and the merged trace passes the fleet and failover checks."""
    from repro_torch.launch import fleet as lfleet
    trace = tmp_path / "chaos.json"
    router, reqs = lfleet.run([
        "--device", "cpu", "--quick", "--replicas", "2",
        "--demo-adapters", "3", "--cache-bytes", "4194304",
        "--fault-plan", "kill:replica1@round6", "--replace-after-fence",
        "--assert-parity", "--trace", str(trace)])
    out = capsys.readouterr().out
    assert "fenced: replica1 (killed)" in out
    assert "parity: 10 stream(s) bit-identical" in out
    assert all(r.done for r in reqs)
    assert router.stats()["fleet"]["fences"] == 1
    r = subprocess.run([sys.executable, str(ROOT / "tools/check_trace.py"),
                        "--kind", "serve", "--require-fleet",
                        "--require-failover", str(trace)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
