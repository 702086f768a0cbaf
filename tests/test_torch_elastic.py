"""The port's ElasticFleet (``repro_torch.runtime.elastic`` and the
Router's fencing, failover and membership changes) against the JAX
package's.

- The 25 tests of ``tests/test_elastic.py`` against the port: the
  ``FaultPlan`` parser and schedule, ``ReplicaHealth``,
  ``Request.replay_clone``, every chaos leg (kill, kill and replace,
  wedge, slow, transient adapter read errors) with streams bitwise a
  fault-free single server's, ``add_replica`` / ``remove_replica``, the
  drain diagnostics and the ``FleetConfig`` wiring.
- Across the packages, on the same tiny f32 weights, deltas, requests
  and ``FaultPlan`` (``attn_impl="full"`` on both sides): every leg's
  streams bitwise JAX's, and its round-decided ``stats()["fleet"]``
  fields and per-replica counters (fenced replicas included) equal.
  Prefill dispatch counts are not compared: a replay primes its
  streamed tokens through the decode step, one dispatch a token, where
  JAX's primes them in chunks.
- A replay's K/V rows are bitwise the uninterrupted stream's.
- A fenced replica frees its weights, KV cache and cached rows, and
  keeps its stats; the legs' outcome does not depend on the wall clock.

Each test builds its own registries and Routers; reads are made to fail
only with ``retry_backoff_ms=0``.
"""
import dataclasses
import gc
import types
import weakref

import jax
import numpy as np
import pytest
import torch

import repro.adapters as jad
from repro.adapters.testing import perturb_rows as jperturb
from repro.models import model as jmodel
from repro.runtime import elastic as jel
from repro.runtime import fleet as jfleet
from repro.runtime import serve_config as jsc
from repro.runtime import serve_loop as jsl
from repro_torch import adapters as tad
from repro_torch import interop
from repro_torch.adapters.testing import perturb_rows
from repro_torch.configs import base as tconfigs
from repro_torch.runtime import fleet as tfleet
from repro_torch.runtime.elastic import (FaultPlan, ReplicaHealth,
                                         ReplicaKilled)
from repro_torch.runtime.fleet import Router
from repro_torch.runtime.serve_config import (FleetConfig, SchedConfig,
                                              ServeConfig)
from repro_torch.runtime.serve_loop import DecodeServer, Request

torch.set_num_threads(2)


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
# helpers (the port's side mirrors tests/test_elastic.py's)
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


def _fleet_cfg(fleet=None, **sched_kw):
    return ServeConfig(batch_slots=2, max_seq=64, attn_impl="full",
                       sched=SchedConfig(steps_per_turn=2, **sched_kw),
                       fleet=fleet if fleet is not None else FleetConfig())


def _router(cfg, params, config, **kw):
    return Router(cfg, params, config, device="cpu", **kw)


def _reference_streams(cfg, params, registry, tenancy, config,
                       new_tokens=4):
    """Fault-free single-replica run: the parity oracle."""
    reqs = _requests(cfg, tenancy, new_tokens=new_tokens)
    srv = DecodeServer(cfg, params, config, registry=registry, device="cpu")
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return {r.rid: tuple(r.out) for r in reqs}


def _busiest(router):
    return max(router.replicas, key=lambda n: router.replicas[n].depth())


TENANCY = ["A", "B", None, "C", "A", "B", "C", None, "A", "B", "C", "A"]


# --------------------------------------------------------------------- #
# FaultPlan parsing + schedule
# --------------------------------------------------------------------- #


def test_fault_plan_parse_specs():
    plan = FaultPlan.parse("kill:replica1@round12; wedge:replica0@round5;"
                           "slow:replica2@round3:3x;adapter_read_error:n=2")
    assert [s.kind for s in plan.specs] == \
        ["kill", "wedge", "slow", "adapter_read_error"]
    assert plan.specs[0].target == "replica1" and plan.specs[0].round == 12
    assert plan.specs[2].factor == 3.0
    assert plan.specs[3].count == 2
    assert bool(plan)
    assert not FaultPlan.parse(None) and not FaultPlan.parse("  ")


@pytest.mark.parametrize("bad", [
    "explode:replica0@round1",
    "kill:replica0",
    "slow:replica0@round1",
    "slow:replica0@round1:1x",
    "kill:replica0@round1:2x",
    "adapter_read_error:k=3",
])
def test_fault_plan_rejects_malformed(bad):
    with pytest.raises(ValueError):
        FaultPlan.parse(bad)


def test_fault_plan_kill_fires_once_at_round():
    plan = FaultPlan.parse("kill:replica1@round3")
    assert plan.action("replica1", 2) == "run"
    assert plan.action("replica0", 3) == "run"
    assert plan.action("replica1", 3) == "kill"
    assert plan.action("replica1", 4) == "run"
    assert plan.injected["kill"] == 1


def test_fault_plan_wedge_persists_and_slow_stalls():
    plan = FaultPlan.parse("wedge:replica0@round2;slow:replica1@round0:3x")
    assert all(plan.action("replica0", r) == "wedge" for r in (2, 3, 9))
    acts = [plan.action("replica1", r) for r in range(6)]
    assert acts == ["run", "stall", "stall", "run", "stall", "stall"]
    assert plan.step_ms("replica1", 4, 0.0) == 3.0
    assert plan.step_ms("replica0", 4, 0.0) == 1.0


def test_fault_plan_read_hook_counts_down():
    from repro_torch.adapters.registry import AdapterReadError
    plan = FaultPlan.parse("adapter_read_error:n=2")
    for _ in range(2):
        with pytest.raises(AdapterReadError):
            plan.read_hook("A")
    plan.read_hook("A")
    assert plan.injected["read_error"] == 2


@pytest.mark.parametrize("text", [
    "kill:any@round2;wedge:replica1@round4", "slow:replica0@round1:2.5x",
    "adapter_read_error:p=0.3;kill:replica2@round0"])
def test_fault_plan_schedule_equals_jax(text):
    """The same spec text and seed give JAX's specs, actions, step
    times and read failures, call for call."""
    ours, theirs = FaultPlan.parse(text, seed=7), jel.FaultPlan.parse(
        text, seed=7)
    assert [dataclasses.asdict(s) for s in ours.specs] == \
        [dataclasses.asdict(s) for s in theirs.specs]
    for rnd in range(8):
        for name in ("replica0", "replica1", "replica2"):
            assert ours.action(name, rnd) == theirs.action(name, rnd)
            assert ours.step_ms(name, rnd, 5.0) == \
                theirs.step_ms(name, rnd, 5.0)
    fails = []
    for plan in (ours, theirs):
        row = []
        for _ in range(20):
            try:
                plan.read_hook("A")
                row.append(0)
            except RuntimeError:
                row.append(1)
        fails.append(row)
    assert fails[0] == fails[1]
    assert ours.injected == theirs.injected


# --------------------------------------------------------------------- #
# ReplicaHealth
# --------------------------------------------------------------------- #


def test_health_single_replica_never_slow():
    h = ReplicaHealth(FleetConfig(warmup_rounds=1))
    for _ in range(6):
        h.observe("r0", step_ms=100.0, progressed=True)
    assert h.assess() == {"r0": "ok"}


def test_health_flags_slow_after_warmup_only():
    cfg = FleetConfig(warmup_rounds=3, slow_threshold=2.0, ema_alpha=1.0)
    h = ReplicaHealth(cfg)
    for rnd in range(4):
        for name, ms in (("r0", 1.0), ("r1", 1.0), ("r2", 10.0)):
            h.observe(name, step_ms=ms, progressed=True)
        states = h.assess()
        if rnd + 1 < cfg.warmup_rounds:
            assert states["r2"] == "ok"
        else:
            assert states["r2"] == "slow"
            assert states["r0"] == states["r1"] == "ok"
    assert h.snapshot()["r2"]["slow_flags"] >= 1


def test_health_wedge_needs_consecutive_no_progress():
    cfg = FleetConfig(wedge_rounds=3)
    h = ReplicaHealth(cfg)
    for _ in range(2):
        h.observe("r0", progressed=False, has_work=True)
    h.observe("r0", progressed=True, has_work=True)
    for _ in range(2):
        h.observe("r0", progressed=False, has_work=True)
    assert h.assess()["r0"] == "ok"
    h.observe("r0", progressed=False, has_work=True)
    assert h.assess()["r0"] == "wedged"
    h2 = ReplicaHealth(cfg)
    for _ in range(2):
        h2.observe("r1", progressed=False, has_work=True)
    h2.observe("r1", progressed=False, has_work=False)
    h2.observe("r1", progressed=False, has_work=True)
    assert h2.assess()["r1"] == "wedged"
    h.forget("r0")
    assert "r0" not in h.snapshot()


# --------------------------------------------------------------------- #
# replay_clone: stream splice + watermark dedup
# --------------------------------------------------------------------- #


def test_replay_clone_splices_stream_exactly_once():
    streamed = []
    orig = Request(rid=1, prompt=np.array([1, 2, 3], np.int32),
                   max_new_tokens=5, on_token=streamed.append)
    orig.out.extend([7, 8])
    clone = orig.replay_clone(rid=1000)
    assert clone.prompt.tolist() == [1, 2, 3, 7, 8]
    assert clone.max_new_tokens == 3
    for t in (9, 10):
        clone.out.append(t)
        clone.on_token(t)
    assert orig.out == [7, 8, 9, 10]
    assert streamed == [9, 10]


def test_replay_clone_dedups_raced_token():
    orig = Request(rid=1, prompt=np.array([1, 2], np.int32),
                   max_new_tokens=4)
    orig.out.append(5)
    clone = orig.replay_clone(rid=1000)
    orig.out.append(6)
    clone.out.append(6)
    clone.on_token(6)
    assert orig.out == [5, 6]
    clone.out.append(7)
    clone.on_token(7)
    assert orig.out == [5, 6, 7]


def test_replay_clone_rejects_exhausted_request():
    orig = Request(rid=1, prompt=np.array([1], np.int32), max_new_tokens=2)
    orig.out.extend([3, 4])
    with pytest.raises(AssertionError, match="full budget"):
        orig.replay_clone(rid=2)


# --------------------------------------------------------------------- #
# chaos legs: every fault, zero lost, bit-identical streams
# --------------------------------------------------------------------- #


def test_kill_mid_flight_fails_over_bit_identical(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["A", "B", "C"])
    config = _fleet_cfg(cache_bytes=1 << 24)
    single = _reference_streams(cfg, params, reg, TENANCY, config)
    reqs = _requests(cfg, TENANCY)
    router = _router(cfg, params, config, replicas=2, registry=reg,
                     spill_depth=2, trace=True)
    for r in reqs:
        assert router.submit(r) is not None
    victim = _busiest(router)
    router.faults = FaultPlan.parse(f"kill:{victim}@round2")
    for _ in range(2):
        router.step()
    assert victim in router.replicas
    router.run_until_drained()
    assert router.fenced[victim] == "killed"
    assert all(r.done for r in reqs), "failover lost a request"
    assert {r.rid: tuple(r.out) for r in reqs} == single
    s = router.stats()["fleet"]
    assert s["fences"] == 1 and s["sheds"] == 0
    assert s["failovers"] >= 1
    assert s["recover_rounds"] >= 1
    assert any(rec["rounds"] is not None for rec in s["recoveries"])
    names = {e.get("name") for e in router.trace_dict()["traceEvents"]}
    assert {"fence", "failover"} <= names


def test_kill_with_auto_replacement(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["A", "B", "C"])
    config = _fleet_cfg(fleet=FleetConfig(replace_after_fence=True),
                        cache_bytes=1 << 24)
    single = _reference_streams(cfg, params, reg, TENANCY, config)
    reqs = _requests(cfg, TENANCY)
    router = _router(cfg, params, config, replicas=2, registry=reg,
                     spill_depth=2)
    for r in reqs:
        router.submit(r)
    victim = _busiest(router)
    router.faults = FaultPlan.parse(f"kill:{victim}@round2")
    router.run_until_drained()
    assert len(router.replicas) == 2
    assert "replica2" in router.replicas
    assert victim in router.fenced
    assert all(r.done for r in reqs)
    assert {r.rid: tuple(r.out) for r in reqs} == single


def test_wedged_replica_is_fenced_and_replayed(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["A", "B", "C"])
    config = _fleet_cfg(cache_bytes=1 << 24)
    single = _reference_streams(cfg, params, reg, TENANCY, config)
    reqs = _requests(cfg, TENANCY)
    router = _router(cfg, params, config, replicas=2, registry=reg,
                     spill_depth=2)
    for r in reqs:
        router.submit(r)
    victim = _busiest(router)
    router.faults = FaultPlan.parse(f"wedge:{victim}@round1")
    router.run_until_drained()
    assert router.fenced.get(victim) == "wedged"
    assert all(r.done for r in reqs)
    assert {r.rid: tuple(r.out) for r in reqs} == single
    assert router.stats()["fleet"]["sheds"] == 0


def test_slow_replica_flagged_not_fenced(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["A", "B", "C"])
    config = _fleet_cfg(fleet=FleetConfig(slow_threshold=1.5,
                                          warmup_rounds=2),
                        cache_bytes=1 << 24)
    single = _reference_streams(cfg, params, reg, TENANCY, config,
                                new_tokens=8)
    reqs = _requests(cfg, TENANCY, new_tokens=8)
    router = _router(cfg, params, config, replicas=3, registry=reg,
                     spill_depth=2)
    for r in reqs:
        router.submit(r)
    victim = _busiest(router)
    router.faults = FaultPlan.parse(f"slow:{victim}@round0:2x")
    router.run_until_drained()
    assert router.stats()["fleet"]["stragglers_flagged"] >= 1
    assert victim not in router.fenced
    assert all(r.done for r in reqs)
    assert {r.rid: tuple(r.out) for r in reqs} == single


def test_transient_adapter_read_errors_are_absorbed(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["A", "B", "C"])
    config = _fleet_cfg(fleet=FleetConfig(retry_backoff_ms=0.0),
                        cache_bytes=1 << 24)
    single = _reference_streams(cfg, params, reg, TENANCY, config)
    reqs = _requests(cfg, TENANCY)
    plan = FaultPlan.parse("adapter_read_error:n=2")
    router = _router(cfg, params, config, replicas=2, registry=reg,
                     spill_depth=2, fault_plan=plan)
    assert reg.retry_backoff_ms == 0.0
    for r in reqs:
        router.submit(r)
    router.run_until_drained()
    assert plan.injected["read_error"] == 2
    assert reg.retried_reads >= 2
    assert router.fenced == {}
    assert all(r.done for r in reqs)
    assert {r.rid: tuple(r.out) for r in reqs} == single


# --------------------------------------------------------------------- #
# elastic membership
# --------------------------------------------------------------------- #


def test_add_replica_rebalances_and_precaptures_d2d(tiny):
    _, _, cfg, params = tiny
    ids = [f"t{i}" for i in range(12)]
    reg = _registry(params, ids)
    config = _fleet_cfg(cache_bytes=1 << 26)
    router = _router(cfg, params, config, replicas=2, registry=reg)
    for r in _requests(cfg, ids, new_tokens=2):
        router.submit(r)
    router.run_until_drained()
    resident_before = set(router.directory.adapters())
    new = router.add_replica()
    assert new == "replica2" and new in router.replicas
    moved = [a for a in ids if router.home(a) == new]
    assert moved
    cache = router.replicas[new].server.cache.stats()
    expected = [a for a in moved if a in resident_before]
    assert cache["peer_hits"] >= len(expected) >= 1
    assert cache["h2d_bytes"] == 0
    for aid in expected:
        assert new in router.directory.holders(aid)
    assert router.stats()["fleet"]["ring_resizes"] == 1
    single = _reference_streams(cfg, params, reg, ids, config,
                                new_tokens=2)
    reqs = _requests(cfg, ids, new_tokens=2)
    for r in reqs:
        router.submit(r)
    router.run_until_drained()
    assert {r.rid: tuple(r.out) for r in reqs} == single


def test_add_replica_moves_queued_requests_home(tiny):
    _, _, cfg, params = tiny
    ids = [f"t{i}" for i in range(12)]
    reg = _registry(params, ids)
    router = _router(cfg, params, _fleet_cfg(), replicas=2, registry=reg,
                     spill_depth=10 ** 6)
    reqs = _requests(cfg, ids * 2, new_tokens=2)
    for r in reqs:
        router.submit(r)
    new = router.add_replica()
    moved_tenants = {a for a in ids if router.home(a) == new}
    assert moved_tenants
    newcomer_queue = router.replicas[new].server.queue
    assert newcomer_queue
    assert all(q.adapter_id in moved_tenants for q in newcomer_queue)
    for q in newcomer_queue:
        assert router.routed_to(q.rid) == new
    router.run_until_drained()
    assert all(r.done for r in reqs)


def test_remove_replica_drains_and_hands_off(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["A", "B", "C"])
    config = _fleet_cfg(cache_bytes=1 << 24)
    single = _reference_streams(cfg, params, reg, TENANCY, config)
    reqs = _requests(cfg, TENANCY)
    router = _router(cfg, params, config, replicas=3, registry=reg,
                     spill_depth=2)
    for r in reqs:
        router.submit(r)
    for _ in range(2):
        router.step()
    victim = _busiest(router)
    resident = router.directory.resident_ids(victim)
    router.remove_replica(victim)
    assert victim not in router.replicas
    assert victim not in router.ring.nodes()
    for aid in resident:
        assert victim not in router.directory.holders(aid)
    router.run_until_drained()
    assert all(r.done for r in reqs), "remove_replica lost a request"
    assert {r.rid: tuple(r.out) for r in reqs} == single
    s = router.stats()["fleet"]
    assert s["replicas"] == 2 and s["ring_resizes"] == 1
    assert s["tokens"] == sum(len(r.out) - 1 for r in reqs)


def test_remove_last_replica_refused(tiny):
    _, _, cfg, params = tiny
    router = _router(cfg, params, _fleet_cfg(), replicas=1)
    with pytest.raises(RuntimeError, match="last replica"):
        router.remove_replica("replica0")
    with pytest.raises(RuntimeError, match="cannot fence last replica"):
        router.fence("replica0", "killed")


# --------------------------------------------------------------------- #
# drain exhaustion diagnostics
# --------------------------------------------------------------------- #


def test_wedged_fleet_error_reports_per_replica_state(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["A"])
    router = _router(cfg, params, _fleet_cfg(), replicas=1, registry=reg)
    for r in _requests(cfg, ["A", "A"]):
        router.submit(r)
    router.faults = FaultPlan.parse("wedge:replica0@round0")
    with pytest.raises(RuntimeError) as ei:
        router.run_until_drained()
    msg = str(ei.value)
    assert "fleet wedged" in msg and "no replica made progress" in msg
    assert "replica0: queue=" in msg
    assert "groups=['A']" in msg
    assert "last_progress_round=" in msg


def test_max_rounds_exhaustion_error_reports_context(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["A", "B"])
    router = _router(cfg, params, _fleet_cfg(), replicas=2, registry=reg)
    for r in _requests(cfg, ["A", "B"] * 4, new_tokens=8):
        router.submit(r)
    with pytest.raises(RuntimeError, match="not drained after "
                                           "max_rounds=1") as ei:
        router.run_until_drained(max_rounds=1)
    assert "queue=" in str(ei.value)
    assert "last_progress_round=" in str(ei.value)


# --------------------------------------------------------------------- #
# FleetConfig wiring
# --------------------------------------------------------------------- #


def test_fleet_config_roundtrip_and_rejection():
    cfg = ServeConfig(fleet=FleetConfig(vnodes=32, wedge_rounds=5,
                                        replace_after_fence=True))
    assert ServeConfig.from_json(cfg.to_json()) == cfg
    got = ServeConfig.from_dict({"fleet": {"wedge_rounds": 7}})
    assert got.fleet.wedge_rounds == 7
    assert got.fleet.vnodes == FleetConfig().vnodes
    with pytest.raises(ValueError, match="unknown fleet keys"):
        ServeConfig.from_dict({"fleet": {"bogus": 1}})


def test_router_takes_knobs_from_fleet_config(tiny):
    _, _, cfg, params = tiny
    reg = tad.InMemoryRegistry({})
    config = _fleet_cfg(fleet=FleetConfig(vnodes=16, spill_depth=7,
                                          read_retries=5,
                                          retry_backoff_ms=0.0))
    router = _router(cfg, params, config, replicas=2, registry=reg)
    assert router.ring.vnodes == 16
    assert router.spill_depth == 7
    assert reg.read_retries == 5
    router2 = _router(cfg, params, config, replicas=2, vnodes=8,
                      spill_depth=3)
    assert router2.ring.vnodes == 8 and router2.spill_depth == 3


def test_replica_step_raises_replica_killed(tiny):
    _, _, cfg, params = tiny
    router = _router(cfg, params, _fleet_cfg(), replicas=2)
    rep = router.replicas["replica0"]
    with pytest.raises(ReplicaKilled):
        rep.step(FaultPlan.parse("kill:replica0@round0"), 0)


# --------------------------------------------------------------------- #
# across the packages: every leg's streams and round-decided stats
# --------------------------------------------------------------------- #

JAX = types.SimpleNamespace(
    Router=jfleet.Router, Server=jsl.DecodeServer, Request=jsl.Request,
    FaultPlan=jel.FaultPlan, FleetConfig=jsc.FleetConfig,
    ServeConfig=lambda fleet, **sched: jsc.ServeConfig(
        batch_slots=2, max_seq=64, fleet=fleet,
        sched=jsc.SchedConfig(steps_per_turn=2, **sched)))
PORT = types.SimpleNamespace(
    Router=lambda *a, **kw: Router(*a, device="cpu", **kw),
    Server=lambda *a, **kw: DecodeServer(*a, device="cpu", **kw),
    Request=Request, FaultPlan=FaultPlan, FleetConfig=FleetConfig,
    ServeConfig=lambda fleet, **sched: _fleet_cfg(fleet=fleet, **sched))

ROUND_KEYS = ("submitted", "routed_home", "spills", "sheds", "steals",
              "rounds", "tokens", "fences", "failovers", "ring_resizes",
              "live_replicas", "replicas", "spill_depth", "tps_per_round",
              "swaps", "swap_bytes", "peer_hits", "xrep_bytes",
              "h2d_bytes", "fenced_replicas", "recover_rounds",
              "recoveries")

# leg -> (replicas, FleetConfig kwargs, fault spec ("{victim}" = the
# busiest replica after submit), new tokens)
LEGS = {
    "kill": (2, {}, "kill:{victim}@round2", 4),
    "kill_replace": (2, {"replace_after_fence": True},
                     "kill:{victim}@round2", 4),
    "wedge": (2, {}, "wedge:{victim}@round1", 4),
    "slow": (3, {"slow_threshold": 1.5, "warmup_rounds": 2},
             "slow:{victim}@round0:2x", 8),
    "read_error": (2, {"retry_backoff_ms": 0.0},
                   "adapter_read_error:n=2", 4),
    "add": (2, {}, None, 4),
    "remove": (3, {}, None, 4),
}


def _paired_registries(jparams, ids):
    jd = {}
    for i, aid in enumerate(ids):
        tuned = jperturb(jparams, rows=(i % 4, (i + 2) % 4),
                         scale=0.5 + 0.1 * i, seed=100 + i)
        jd[aid] = jad.extract_delta(jparams, tuned,
                                    meta={"adapter_id": aid})
    port = {a: tad.SparseDelta(
        {n: tad.DeltaEntry(idx=e.idx, rows=np.asarray(e.rows))
         for n, e in d.entries.items()}, dict(d.meta))
        for a, d in jd.items()}
    return jad.InMemoryRegistry(jd), tad.InMemoryRegistry(port)


def _run_leg(side, mcfg, params, registry, leg):
    """One chaos or membership leg on one package's Router; returns the
    streams, the round-decided fleet fields, per-replica counters and
    the registry's retried reads."""
    replicas, fleet_kw, spec, new_tokens = LEGS[leg]
    config = side.ServeConfig(side.FleetConfig(**fleet_kw),
                              cache_bytes=1 << 24)
    reqs = _requests(mcfg, TENANCY, new_tokens=new_tokens, cls=side.Request)
    plan = (side.FaultPlan.parse(spec) if leg == "read_error" else None)
    router = side.Router(mcfg, params, config, replicas=replicas,
                         registry=registry, spill_depth=2, fault_plan=plan)
    if leg == "add":
        router.add_replica()
    for r in reqs:
        assert router.submit(r) is not None
    if spec is not None and plan is None:
        router.faults = side.FaultPlan.parse(
            spec.format(victim=_busiest(router)))
    if leg == "remove":
        for _ in range(2):
            router.step()
        router.remove_replica(_busiest(router))
    router.run_until_drained()
    assert all(r.done for r in reqs)
    s = router.stats()
    f = {k: s["fleet"][k] for k in ROUND_KEYS}
    if leg == "slow":     # decided by the synthetic clock
        f["stragglers_flagged"] = s["fleet"]["stragglers_flagged"]
    per = {n: (p["decode"]["steps"], p["decode"]["tokens"],
               p["sched"]["swaps"], p["sched"]["finished"], p.get("cache"))
           for n, p in s["replicas"].items()}
    return ({r.rid: tuple(r.out) for r in reqs}, f, per,
            registry.retried_reads, router)


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_leg_streams_and_stats_equal_jax(tiny, leg):
    jcfg, jparams, cfg, params = tiny
    jreg, reg = _paired_registries(jparams, ["A", "B", "C"])
    want = _run_leg(JAX, jcfg, jparams, jreg, leg)
    got = _run_leg(PORT, cfg, params, reg, leg)
    assert got[0] == want[0], "streams differ from JAX's"
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    if leg.startswith("kill") or leg == "wedge":
        assert got[1]["fences"] == 1 and got[1]["failovers"] >= 1
    # and bitwise the fault-free single server's
    srv = DecodeServer(cfg, params, _fleet_cfg(cache_bytes=1 << 24),
                       registry=reg, device="cpu")
    reqs = _requests(cfg, TENANCY, new_tokens=LEGS[leg][3])
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    assert got[0] == {r.rid: tuple(r.out) for r in reqs}


def test_replay_rows_are_the_uninterrupted_streams_rows(tiny):
    """A clone primes the original prompt in chunks and the streamed
    tokens through the decode step, so its K/V rows are bitwise those
    the uninterrupted stream wrote (a chunk rounds the streamed tokens'
    rows differently, on the CPU in f32 too), and it goes on with the
    uninterrupted stream's next token."""
    _, _, cfg, params = tiny
    config = ServeConfig(batch_slots=2, max_seq=64, attn_impl="full",
                         prefill_chunk=4)
    a = DecodeServer(cfg, params, config, device="cpu")
    r = Request(rid=0, prompt=np.arange(5) + 3, max_new_tokens=12)
    a.submit(r)
    for _ in range(5):
        a.step()
    clone = r.replay_clone(rid=1)
    assert clone.decoded_tail == len(r.out) == 6
    a.step()                  # writes the last streamed token's rows
    nxt = r.out[6]
    b = DecodeServer(cfg, params, config, device="cpu")
    b.submit(clone)
    b.step()                  # admits (primes) the clone, then decodes
    assert clone.out[0] == nxt
    n = len(clone.prompt)
    rows_a = interop._flatten_with_names(a.cache_state)[1]
    rows_b = interop._flatten_with_names(b.cache_state)[1]
    for x, y in zip(rows_a, rows_b):
        assert torch.equal(x[:, 0, :n].view(torch.int16),
                           y[:, 0, :n].view(torch.int16))
    # the prompt's 5 tokens in chunks of 4 and 1, the 6 streamed singly
    assert b.stats()["prefill"]["dispatches"] == 2 + 6


# --------------------------------------------------------------------- #
# the fence frees device memory; the wall clock decides nothing
# --------------------------------------------------------------------- #


def test_fenced_replica_frees_its_memory_and_keeps_its_stats(tiny):
    _, _, cfg, params = tiny
    reg = _registry(params, ["A", "B", "C"])
    router = _router(cfg, params, _fleet_cfg(cache_bytes=1 << 24),
                     replicas=2, registry=reg, spill_depth=2, trace=True)
    for r in _requests(cfg, TENANCY):
        router.submit(r)
    victim = _busiest(router)
    srv = router.replicas[victim].server
    for _ in range(8):                      # until it holds a cached row
        if srv.cache.cached_ids():
            break
        router.step()
    assert srv.cache.cached_ids() and srv.active.count(None) < len(
        srv.active)
    router.faults = FaultPlan.parse(f"kill:{victim}@round{router.rounds}")
    held = [weakref.ref(t) for t in
            interop._flatten_with_names(srv.params)[1]
            + interop._flatten_with_names(srv.cache_state)[1]]
    router.step()                           # the kill fires here
    assert victim in router.fenced
    before = router.stats()["replicas"][victim]
    del srv
    gc.collect()
    assert all(ref() is None for ref in held)
    fenced = router._fenced_replicas[victim]
    assert fenced.server.params is None and fenced.server.cache_state is None
    assert fenced.server.cache.cached_ids() == []
    router.run_until_drained()
    after = router.stats()["replicas"][victim]
    assert after == before and after["decode"]["steps"] >= 1
    assert after["cache"]["resident"] >= 1    # as at the fence
    pids = {e["pid"] for e in router.trace_dict()["traceEvents"]}
    assert len(pids) == 3                     # router + both replicas


def test_legs_do_not_depend_on_the_wall_clock(tiny, monkeypatch):
    """The kill leg with a wall clock that jumps by up to 10 s a call:
    streams and the round-decided fields are those of the real clock."""
    jcfg, jparams, cfg, params = tiny
    _, reg = _paired_registries(jparams, ["A", "B", "C"])
    real = _run_leg(PORT, cfg, params, reg, "kill")
    rng = np.random.default_rng(0)
    clock = {"t": 0.0}

    def jumpy():
        clock["t"] += float(rng.uniform(0.0, 10.0))
        return clock["t"]

    monkeypatch.setattr(tfleet, "time", types.SimpleNamespace(
        monotonic=jumpy, monotonic_ns=lambda: int(jumpy() * 1e9)))
    _, reg = _paired_registries(jparams, ["A", "B", "C"])
    fake = _run_leg(PORT, cfg, params, reg, "kill")
    assert fake[:4] == real[:4]
