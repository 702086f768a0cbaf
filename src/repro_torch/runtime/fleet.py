"""FleetServe: N in-process serving replicas behind one router
(counterpart of ``repro.runtime.fleet``, over the port's ``DecodeServer``
and device ``AdapterCache``).

One ``DecodeServer`` serves one slot batch; heavy multi-tenant traffic
needs N replicas, and under BlockDelta the thing worth keeping is
*adapter affinity*: a tenant's delta rows should stay resident on the
device of about one replica, so its flips stay device-to-device row
swaps.

- ``ConsistentHashRing``: tenant -> replica by consistent hashing with
  virtual nodes over md5 (the JAX package's ``_hash64``, so placement is
  the same for the same names, in every process); adding or removing a
  replica remaps about 1/N tenants.
- ``FleetAdapterDirectory``: which replica holds which adapter
  resident.  When routing moves a tenant (a spill, a steal, a ring
  change), the destination's ``AdapterCache`` takes the origin's
  device rows instead of promoting from the host again (``peer_hits`` /
  ``xrep_bytes``).  Cached rows are never written in place, and a
  whole-leaf apply copies its rows into a leaf the replica owns
  (``adapters.delta.apply_delta``), so no tensor that one replica's
  swaps write in place is reachable from another replica.
- ``Replica``: one ``DecodeServer`` with its own ``Tracer`` and
  ``MetricsRegistry`` (one process of lanes in the merged trace) and a
  directory-wired ``AdapterCache``, on one device.
- ``Router``: shards tenants by ring affinity, *spills* a hot tenant to
  its ring successors when its home replica's backlog reaches
  ``spill_depth``, *steals* queued work onto replicas whose queues ran
  dry, and *sheds* requests whose SLO no replica can meet
  (``Replica.est_wait_ms``).

ElasticFleet (``runtime/elastic.py`` holds the pieces): ``add_replica``
/ ``remove_replica`` resize the ring live (queued work follows the
ring, resident rows are handed over device-to-device); a replica that
raises ``ReplicaFailure`` or is assessed wedged by ``ReplicaHealth`` is
**fenced**: off the ring, its directory entries dropped, its queued
requests re-routed (never shed), its in-flight requests **replayed** on
peers from prompt + streamed tokens (``Request.replay_clone``, spliced
back exactly once at the emitted-token watermark).  The fenced replica
frees its weights, KV cache and cached rows on the device at once; its
stats, metrics and trace stay, as in the JAX package.

The fleet is (model config, params, one frozen ``ServeConfig``, replica
count); ``ServeConfig.fleet`` carries the ring / health / retry knobs.
Every replica decodes with the single-replica scheduler, and a slot's
tokens do not depend on what shares its batch, so per-request streams
equal one ``DecodeServer``'s across spills, steals, resizes and
replays.

Stepping is round-based: ``Router.step()`` advances every replica with
work by one scheduler step (one fleet *round*).  In-process replicas
share one device, so throughput is counted in tokens per round.  Every
routing, fencing and replay decision is taken on the round clock; the
wall clock feeds only the health EMAs outside ``slow`` fault legs
(which use a synthetic clock), and the SLO estimate once a request has
finished (``sched/request_ms``).
"""
from __future__ import annotations

import bisect
import hashlib
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.adapters.device_cache import AdapterCache
from repro_torch.models.model import resolve_device
from repro_torch.obs import MetricsRegistry, Tracer, merged_chrome_trace_dict
from repro_torch.runtime.elastic import (FaultPlan, ReplicaFailure,
                                         ReplicaHealth, ReplicaKilled)
from repro_torch.runtime.serve_config import ServeConfig
from repro_torch.runtime.serve_loop import (STATS_VERSION, DecodeServer,
                                            Request)


def _hash64(s: str) -> int:
    """Deterministic 64-bit hash (``hash()`` is salted per process —
    useless for cross-process-stable placement)."""
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")


class ConsistentHashRing:
    """Consistent hashing with virtual nodes.

    Each node owns ``vnodes`` points on a 64-bit ring; a key maps to
    the first point clockwise from its hash.  Adding/removing a node
    moves only the keys whose owning arc changed — ~1/N of them.
    """

    def __init__(self, nodes: Sequence[str] = (), vnodes: int = 64):
        assert vnodes >= 1
        self.vnodes = int(vnodes)
        self._points: List[int] = []       # sorted vnode hashes
        self._owner: Dict[int, str] = {}   # vnode hash -> node
        self._nodes: List[str] = []
        for n in nodes:
            self.add(n)

    def add(self, node: str) -> None:
        if node in self._nodes:
            raise ValueError(f"node {node!r} already on the ring")
        self._nodes.append(node)
        for v in range(self.vnodes):
            h = _hash64(f"{node}#{v}")
            # md5 collisions across distinct vnode labels are not a
            # practical concern; first writer keeps the point
            if h not in self._owner:
                bisect.insort(self._points, h)
                self._owner[h] = node

    def remove(self, node: str) -> None:
        self._nodes.remove(node)
        self._points = [h for h in self._points
                        if self._owner[h] != node]
        self._owner = {h: n for h, n in self._owner.items() if n != node}

    def nodes(self) -> List[str]:
        return list(self._nodes)

    def owner(self, key: str) -> str:
        return self.preference(key)[0]

    def preference(self, key: str) -> List[str]:
        """All nodes in ring order from ``key``'s point: the owner
        first, then the distinct successors (spill order)."""
        if not self._points:
            raise ValueError("empty ring")
        i = bisect.bisect_right(self._points, _hash64(key))
        seen, out = set(), []
        for j in range(len(self._points)):
            node = self._owner[self._points[(i + j) % len(self._points)]]
            if node not in seen:
                seen.add(node)
                out.append(node)
        return out


class FleetAdapterDirectory:
    """Shared registry of HBM-resident adapter copies across replicas.

    ``AdapterCache`` publishes on admit (promotion, ``put_back``
    capture, peer capture) and unpublishes on evict/drop — so a lookup
    only ever returns rows that are actually resident *right now*.
    Entries are version-stamped; a lookup for a newer registry version
    skips stale holders (they will be invalidated on their own next
    ``get``).
    """

    def __init__(self):
        # adapter_id -> {owner -> SparseDelta (device-resident)}
        self._resident: Dict[str, Dict[str, object]] = {}

    def publish(self, owner: str, adapter_id: str, delta) -> None:
        self._resident.setdefault(adapter_id, {})[owner] = delta

    def unpublish(self, owner: str, adapter_id: str) -> None:
        holders = self._resident.get(adapter_id)
        if holders is not None:
            holders.pop(owner, None)
            if not holders:
                del self._resident[adapter_id]

    def holders(self, adapter_id: str) -> List[str]:
        return list(self._resident.get(adapter_id, ()))

    def adapters(self) -> List[str]:
        """Every adapter id with at least one resident copy."""
        return list(self._resident)

    def resident_ids(self, owner: str) -> List[str]:
        """Adapter ids ``owner`` currently holds resident."""
        return [aid for aid, holders in self._resident.items()
                if owner in holders]

    def drop_owner(self, owner: str) -> List[str]:
        """Forget every entry ``owner`` holds (fencing: a dead
        replica's HBM is presumed lost, so no peer may capture from
        it).  Returns the adapter ids dropped."""
        dropped = self.resident_ids(owner)
        for aid in dropped:
            self.unpublish(owner, aid)
        return dropped

    def lookup(self, adapter_id: str, version: int,
               exclude: Optional[str] = None):
        """A peer's device-resident delta at ``version``, or None."""
        for owner, delta in self._resident.get(adapter_id, {}).items():
            if owner == exclude:
                continue
            if delta.meta.get("registry_version", 0) == version:
                return delta
        return None


class Replica:
    """One serving replica: a ``DecodeServer`` built from the shared
    ``ServeConfig`` on ``device``, with its own tracer / metrics (one
    lane set per replica in the merged trace) and a directory-wired
    ``AdapterCache``."""

    def __init__(self, name: str, cfg, params, config: ServeConfig, *,
                 registry=None, directory=None, trace: bool = False,
                 device=None):
        self.name = name
        self.device = resolve_device(device)
        self.metrics = MetricsRegistry()
        self.tracer = Tracer() if trace else None
        cache = None
        if config.sched.cache_bytes > 0 and registry is not None:
            cache = AdapterCache(registry,
                                 cache_bytes=config.sched.cache_bytes,
                                 tracer=self.tracer, directory=directory,
                                 owner=name, device=self.device)
        self.server = DecodeServer(cfg, params, config,
                                   registry=registry, cache=cache,
                                   tracer=self.tracer,
                                   metrics=self.metrics,
                                   device=self.device)
        self._final_stats: Optional[Dict[str, object]] = None

    def release(self) -> None:
        """Free this replica's device memory (weights, KV cache, cached
        rows) once it is fenced: ``stats()`` returns the stats of the
        fence from then on, and the tracer and metrics stay."""
        srv = self.server
        self._final_stats = srv.stats()
        srv.params = srv.cache_state = srv._displaced = None
        if srv.cache is not None:
            for aid in srv.cache.cached_ids():
                srv.cache.drop(aid)

    def stats(self) -> Dict[str, object]:
        return (self._final_stats if self._final_stats is not None
                else self.server.stats())

    # -- load observables (the router's routing/shedding inputs) ------- #

    def depth(self) -> int:
        """Queued + active requests (the ``sched/queue_depth`` gauge
        covers only the queue; routing counts in-flight work too)."""
        srv = self.server
        return len(srv.queue) + sum(r is not None for r in srv.active)

    def est_wait_ms(self) -> float:
        """SLO pressure estimate: depth scaled by observed per-request
        service time (``sched/request_ms`` mean once samples exist,
        else the ``ms_per_step`` x ``steps_per_turn`` prior), divided
        by slot parallelism.  Zero when idle — an idle replica can
        always admit."""
        srv = self.server
        d = self.depth()
        if d == 0:
            return 0.0
        h = self.metrics.histogram("sched/request_ms")
        service = (h.mean if h.count else
                   srv.ms_per_step * srv.steps_per_turn)
        return d / max(1, srv.slots) * service

    def has_work(self) -> bool:
        srv = self.server
        return bool(srv.queue) or any(r is not None for r in srv.active)

    # -- stepping (fault-hooked) --------------------------------------- #

    def step(self, faults: Optional[FaultPlan] = None, rnd: int = 0):
        """Advance one scheduler step, consulting the fault plan first
        — the injection point a real device failure would surface at.
        Returns ``(finished, step_ms, progressed)``; ``step_ms`` is
        None for a wedged non-step (nothing to time), and routed
        through ``FaultPlan.step_ms`` otherwise (synthetic clock on
        slow legs).  A ``kill`` raises ``ReplicaKilled``."""
        if faults:
            act = faults.action(self.name, rnd)
            if act == "kill":
                raise ReplicaKilled(
                    f"replica {self.name!r} killed by fault plan at "
                    f"round {rnd}")
            if act == "wedge":
                return 0, None, False
            if act == "stall":   # a slow replica's skipped round
                return 0, faults.step_ms(self.name, rnd, 0.0), False
        before = self.server._progress_key()
        t0 = time.monotonic()
        finished = self.server.step()
        dt_ms = (time.monotonic() - t0) * 1e3
        if faults:
            dt_ms = faults.step_ms(self.name, rnd, dt_ms)
        return finished, dt_ms, self.server._progress_key() != before


class Router:
    """Shard tenants across N replicas by adapter-affinity consistent
    hashing; spill hot tenants under load; shed on SLO pressure; fence
    and fail over replicas that die or wedge; resize membership live."""

    def __init__(self, cfg, params, config: Optional[ServeConfig] = None,
                 *, replicas: int = 2, registry=None, trace: bool = False,
                 vnodes: Optional[int] = None,
                 spill_depth: Optional[int] = None,
                 names: Optional[Sequence[str]] = None,
                 fault_plan: Optional[FaultPlan] = None, device=None):
        """``device=None`` means the CUDA device (raises without one);
        pass ``device="cpu"`` to serve on the CPU.  Every replica lives
        on that device."""
        if config is None:
            config = ServeConfig()
        self.device = resolve_device(device)
        self.config = config
        self.fleet_cfg = config.fleet
        self.registry = registry
        # retained so add_replica can build members after construction
        self._model_cfg = cfg
        self._params = params
        names = (list(names) if names is not None
                 else [f"replica{i}" for i in range(replicas)])
        if not names:
            raise ValueError("a fleet needs >= 1 replica")
        self.ring = ConsistentHashRing(
            names, vnodes=(self.fleet_cfg.vnodes if vnodes is None
                           else int(vnodes)))
        self.directory = FleetAdapterDirectory()
        self.tracer = Tracer() if trace else None
        self.metrics = MetricsRegistry()
        for c in ("fleet/submitted", "fleet/routed_home", "fleet/spills",
                  "fleet/sheds", "fleet/steals", "fleet/rounds",
                  "fleet/tokens", "fleet/fences", "fleet/failovers",
                  "fleet/ring_resizes", "fleet/stragglers_flagged"):
            self.metrics.counter(c)
        for g in ("fleet/live_replicas", "fleet/unhealthy"):
            self.metrics.gauge(g)
        self.replicas: Dict[str, Replica] = {
            n: Replica(n, cfg, params, config, registry=registry,
                       directory=self.directory, trace=trace,
                       device=self.device)
            for n in names}
        self.metrics.gauge("fleet/live_replicas").set(len(names))
        # spill when the home replica's backlog exceeds this many
        # requests; kwarg > FleetConfig.spill_depth > auto (two full
        # slot generations)
        if spill_depth is not None:
            self.spill_depth = int(spill_depth)
        elif self.fleet_cfg.spill_depth:
            self.spill_depth = self.fleet_cfg.spill_depth
        else:
            self.spill_depth = 2 * config.batch_slots
        self.rounds = 0
        self._routed: Dict[int, str] = {}     # rid -> replica name
        # ---- elastic state (fencing, failover, recovery) ------------- #
        self.health = ReplicaHealth(self.fleet_cfg)
        self.faults = (fault_plan if fault_plan is not None
                       else FaultPlan.parse(None))
        self.fenced: Dict[str, str] = {}      # name -> reason
        self._fenced_replicas: Dict[str, Replica] = {}  # stats/trace
        self._replays: Dict[int, tuple] = {}  # clone rid -> (orig, clone)
        self._replay_of: Dict[int, int] = {}  # orig rid -> clone rid
        self._recoveries: List[dict] = []
        # replay rids live far above client rids so _routed never aliases
        self._replay_rid = 1_000_000
        self._retired_tokens = 0              # tokens of removed replicas
        self._last_progress: Dict[str, int] = {n: 0 for n in names}
        self._name_seq = len(names)
        if registry is not None and hasattr(registry, "read_retries"):
            # mirror the fleet's retry policy onto the shared registry's
            # fault-tolerant read path (adapters/registry.py)
            registry.read_retries = self.fleet_cfg.read_retries
            registry.retry_backoff_ms = self.fleet_cfg.retry_backoff_ms
        self.faults.install_registry_hook(registry)

    # ------------------------------------------------------------------ #
    # routing
    # ------------------------------------------------------------------ #

    @staticmethod
    def _tenant_key(adapter_id: Optional[str]) -> str:
        return "tenant:base" if adapter_id is None \
            else f"tenant:{adapter_id}"

    def home(self, adapter_id: Optional[str]) -> str:
        """The tenant's affinity replica (ignoring load)."""
        return self.ring.owner(self._tenant_key(adapter_id))

    def _place(self, req: Request, record: bool = True) -> str:
        """Admit ``req`` to its home replica (or a ring successor when
        home is backlogged).  Never sheds — the shared placement step
        for client submits AND the fence/resize re-route paths, which
        must not lose requests.  ``record=False`` keeps failover
        re-placements out of the routed_home/spills counters (those
        describe client submissions)."""
        pref = [n for n in self.ring.preference(
            self._tenant_key(req.adapter_id)) if n in self.replicas]
        home = pref[0]
        target = home
        if self.replicas[home].depth() >= self.spill_depth:
            target = min(pref, key=lambda n: (self.replicas[n].depth(),
                                              pref.index(n)))
        spilled = target != home
        self.replicas[target].server.submit(req)
        self._routed[req.rid] = target
        if record:
            self.metrics.counter("fleet/spills" if spilled
                                 else "fleet/routed_home").inc()
            if self.tracer is not None:
                self.tracer.instant("route", lane="router", rid=req.rid,
                                    adapter=str(req.adapter_id),
                                    replica=target, home=home,
                                    spill=spilled)
        return target

    def submit(self, req: Request) -> Optional[str]:
        """Route one request: home replica by ring affinity, spilled to
        a ring successor when home is backlogged, shed (returns None)
        when the request carries an SLO no replica can plausibly meet.
        Returns the chosen replica name."""
        self.metrics.counter("fleet/submitted").inc()
        if req.slo_ms is not None:
            pref = [n for n in self.ring.preference(
                self._tenant_key(req.adapter_id)) if n in self.replicas]
            waits = {n: self.replicas[n].est_wait_ms() for n in pref}
            if min(waits.values()) > req.slo_ms:
                self.metrics.counter("fleet/sheds").inc()
                if self.tracer is not None:
                    self.tracer.instant(
                        "shed", lane="router", rid=req.rid,
                        adapter=str(req.adapter_id),
                        best_wait_ms=round(min(waits.values()), 3),
                        slo_ms=req.slo_ms)
                return None
        return self._place(req)

    def routed_to(self, rid: int) -> Optional[str]:
        """Where ``rid`` currently runs — transparently following
        failover replays (a replayed request reports the replica its
        live clone landed on, chains included)."""
        while rid in self._replay_of:
            rid = self._replay_of[rid]
        return self._routed.get(rid)

    # ------------------------------------------------------------------ #
    # stepping
    # ------------------------------------------------------------------ #

    def _steal(self) -> int:
        """Drain-tail work stealing: a replica whose queue ran dry pulls
        the tail half of the deepest peer queue.

        Submit-time routing balances *request counts*, but replicas do
        not finish together: per-step cost varies with tenant diversity
        (a replica homing many small tenants pays far more adapter
        rotation than one riding a hot tenant).  Stealing converts that
        drain tail into parallel work — the thief was about to idle, so
        moved requests only shorten the critical path.  Moving a tenant
        mid-stream is safe (token streams are schedule-invariant) and
        cheap (the thief's cache captures the donor's HBM rows through
        the directory instead of re-promoting from disk)."""
        moved = 0
        for rep in self.replicas.values():
            if rep.server.queue:
                continue
            donor = max(self.replicas.values(),
                        key=lambda r: len(r.server.queue))
            dq = donor.server.queue
            if donor is rep or len(dq) < 2:
                continue
            take = len(dq) // 2
            stolen = dq[-take:]
            del dq[-take:]
            rep.server.queue.extend(stolen)       # FIFO order preserved
            for r in stolen:
                self._routed[r.rid] = rep.name
            moved += take
            self.metrics.counter("fleet/steals").inc(take)
            if self.tracer is not None:
                self.tracer.instant("steal", lane="router",
                                    src=donor.name, dst=rep.name,
                                    n=take)
        return moved

    def step(self) -> int:
        """One fleet round: every replica with work advances one
        scheduler step; failures fence and fail over; health observes
        every replica.  Returns #requests finished this round."""
        self._steal()
        t0 = time.monotonic_ns() if self.tracer is not None else 0
        finished = 0
        attempted = 0
        rnd = self.rounds
        prev_state = {n: self.health.last_state(n) for n in self.replicas}
        for name in list(self.replicas):
            rep = self.replicas.get(name)
            if rep is None or name in self.fenced:
                continue          # fenced mid-round by a peer's failure
            if not rep.has_work():
                self.health.observe(name, progressed=True, has_work=False)
                continue
            attempted += 1
            try:
                fin, dt_ms, progressed = rep.step(self.faults, rnd)
            except ReplicaFailure as e:
                self.fence(name, reason="killed", detail=str(e))
                continue
            finished += fin
            self.health.observe(name, step_ms=dt_ms,
                                progressed=progressed, has_work=True)
            if progressed:
                self._last_progress[name] = rnd + 1
        # health verdicts: fence the wedged (never the last live replica
        # unless a replacement will take its place — run_until_drained's
        # patience guard reports that terminal wedge with full context
        # instead), flag-but-keep the merely slow (stealing rebalances
        # them; a slowdown hard enough to matter wedges on its own)
        states = self.health.assess()
        for name, state in states.items():
            if name not in self.replicas:
                continue
            if state == "wedged" and (len(self.replicas) > 1
                                      or self.fleet_cfg.replace_after_fence):
                self.fence(name, reason="wedged")
            elif state == "slow" and prev_state.get(name) != "slow":
                self.metrics.counter("fleet/stragglers_flagged").inc()
                if self.tracer is not None:
                    snap = self.health.snapshot().get(name, {})
                    self.tracer.instant("straggler_flagged", lane="router",
                                        replica=name, round=rnd,
                                        ema_ms=snap.get("ema_ms"))
        if attempted:
            self.rounds += 1
            self.metrics.counter("fleet/rounds").inc()
        self._propagate_replays()
        self.metrics.gauge("fleet/live_replicas").set(len(self.replicas))
        self.metrics.gauge("fleet/unhealthy").set(
            sum(1 for n, s in states.items()
                if s != "ok" and n in self.replicas))
        if self.tracer is not None and attempted:
            self.tracer.add_span("fleet_round", t0, time.monotonic_ns(),
                                 lane="router", round=self.rounds,
                                 replicas=attempted, finished=finished)
        return finished

    def _propagate_replays(self) -> None:
        """Completion propagation for failover replays: a finished
        clone marks its original done (the stream already spliced
        token-by-token through ``replay_clone``'s forwarder).  Chains
        (a replay's replica itself fenced) resolve in one pass via the
        until-stable loop.  Resolves recovery records — the
        rounds-to-recover metric the bench/CI legs gate on."""
        resolved: List[int] = []
        changed = True
        while changed:
            changed = False
            for crid, (orig, clone) in list(self._replays.items()):
                if not clone.done:
                    continue
                orig.done = True
                orig.finish_step = clone.finish_step
                del self._replays[crid]
                resolved.append(crid)
                changed = True
        for rec in self._recoveries:
            if rec["rounds"] is None:
                rec["pending"] -= set(resolved)
                if not rec["pending"]:
                    rec["rounds"] = self.rounds - rec["round"]

    def has_work(self) -> bool:
        return any(r.has_work() for r in self.replicas.values())

    # ------------------------------------------------------------------ #
    # fencing + failover
    # ------------------------------------------------------------------ #

    def fence(self, name: str, reason: str, detail: str = "") -> None:
        """Remove a dead/wedged replica from service and fail its work
        over to peers with zero loss:

        1. off the ring + directory entries dropped (HBM presumed
           lost) + health forgotten;
        2. (``fleet.replace_after_fence``) a fresh replica joins first,
           so re-routing can target it;
        3. queued (never-started) requests re-route to ring successors
           — **never shed**;
        4. in-flight requests are *replayed*: ``Request.replay_clone``
           resubmits prompt + already-streamed tokens with the
           remaining budget, splicing the clone's stream back into the
           original exactly-once at the emitted-token watermark.

        The fenced ``Replica`` is retained for stats / trace merging
        only, with its device memory freed (``Replica.release``); its
        registry pins (the adapter applied at death) are deliberately
        leaked: a real dead host cannot release anything, and pins only
        pad the host LRU's floor."""
        if name in self.fenced:
            return
        rep = self.replicas.get(name)
        if rep is None:
            raise ValueError(f"unknown replica {name!r}")
        if len(self.replicas) == 1 \
                and not self.fleet_cfg.replace_after_fence:
            raise RuntimeError(
                f"cannot fence last replica {name!r} ({reason}): no peer "
                f"to fail over to (set fleet.replace_after_fence to "
                f"auto-replace)")
        self.fenced[name] = reason
        self._fenced_replicas[name] = self.replicas.pop(name)
        self.ring.remove(name)
        self.directory.drop_owner(name)
        self.health.forget(name)
        self._last_progress.pop(name, None)
        self.metrics.counter("fleet/fences").inc()
        if self.tracer is not None:
            self.tracer.instant("fence", lane="router", replica=name,
                                reason=reason, detail=detail,
                                round=self.rounds)
        if self.fleet_cfg.replace_after_fence:
            self.add_replica()
        queued, rep.server.queue[:] = list(rep.server.queue), []
        for r in queued:
            self._place(r, record=False)
        pending = set()
        for slot, r in enumerate(rep.server.active):
            if r is None or r.done:
                continue
            rep.server.active[slot] = None
            clone = r.replay_clone(self._replay_rid)
            self._replay_rid += 1
            self._replays[clone.rid] = (r, clone)
            self._replay_of[r.rid] = clone.rid
            pending.add(clone.rid)
            dst = self._place(clone, record=False)
            # a replayed request was already *in flight* — jump it to
            # the head of the destination queue so failover restores
            # its stream promptly instead of behind the whole backlog
            q = self.replicas[dst].server.queue
            if q and q[-1] is clone:
                q.insert(0, q.pop())
            self.metrics.counter("fleet/failovers").inc()
            if self.tracer is not None:
                self.tracer.instant("failover", lane="router", rid=r.rid,
                                    replay_rid=clone.rid, src=name,
                                    dst=dst, watermark=len(r.out))
        self._recoveries.append({
            "replica": name, "reason": reason, "round": self.rounds,
            "requeued": len(queued), "replayed": len(pending),
            "pending": pending, "rounds": 0 if not pending else None})
        rep.release()

    # ------------------------------------------------------------------ #
    # elastic membership
    # ------------------------------------------------------------------ #

    def add_replica(self, name: Optional[str] = None) -> str:
        """Grow the fleet by one replica at runtime.  The ring resize
        remaps ~1/N tenants to the newcomer: their queued (not yet
        started) requests move over, and their HBM-resident adapter
        rows are pre-captured device-to-device through the directory
        (zero host->device) so the first flip on the new replica is
        already warm.  Returns the new replica's name."""
        if name is None:
            name = f"replica{self._name_seq}"
            while name in self.replicas or name in self.fenced:
                self._name_seq += 1
                name = f"replica{self._name_seq}"
            self._name_seq += 1
        if name in self.replicas or name in self.fenced:
            raise ValueError(f"replica name {name!r} already in use")
        rep = Replica(name, self._model_cfg, self._params, self.config,
                      registry=self.registry, directory=self.directory,
                      trace=self.tracer is not None, device=self.device)
        self.ring.add(name)
        self.replicas[name] = rep
        self._last_progress[name] = self.rounds
        self.health.observe(name, progressed=True, has_work=False)
        moved = 0
        for peer in self.replicas.values():
            if peer is rep:
                continue
            keep = []
            for r in peer.server.queue:
                if self.home(r.adapter_id) == name:
                    rep.server.queue.append(r)
                    self._routed[r.rid] = name
                    moved += 1
                else:
                    keep.append(r)
            peer.server.queue[:] = keep
        captured = 0
        for aid in self.directory.adapters():
            if self.home(aid) == name:
                captured += self._precapture(rep, aid)
        self.metrics.counter("fleet/ring_resizes").inc()
        self.metrics.gauge("fleet/live_replicas").set(len(self.replicas))
        if self.tracer is not None:
            self.tracer.instant("ring_resize", lane="router", action="add",
                                replica=name, round=self.rounds,
                                requeued=moved, captured=captured,
                                replicas=len(self.replicas))
        return name

    def remove_replica(self, name: str, *,
                       max_rounds: int = 10_000) -> None:
        """Shrink the fleet by one replica at runtime, losing nothing:
        queued requests re-route to ring successors, in-flight groups
        drain in place (per-replica ``run_until_drained`` semantics —
        the wedge guard still applies), and the leaver's HBM-resident
        adapter rows are handed device-to-device to each tenant's new
        home before being dropped."""
        rep = self.replicas.get(name)
        if rep is None:
            raise ValueError(f"unknown replica {name!r}")
        if len(self.replicas) == 1:
            raise RuntimeError(f"cannot remove the last replica {name!r}")
        self.ring.remove(name)
        del self.replicas[name]
        queued, rep.server.queue[:] = list(rep.server.queue), []
        for r in queued:
            self._place(r, record=False)
        if rep.has_work():
            rep.server.run_until_drained(max_steps=max_rounds)
        handed = 0
        for aid in self.directory.resident_ids(name):
            target = self.replicas.get(self.home(aid))
            if target is not None:
                handed += self._precapture(target, aid)
        if rep.server.cache is not None:
            for aid in list(rep.server.cache.cached_ids()):
                rep.server.cache.drop(aid)
        # removed replicas leave the stats roll-up; fold their token
        # count into the fleet counter so it stays monotonic
        self._retired_tokens += int(
            rep.server.stats()["decode"].get("tokens", 0))
        self.health.forget(name)
        self._last_progress.pop(name, None)
        self.metrics.counter("fleet/ring_resizes").inc()
        self.metrics.gauge("fleet/live_replicas").set(len(self.replicas))
        if self.tracer is not None:
            self.tracer.instant("ring_resize", lane="router",
                                action="remove", replica=name,
                                round=self.rounds, requeued=len(queued),
                                handed_off=handed,
                                replicas=len(self.replicas))

    def _precapture(self, rep: Replica, adapter_id: str) -> int:
        """Warm ``rep``'s cache with ``adapter_id`` via device-to-device
        peer capture — only when a current-version copy is resident on
        some other replica (never triggers a host->device promotion)."""
        cache = rep.server.cache
        if cache is None or adapter_id in cache:
            return 0
        ver = getattr(self.registry, "version", None)
        version = ver(adapter_id) if ver is not None else 0
        if self.directory.lookup(adapter_id, version,
                                 exclude=rep.name) is None:
            return 0
        cache.get(adapter_id)
        return 1

    # ------------------------------------------------------------------ #
    # draining
    # ------------------------------------------------------------------ #

    def run_until_drained(self, max_rounds: int = 10_000,
                          on_round=None) -> int:
        """Round-step until every replica is idle; returns the number
        of rounds taken.  Mirrors ``DecodeServer.run_until_drained``'s
        wedge guard, widened for fault tolerance: a fence or ring
        resize counts as progress, and the fleet gets ``wedge_rounds +
        warmup_rounds + 2`` consecutive no-progress rounds of patience
        before raising — enough for ``ReplicaHealth`` to fence a wedged
        replica and replay its work.  Exhaustion errors carry the
        per-replica queue depths, in-flight adapter groups, and
        last-progress rounds."""
        patience = (self.fleet_cfg.wedge_rounds
                    + self.fleet_cfg.warmup_rounds + 2)
        stall = 0
        for _ in range(max_rounds):
            if not self.has_work():
                return self.rounds
            before = self._drain_key()
            self.step()
            if on_round is not None:
                on_round(self)
            if self._drain_key() != before:
                stall = 0
            else:
                stall += 1
                if stall >= patience:
                    raise self._drain_error(
                        f"fleet wedged at round {self.rounds}: "
                        f"{sum(r.depth() for r in self.replicas.values())}"
                        f" request(s) pending but no replica made "
                        f"progress for {stall} consecutive rounds")
        if not self.has_work():
            return self.rounds
        raise self._drain_error(
            f"fleet not drained after max_rounds={max_rounds} "
            f"(round {self.rounds})")

    def _drain_key(self):
        """Progress fingerprint for the drain guard: per-replica
        scheduler progress plus membership — a fence or resize is
        progress even when no token moved that round."""
        return (tuple(sorted(self.replicas)), tuple(sorted(self.fenced)),
                tuple(r.server._progress_key()
                      for r in self.replicas.values()))

    def _drain_error(self, head: str) -> RuntimeError:
        """Exhaustion/wedge report with enough context to debug a hung
        fleet from the message alone: per-replica
        queue depth, in-flight count, the adapter groups those belong
        to, and the last round each replica made progress."""
        lines = []
        for name, rep in self.replicas.items():
            active = [r for r in rep.server.active
                      if r is not None and not r.done]
            groups = sorted({str(r.adapter_id) for r in active}
                            | {str(r.adapter_id)
                               for r in rep.server.queue})
            lines.append(
                f"  {name}: queue={len(rep.server.queue)} "
                f"active={len(active)} groups={groups} "
                f"last_progress_round={self._last_progress.get(name, 0)}")
        for name, reason in self.fenced.items():
            lines.append(f"  {name}: FENCED ({reason})")
        if self._replays:
            lines.append(f"  unresolved failover replays: "
                         f"{sorted(self._replays)}")
        return RuntimeError(head + "; per-replica state:\n"
                            + "\n".join(lines))

    # ------------------------------------------------------------------ #
    # fleet-level stats / trace merging
    # ------------------------------------------------------------------ #

    def stats(self) -> Dict[str, object]:
        """``fleet`` roll-up + per-replica ``DecodeServer.stats()``
        (fenced replicas included — their counters record real work).

        ``aggregate`` sums every counter/gauge across the replica
        registries and merges histograms (count/sum exactly; min/max
        exactly; p50/p99 as the worst replica's value — conservative
        for SLO gating).
        """
        per = {n: r.stats() for n, r in self._all_replicas()}
        tokens = sum(p["decode"].get("tokens", 0)
                     for p in per.values()) + self._retired_tokens
        self.metrics.counter("fleet/tokens").inc(
            tokens - self.metrics.counter("fleet/tokens").value)
        fleet = {k.split("/", 1)[1]: v for k, v in
                 self.metrics.snapshot().items()
                 if k.startswith("fleet/")}
        fleet.update({
            "replicas": len(self.replicas),
            "spill_depth": self.spill_depth,
            "tps_per_round": tokens / self.rounds if self.rounds else 0.0,
            "swaps": sum(p["sched"].get("swaps", 0)
                         for p in per.values()),
            "swap_bytes": sum(p["sched"].get("swap_bytes", 0)
                              for p in per.values()),
            "peer_hits": sum(p.get("cache", {}).get("peer_hits", 0)
                             for p in per.values()),
            "xrep_bytes": sum(p.get("cache", {}).get("xrep_bytes", 0)
                              for p in per.values()),
            "h2d_bytes": sum(p.get("cache", {}).get("h2d_bytes", 0)
                             for p in per.values()),
            "health": self.health.snapshot(),
            "fenced_replicas": dict(self.fenced),
            "recover_rounds": max(
                (rec["rounds"] for rec in self._recoveries
                 if rec["rounds"] is not None), default=0),
            "recoveries": [{k: rec[k] for k in ("replica", "reason",
                                                "round", "requeued",
                                                "replayed", "rounds")}
                           for rec in self._recoveries],
        })
        return {"stats_version": STATS_VERSION, "fleet": fleet,
                "aggregate": self.aggregate_metrics(),
                "replicas": per}

    def _all_replicas(self):
        """Live then fenced replica items (stats/trace cover both)."""
        return list(self.replicas.items()) \
            + list(self._fenced_replicas.items())

    def aggregate_metrics(self) -> Dict[str, object]:
        """Merge the replica registries into one flat snapshot."""
        agg: Dict[str, object] = {}
        for _, rep in self._all_replicas():
            for name, val in rep.metrics.snapshot().items():
                if isinstance(val, dict):           # histogram summary
                    cur = agg.get(name)
                    if cur is None:
                        agg[name] = dict(val)
                    else:
                        cur["count"] += val["count"]
                        cur["sum"] += val["sum"]
                        cur["min"] = min(cur["min"], val["min"]) \
                            if val["count"] else cur["min"]
                        cur["max"] = max(cur["max"], val["max"])
                        cur["mean"] = (cur["sum"] / cur["count"]
                                       if cur["count"] else 0.0)
                        cur["p50"] = max(cur["p50"], val["p50"])
                        cur["p99"] = max(cur["p99"], val["p99"])
                else:
                    agg[name] = agg.get(name, 0) + val
        return agg

    def trace_dict(self) -> dict:
        """Merged Chrome/Perfetto trace: one process (pid) per replica
        — each with its own tenant/sched/cache lane set — plus the
        router's lane, all on a shared time origin.  Fenced replicas'
        lanes stay in the merge (their spans show the work up to the
        fence)."""
        if self.tracer is None:
            raise ValueError("Router(trace=True) to collect a trace")
        named = [("router", self.tracer)]
        named += [(n, r.tracer) for n, r in self._all_replicas()
                  if r.tracer is not None]
        return merged_chrome_trace_dict(named)

    def write_trace(self, path):
        import json
        from pathlib import Path
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.trace_dict()))
        return p
