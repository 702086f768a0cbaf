"""Fleet serving launcher: N replicas behind an adapter-affinity router.

    PYTHONPATH=src python -m repro_torch.launch.fleet --replicas 2 \
        --demo-adapters 4 --cache-bytes 4194304 --quick

Counterpart of ``python -m repro.launch.fleet`` with the same flags and
output lines, plus ``--device`` (default: the CUDA device; ``cpu`` runs
on the CPU explicitly, with every kernel's plain PyTorch version).

Tenant traffic follows a Zipf mix (``--zipf``): a few hot tenants
dominate, the tail is long.  The router spills hot tenants to ring
successors when their home replica backlogs (``--spill-depth``), sheds
requests whose ``--slo-ms`` no replica can meet, and a tenant that lands
on a second replica takes the first replica's device rows through the
shared ``FleetAdapterDirectory`` (``peer_hits`` / ``xrep_bytes``).

Every replica is built from one frozen ``ServeConfig`` (the same
``--config`` / ``--save-config`` round trip as ``launch.serve``).
``--trace out.json`` writes one merged Chrome/Perfetto trace: one
process per replica plus the router's lane, which
``tools/check_trace.py --kind serve --require-fleet`` validates.

Chaos drills: ``--fault-plan`` injects a deterministic fault schedule
(``kill:replica1@round6``, ``wedge:replica0@round5``,
``slow:replica1@round3:3x``, ``adapter_read_error:n=2``;
``;``-separated) seeded by ``--fault-seed``.  A killed or wedged replica
is fenced (its device memory freed) and its work fails over with zero
loss; ``--replace-after-fence`` grows a fresh replica in its place.
``--assert-parity`` serves the same requests again on one fault-free
``DecodeServer`` and hard-asserts every token stream is bit-identical
(with ``tools/check_trace.py --require-failover`` on the merged trace,
the chaos gate).  Ctrl-C drains in-flight work before the stats and the
trace are written.
"""
from __future__ import annotations

import argparse
import time


def zipf_tenant_mix(tenants, n_requests: int, rng, alpha: float = 1.2):
    """Zipf-distributed tenant assignment: ``tenants[k]`` is drawn with
    probability proportional to ``1 / (k+1)**alpha``."""
    import numpy as np
    ranks = np.arange(1, len(tenants) + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    idx = rng.choice(len(tenants), size=n_requests, p=p)
    return [tenants[i] for i in idx]


def run(argv=None):
    """Parse ``argv``, serve the Zipf request mix through the fleet,
    print the summary; returns ``(router, requests)``."""
    from repro_torch.launch.serve import (add_serve_config_flags,
                                          make_demo_registry,
                                          serve_config_from_args)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-60m")
    ap.add_argument("--reduce", type=int, default=4,
                    help="scale the arch down by this factor (0 = full "
                         "width)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions of the kernels on the CPU)")
    ap.add_argument("--demo-adapters", type=int, default=4,
                    help="build N synthetic in-memory adapters (row "
                         "perturbations of the base) as the tenant set")
    ap.add_argument("--zipf", type=float, default=1.2,
                    help="Zipf exponent of the tenant mix (higher = "
                         "more skew toward the hottest tenant)")
    ap.add_argument("--slo-ms", type=float, default=0,
                    help="per-request deadline budget (0 = none); the "
                         "router sheds requests no replica can meet")
    ap.add_argument("--spill-depth", type=int, default=0,
                    help="spill a tenant off its home replica when the "
                         "home backlog reaches this many requests "
                         "(0 = 2x batch slots)")
    add_serve_config_flags(ap)
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="deterministic fault injection, ';'-separated "
                         "(e.g. 'kill:replica1@round6', "
                         "'wedge:replica0@round5', "
                         "'slow:replica1@round3:3x', "
                         "'adapter_read_error:n=2')")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for probabilistic fault specs (p=...)")
    ap.add_argument("--replace-after-fence", action="store_true",
                    help="grow a fresh replica whenever one is fenced "
                         "(fleet.replace_after_fence)")
    ap.add_argument("--assert-parity", action="store_true",
                    help="after the run, re-serve the same requests on "
                         "a fault-free single replica and hard-assert "
                         "bit-identical token streams (the chaos gate)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write ONE merged Chrome/Perfetto trace: one "
                         "pid per replica + the router lane "
                         "(load at ui.perfetto.dev)")
    ap.add_argument("--quick", action="store_true",
                    help="small smoke preset")
    args = ap.parse_args(argv)
    if args.quick:
        args.requests = min(args.requests, 10)
        args.new_tokens = min(args.new_tokens, 8)
        args.reduce = max(args.reduce, 8)

    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.elastic import FaultPlan
    from repro_torch.runtime.fleet import Router
    from repro_torch.runtime.serve_loop import DecodeServer, Request

    device = model_lib.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_config(cfg, args.reduce)
    if cfg.is_encoder_decoder or cfg.family == "vlm":
        raise SystemExit("fleet demo supports LM-family archs")
    gen = torch.Generator(device).manual_seed(args.seed)
    params = model_lib.init_params(cfg, generator=gen, device=device)

    registry, tenants = None, [None]
    if args.demo_adapters > 0:
        registry, ids = make_demo_registry(params, args.demo_adapters)
        tenants += ids
        print(f"tenants: base + {len(ids)} demo adapter(s) {ids}")

    serve_cfg = serve_config_from_args(args)
    if args.replace_after_fence:
        from dataclasses import replace as _dc
        serve_cfg = _dc(serve_cfg, fleet=_dc(serve_cfg.fleet,
                                             replace_after_fence=True))
    plan = FaultPlan.parse(args.fault_plan, seed=args.fault_seed)
    router = Router(cfg, params, serve_cfg, replicas=args.replicas,
                    registry=registry, trace=bool(args.trace),
                    spill_depth=args.spill_depth or None,
                    fault_plan=plan, device=device)
    homes = {str(t): router.home(t) for t in tenants}
    print(f"fleet: {args.replicas} replica(s) on {device}; tenant homes "
          f"{homes}")
    if plan:
        print(f"fault plan: {args.fault_plan!r} (seed {args.fault_seed},"
              f" replace_after_fence="
              f"{serve_cfg.fleet.replace_after_fence})")

    rng = np.random.default_rng(args.seed)
    mix = zipf_tenant_mix(tenants, args.requests, rng, alpha=args.zipf)
    reqs, shed = [], []
    for i, tenant in enumerate(mix):
        r = Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, 4 + i % 4),
                    max_new_tokens=args.new_tokens, adapter_id=tenant,
                    slo_ms=args.slo_ms or None)
        reqs.append(r)
        if router.submit(r) is None:
            shed.append(r)

    t0 = time.monotonic()
    try:
        rounds = router.run_until_drained()
    except KeyboardInterrupt:
        # graceful drain: finish in-flight work, then write the stats and
        # the merged trace as usual so the partial run stays inspectable
        pending = sum(r.depth() for r in router.replicas.values())
        print(f"\ninterrupted at round {router.rounds}: draining "
              f"{pending} in-flight request(s) before exit "
              f"(^C again to abort the drain)")
        try:
            rounds = router.run_until_drained()
        except KeyboardInterrupt:
            rounds = router.rounds
            print("drain aborted; stats and trace below reflect the "
                  "partial run")
    dt = time.monotonic() - t0
    s = router.stats()
    f = s["fleet"]
    tok = sum(len(r.out) for r in reqs if r not in shed)
    print(f"served {len(reqs) - len(shed)} requests "
          f"({len(shed)} shed), {tok} tokens in {rounds} rounds / "
          f"{dt:.2f}s — {f['tps_per_round']:.2f} tokens/round "
          f"aggregate")
    print(f"routing: {f['routed_home']} home / {f['spills']} spilled / "
          f"{f['sheds']} shed; swaps {f['swaps']} "
          f"({f['swap_bytes'] / 2 ** 20:.2f} MiB)")
    if f["fenced_replicas"]:
        for name, reason in f["fenced_replicas"].items():
            print(f"fenced: {name} ({reason})")
        for rec in f["recoveries"]:
            print(f"  recovery: {rec['replica']} at round "
                  f"{rec['round']} — {rec['requeued']} requeued, "
                  f"{rec['replayed']} replayed, recovered in "
                  f"{rec['rounds']} round(s)")
    if plan:
        print(f"faults injected: {plan.injected}; registry retried "
              f"reads: {getattr(registry, 'retried_reads', 0)}")
    if f["health"]:
        print("health: " + ", ".join(
            f"{n}={h['state']} (ema {h['ema_ms']}ms)"
            for n, h in sorted(f["health"].items())))
    if registry is not None and serve_cfg.sched.cache_bytes > 0:
        print(f"cross-replica capture: {f['peer_hits']} peer hit(s), "
              f"{f['xrep_bytes'] / 2 ** 20:.3f} MiB shared vs "
              f"h2d {f['h2d_bytes'] / 2 ** 20:.3f} MiB promoted")
    agg = s["aggregate"]
    req_ms = agg.get("sched/request_ms", {})
    if req_ms.get("count"):
        print(f"request_ms (all replicas): p50 {req_ms['p50']:.1f} "
              f"p99 {req_ms['p99']:.1f}")
    for n, p in s["replicas"].items():
        print(f"  {n}: {p['sched']['finished']} finished, "
              f"{p['decode']['steps']} steps, "
              f"{p['sched']['swaps']} swaps")
    if args.assert_parity:
        served = [r for r in reqs if r not in shed]
        ref_srv = DecodeServer(cfg, params, serve_cfg, registry=registry,
                               device=device)
        ref_reqs = [Request(rid=r.rid, prompt=r.prompt,
                            max_new_tokens=args.new_tokens,
                            adapter_id=r.adapter_id) for r in served]
        for r in ref_reqs:
            ref_srv.submit(r)
        ref_srv.run_until_drained()
        ref = {r.rid: r.out for r in ref_reqs}
        del ref_srv
        for r in served:
            assert r.done, f"req {r.rid} was lost by the fleet"
            assert r.out == ref[r.rid], (
                f"req {r.rid} diverged from the fault-free reference: "
                f"{r.out} != {ref[r.rid]}")
        print(f"parity: {len(served)} stream(s) bit-identical to the "
              f"fault-free single-replica reference")
    if args.trace:
        p = router.write_trace(args.trace)
        n_ev = len(router.tracer) + sum(
            len(r.tracer) for _, r in router._all_replicas()
            if r.tracer is not None)
        print(f"trace: {n_ev} events -> {p}")
    return router, reqs


def main(argv=None):
    return run(argv)[1]


if __name__ == "__main__":
    main()
