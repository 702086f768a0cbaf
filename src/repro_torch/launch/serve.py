"""Serving launcher: batched greedy decode over a demo request set.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --reduce 0 --attn-impl kernel --demo-adapters 2

Counterpart of ``python -m repro.launch.serve`` with the same flags and
output lines, plus ``--device`` (default: the CUDA device; ``cpu`` runs
on the CPU explicitly, with every kernel's plain PyTorch version).

Multi-tenant: ``--adapters <dir>`` serves every adapter of a BlockDelta
registry directory (the JAX package's format) beside the base model;
``--demo-adapters N`` builds N synthetic in-memory tenants.  Requests
are spread across the tenants; the adapter-aware scheduler hot-swaps
delta rows between decode micro-batches through the row scatter-swap
kernel.  ``--attn-impl kernel`` (the default) runs decode attention
through the hand-written kernel, ``full`` through the grouped-einsum
PyTorch path.  Prompts are primed by chunked batched prefill
(``--prefill-chunk``, 0 = per-token priming).

PagedKV (``--paged``): the KV cache becomes a pool of
``--kv-page-size``-row pages (``--kv-pages`` total, 0 = the dense
equivalent) addressed through per-slot page tables, with continuous
admission against page capacity and copy-on-write prefix sharing
(``--no-prefix-share`` turns it off).  The demo requests then share a
system prompt of 1.5 pages, so full and partial prefix pages register;
the ``paged KV:`` line reports allocations, COW splits and prefix hits.
Decode attention runs through the fused paged write+attend kernel.

SpecServe (``--speculate N``): the resident base model drafts N tokens
per round, the tenant verifies all N + 1 positions, and the longest
agreeing prefix is accepted; streams equal plain greedy decoding.  The
``speculative:`` line reports rounds and acceptance.

``--cache-bytes N`` keeps hot adapters' delta rows resident on the
device within N bytes (``repro_torch.adapters.AdapterCache``): a flip to
a cached tenant is a device-to-device row swap; the ``adapter cache:``
line reports residency, hit rate and host-to-device against
device-to-device bytes.

``--layers N`` cuts the depth to N layers (0: the config's), as the
training launcher's option does.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path


def add_serve_config_flags(ap: argparse.ArgumentParser) -> None:
    """Flags that map onto ``ServeConfig`` (as in ``repro.launch.serve``)."""
    ap.add_argument("--config", default=None, metavar="PATH",
                    help="load a ServeConfig JSON (overrides the "
                         "serve-shape flags below)")
    ap.add_argument("--save-config", default=None, metavar="PATH",
                    help="write the effective ServeConfig JSON "
                         "(reload it with --config)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--steps-per-turn", type=int, default=8,
                    help="base decode steps per adapter group before "
                         "rotating (per-adapter budgets scale from this)")
    ap.add_argument("--cache-bytes", type=int, default=0,
                    help="device byte budget for the AdapterCache "
                         "(delta rows kept resident; 0 = uncached, every "
                         "flip re-uploads host rows)")
    ap.add_argument("--aging-steps", type=int, default=0,
                    help="anti-starvation bound in decode steps "
                         "(0 = 3x steps-per-turn)")
    ap.add_argument("--round-robin", action="store_true",
                    help="disable adapter-aware admission (rotation "
                         "baseline)")
    ap.add_argument("--attn-impl", default="kernel",
                    choices=["full", "kernel"],
                    help="decode attention: 'kernel' = the hand-written "
                         "kernel (reads scale with per-slot context; its "
                         "plain version on the CPU), 'full' = "
                         "grouped-einsum PyTorch path")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="prompt positions per chunked-prefill dispatch "
                         "(0 = per-token priming)")
    kv = ap.add_mutually_exclusive_group()
    kv.add_argument("--paged", action="store_true",
                    help="paged KV cache: page pool + per-slot page "
                         "tables, continuous admission, COW prefix "
                         "sharing")
    kv.add_argument("--dense", action="store_true",
                    help="dense [slots, max_seq] KV cache (default)")
    ap.add_argument("--kv-page-size", type=int, default=16,
                    help="rows per KV page (--paged)")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="KV pages in the pool, the null page included "
                         "(0 = slots * max_seq / page size + 1)")
    ap.add_argument("--no-prefix-share", action="store_true",
                    help="paged: do not share prompt-prefix pages")
    sp = ap.add_mutually_exclusive_group()
    sp.add_argument("--speculate", type=int, default=0, metavar="N",
                    help="self-speculative decoding: the base drafts N "
                         "tokens per round, the tenant verifies them")
    sp.add_argument("--no-speculate", action="store_true")
    ap.add_argument("--ms-per-step", default="1.0",
                    help="SLO conversion: decode-step time in ms, or "
                         "'auto' to calibrate from a wall-clock EMA")


def serve_config_from_args(args):
    """Build the effective ``ServeConfig`` from parsed flags (or load
    ``--config``), honoring ``--save-config``."""
    from repro_torch.runtime.serve_config import (KVConfig, SchedConfig,
                                                  ServeConfig, SpecConfig)
    if args.config:
        cfg = ServeConfig.from_json(Path(args.config).read_text())
    else:
        cfg = ServeConfig(
            batch_slots=args.slots,
            max_seq=args.max_seq,
            attn_impl=args.attn_impl,
            prefill_chunk=args.prefill_chunk,
            sched=SchedConfig(
                steps_per_turn=args.steps_per_turn,
                adapter_aware=not args.round_robin,
                aging_steps=args.aging_steps,
                ms_per_step=("auto" if args.ms_per_step == "auto"
                             else float(args.ms_per_step)),
                cache_bytes=args.cache_bytes),
            kv=KVConfig(
                layout="paged" if args.paged else "dense",
                page_size=args.kv_page_size,
                pages=args.kv_pages,
                prefix_share=not args.no_prefix_share),
            spec=SpecConfig(
                draft=0 if args.no_speculate else args.speculate))
    if args.save_config:
        p = Path(args.save_config)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(cfg.to_json())
        print(f"serve config -> {p}")
    return cfg


def make_demo_registry(params, n: int):
    """N synthetic tenants: row-perturbed copies of the base published
    to an in-memory registry (the same perturbations as the JAX
    package's demo tenants for the same base weights)."""
    from repro_torch.adapters import InMemoryRegistry, extract_delta
    from repro_torch.adapters.testing import perturb_rows
    registry = InMemoryRegistry()
    ids = []
    for i in range(n):
        aid = f"demo{i}"
        tuned = perturb_rows(params, rows=(1 + i % 2, 3), seed=i)
        registry.put(aid, extract_delta(params, tuned,
                                        meta={"adapter_id": aid}))
        del tuned
        ids.append(aid)
    return registry, ids


def run(argv=None):
    """Parse ``argv``, serve the demo request set, print the summary;
    returns ``(server, requests)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-60m")
    ap.add_argument("--reduce", type=int, default=4,
                    help="scale the arch down by this factor (0 = full "
                         "width)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the "
                         "config's)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions of the kernels on the CPU)")
    ap.add_argument("--adapters", default=None,
                    help="BlockDelta registry dir: serve every stored "
                         "adapter alongside the base model")
    ap.add_argument("--tenants", default="all",
                    help="comma-separated adapter ids to serve "
                         "(default: all in the registry)")
    ap.add_argument("--slo-ms", type=float, default=0,
                    help="per-request deadline budget (0 = none)")
    add_serve_config_flags(ap)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a TraceKit trace of the run: .jsonl = "
                         "event log, anything else = Chrome/Perfetto JSON")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="dump the metrics registry as text every N "
                         "decode steps (0 = only the final summary)")
    ap.add_argument("--quick", action="store_true",
                    help="small smoke preset: fewer requests/tokens")
    ap.add_argument("--demo-adapters", type=int, default=0,
                    help="build N synthetic in-memory adapters (row "
                         "perturbations of the base)")
    args = ap.parse_args(argv)
    if args.quick:
        args.requests = min(args.requests, 6)
        args.new_tokens = min(args.new_tokens, 8)
        args.reduce = max(args.reduce, 8)

    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.serve_loop import DecodeServer, Request

    device = model_lib.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_config(cfg, args.reduce)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    if cfg.is_encoder_decoder or cfg.family == "vlm":
        raise SystemExit("serve demo supports LM-family archs")
    gen = torch.Generator(device).manual_seed(args.seed)
    params = model_lib.init_params(cfg, generator=gen, device=device)

    registry, tenants = None, [None]
    if args.adapters:
        from repro_torch.adapters import AdapterRegistry
        registry = AdapterRegistry(args.adapters)
        ids = (registry.list_adapters() if args.tenants == "all"
               else [t for t in args.tenants.split(",") if t])
        missing = [t for t in ids if not registry.exists(t)]
        if missing:
            raise SystemExit(f"adapters not in registry: {missing}")
        tenants += ids
        print(f"multi-tenant: base + {len(ids)} adapter(s) {ids}")
    elif args.demo_adapters > 0:
        registry, ids = make_demo_registry(params, args.demo_adapters)
        tenants += ids
        print(f"multi-tenant: base + {len(ids)} demo adapter(s) {ids}")

    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer()

    serve_cfg = serve_config_from_args(args)
    srv = DecodeServer(cfg, params, serve_cfg, registry=registry,
                       tracer=tracer, device=device)
    del params       # the server holds its own copy when it swaps adapters
    rng = np.random.default_rng(args.seed)
    # paged demo requests share a system prompt of 1.5 pages, so full and
    # partial prefix pages register and later admissions map them (and
    # the partial page's first decode write splits it copy-on-write)
    sys_prompt = (rng.integers(0, cfg.vocab_size,
                               args.kv_page_size + args.kv_page_size // 2)
                  if args.paged else np.zeros(0, np.int64))
    reqs = [Request(rid=i,
                    prompt=np.concatenate(
                        [sys_prompt,
                         rng.integers(0, cfg.vocab_size, 4 + i % 4)]),
                    max_new_tokens=args.new_tokens,
                    adapter_id=tenants[i % len(tenants)],
                    slo_ms=args.slo_ms or None)
            for i in range(args.requests)]
    for r in reqs:
        srv.submit(r)

    def _periodic(s):
        if args.metrics_every and s.steps \
                and s.steps % args.metrics_every == 0:
            print(f"-- metrics @ decode step {s.steps} --")
            print(s.metrics.dump_text(), flush=True)

    on_step = _periodic if args.metrics_every else None
    t0 = time.monotonic()
    srv.run_until_drained(on_step=on_step)
    dt = time.monotonic() - t0
    tok = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s, {srv.steps} decode steps)")
    step_ms = srv.stats()["decode"]["step_ms"]
    if step_ms["count"]:
        print(f"decode step ms: p50 {step_ms['p50']:.2f} p99 "
              f"{step_ms['p99']:.2f} over {step_ms['count']} steps")
    print(f"prefill: {srv.prefill_prompt_tokens} prompt tokens in "
          f"{srv.prefill_dispatches} dispatches "
          f"({'chunked' if srv._slot_prefill else 'per-token'}, "
          f"chunk {srv.prefill_chunk})"
          + (f"; ms/step EMA {srv.ms_per_step:.2f}"
             if args.ms_per_step == "auto" else ""))
    if srv.speculate:
        sps = srv.stats()["spec"]
        print(f"speculative: {sps['rounds']} rounds, "
              f"{sps['drafted']} drafted / {sps['accepted']} accepted "
              f"({sps['acceptance_rate']:.0%}), "
              f"{sps['rollbacks']} rollbacks, {sps['flips']} flips, "
              f"{sps['tokens_per_step']:.2f} tokens/round")
    if srv.alloc is not None:
        kvs = srv.stats()["kv"]
        al = srv.alloc
        print(f"paged KV: {al.num_pages} pages x {al.page_size} rows, "
              f"{kvs['page_alloc']} allocs / {kvs['page_free']} frees, "
              f"{kvs['cow_split']} COW splits, "
              f"prefix hits {kvs['prefix_hit_pages']} pages "
              f"({kvs['prefix_hit_tokens']} tokens), "
              f"{kvs['pages_in_use']} in use at drain")
    if registry is not None:
        sched = srv.stats()["sched"]
        reg_stats = getattr(registry, "stats", dict)()
        print(f"adapter swaps: {sched['swaps']} "
              f"({sched['swap_rate']:.3f}/step), "
              f"{sched['swap_bytes'] / 2 ** 20:.2f} MiB moved; "
              f"registry: {reg_stats}")
        if srv.cache is not None:
            c = srv.cache.stats()
            print(f"adapter cache: {c['resident']} resident "
                  f"({c['resident_bytes'] / 2 ** 20:.2f} / "
                  f"{c['cache_bytes'] / 2 ** 20:.2f} MiB), "
                  f"hit rate {c['hit_rate']:.0%}, "
                  f"h2d {c['h2d_bytes'] / 2 ** 20:.2f} MiB vs "
                  f"d2d {c['d2d_bytes'] / 2 ** 20:.2f} MiB")
    if tracer is not None:
        from repro_torch.obs import write_trace
        p = write_trace(args.trace, tracer, srv.metrics)
        print(f"trace: {len(tracer)} events -> {p}")
    for r in reqs[:3]:
        tag = f" [{r.adapter_id or 'base'}]"
        print(f"  req {r.rid}{tag}: {np.asarray(r.prompt).tolist()} -> "
              f"{r.out}")
    return srv, reqs


def main(argv=None):
    return run(argv)[1]


if __name__ == "__main__":
    main()
