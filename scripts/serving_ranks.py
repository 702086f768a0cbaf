#!/usr/bin/env python3
"""The sharded decode setups across ranks, against the single-device
decode step, on every rank.

    python3 scripts/serving_ranks.py                      # 4 cards
    python3 scripts/serving_ranks.py --device cpu --reduce 8

Starts one process per rank (NCCL on the cards, one card each; gloo on
the CPU), meeting through a ``file://`` rendezvous in a temporary
directory.  Each leg builds ``launch.steps.build_setup`` for a decode
cell on a 4-rank mesh, with random bf16 weights and cache drawn from one
seed on every rank (full width and depth unless ``--reduce``), cuts its
shard, and runs ``--steps`` greedy steps with ``attn_impl="kernel"``
from position S - 8; then every rank runs the same steps with
``model.decode_step`` on the whole arguments on its own device:

- ``gemma3-1b`` at long_500k (1 x 524288) on (1, 4) and on (4, 1): the
  cache's sequence over the model axis, then over the data axis (the
  decode kernel's shard variant and the cross-rank softmax merge);
- ``internlm2-1.8b`` at one 4-rank group's share of decode_32k on
  (2, 2): 128 x 2 / 32 = 8 slots of 32768 rows, batch over the data
  axis and KV heads over the model axis.

Where a leg splits the cache's sequence, the merge is also checked
alone on the first global layer, before the steps: each rank attends
its shard of the layer with ``chip_smoke.peaked_query``'s query (f32;
its scores peak on rows spread over every shard) and
``shard_ctx.softmax_merge`` combines the shards, against one
whole-cache call of the decode op on the rank's whole copy.  The
gathered partials, merged with each shard left out in turn, give what
a merge that lost that shard would read.

Rank 0 prints per leg the largest logit difference (gathered logits
against the single-device step's), the largest difference of the rows
the steps wrote, whether every other row kept its bits, the merge
check's differences, the collective counter, the step times (host clock
around a synchronised call) and the peak memory, and each card's name
and power limit.  It fails unless the logits agree within 0.25 (the
bf16 model: the shards merge f32 outputs, the single-device kernel
rounds o to bf16), the written rows within 0.1 of the largest
(``ROW_RTOL``), every other row bitwise, the merged o and lse within
``chip_smoke.SHARD_RTOL`` of the whole call's largest, and every
merge that leaves a shard out more than ``MERGE_POWER`` times that
bound away.  Over a random cache attention is near uniform and a lost
shard barely moves the logits or the written rows, so the merge check,
not those gates, is the one that sees a wrong merge.  Imports nothing
of the JAX package.
"""
from __future__ import annotations

import json
import sys
import time

import _ranks

sys.path.insert(0, str(_ranks.ROOT))
import chip_smoke  # noqa: E402  (peaked_query, SHARD_RTOL)

# (arch, shape name, batch, cache rows, mesh)
LEGS = (("gemma3-1b", "long_500k", 1, 524288, (1, 4)),
        ("gemma3-1b", "long_500k", 1, 524288, (4, 1)),
        ("internlm2-1.8b", "decode_32k", 8, 32768, (2, 2)))
LOGIT_TOL = 0.25
ROW_RTOL = 0.1      # of the largest |row|: the rows a later layer writes
#                     follow a residual stream that each layer's bf16
#                     rounding moves (partial products summed over the
#                     model axis, f32-merged attention); over 24-26 layers
#                     of random weights that is 2.9-5.0% of the largest
#                     row on four cards.  A row no rank writes, or one
#                     written after a merge that lost a shard, read 182%
#                     and 150% (4 gloo ranks at --reduce 8)
MERGE_POWER = 100   # a merge that lost a shard must read this many bounds
#                     away from the whole call, or the check is blind


def _merge_check(torch, setup, cfg, cache, given, pos, dev):
    """The cross-rank softmax merge of the first global layer alone (the
    module docstring); None where its sequence is not split (or its
    batch or heads are)."""
    from repro_torch.configs.base import BLOCK_GLOBAL_ATTN
    from repro_torch.kernels import ops
    from repro_torch.runtime import shard_ctx
    rules = setup.rules
    si, j = next((si, j) for si, (pattern, _) in enumerate(cfg.stages())
                 for j, btype in enumerate(pattern)
                 if btype == BLOCK_GLOBAL_ATTN)
    spec = rules.cache_specs["stages"][si][f"pos{j}"]["k"]
    seq = rules.split_axes(spec[2])
    if not seq or rules.split_axes(spec[1]) or rules.split_axes(spec[3]):
        return None
    k, v = (cache["stages"][si][f"pos{j}"][n][0] for n in ("k", "v"))
    lk, lv = (given["stages"][si][f"pos{j}"][n][0] for n in ("k", "v"))
    B, C, _, hd = k.shape
    H = cfg.num_heads
    pos_b = torch.full((B,), pos, dtype=torch.int32, device=dev)
    q = chip_smoke.peaked_query(torch, k, pos_b, H)
    with shard_ctx.use(rules):
        o, lse = ops.decode_attention(q, lk, lv, pos_b,
                                      offset=rules.coord(seq) * lk.shape[1],
                                      total=C, return_lse=True)
        merged, mlse = shard_ctx.softmax_merge(o, lse, seq)
        parts = shard_ctx.all_gather(torch.cat(
            [o.reshape(B, H, hd), lse[..., None]], -1)[None].contiguous(),
            seq, "check/all_gather")
    whole, wlse = ops.decode_attention(q, k, v, pos_b, offset=0, total=C,
                                       return_lse=True)
    n = parts.shape[0]
    bound = chip_smoke.SHARD_RTOL * float(whole.abs().max())
    lost = []
    for r in range(n):
        rest = parts[[i for i in range(n) if i != r]]
        om, _ = shard_ctx.merge_softmax(rest[..., :hd], rest[..., hd])
        lost.append(float((om.reshape(whole.shape) - whole).abs().max()))
    return {"layer": f"stages.{si}.pos{j}", "shards": n,
            "merged_diff": float((merged - whole).abs().max()),
            "lse_diff": float((mlse - wlse).abs().max()),
            "bound": bound,
            "lse_bound": chip_smoke.SHARD_RTOL * float(wlse.abs().max()),
            "lost_shard_diffs": lost,
            "ok": bool(float((merged - whole).abs().max()) <= bound
                       and float((mlse - wlse).abs().max())
                       <= chip_smoke.SHARD_RTOL * float(wlse.abs().max())
                       and min(lost) > MERGE_POWER * bound)}


def _leg(torch, args, dev, arch, shape_name, B, S, mesh_shape):
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import model
    from repro_torch.runtime import shard_ctx
    cfg = get_config(arch)
    if args.reduce:
        cfg = reduce_config(cfg, args.reduce)
        S = min(S, 2048)
    mesh = mesh_lib.make_host_mesh(mesh_shape[1], device_type=args.device)
    setup = steps.build_setup(cfg, ShapeConfig(shape_name, S, B, "decode"),
                              mesh, attn_impl="kernel")
    g = torch.Generator(dev).manual_seed(17)
    params = model.init_params(cfg, generator=g, device=dev,
                               dtype=torch.bfloat16)
    cache = model.init_cache(cfg, B, S, torch.bfloat16, device=dev)
    for t in _flatten_with_names(cache)[1]:
        for row in t:
            row.copy_(torch.randn(row.shape, generator=g, device=dev)
                      .to(row.dtype))
    token = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device=dev,
                          dtype=torch.int32)
    p0 = S - 8
    given = setup.shard((None, cache))[1]
    with torch.no_grad():
        merge = _merge_check(torch, setup, cfg, cache, given, p0, dev)
    local = list(setup.shard((params, cache, token,
                              torch.tensor(p0, dtype=torch.int32,
                                           device=dev))))
    shard_ctx.reset_collectives()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    fed, logits, step_ms = [token], [], []
    for i in range(args.steps):
        local[2] = steps.local_slice(fed[-1], setup.in_shardings[2],
                                     setup.rules).contiguous()
        local[3] = torch.tensor(p0 + i, dtype=torch.int32, device=dev)
        t0 = time.monotonic()
        out, local[1] = setup(*local)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ms.append((time.monotonic() - t0) * 1e3)
        full_logits = setup.gather((out, None))[0]
        logits.append(full_logits)
        fed.append(full_logits.argmax(-1)[:, None].int())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counts = {k: list(v) for k, v in shard_ctx.COLLECTIVES.items()}
    with torch.no_grad():
        ref = [model.decode_step(params, cfg, cache, fed[i], p0 + i,
                                 attn_impl="kernel")[0]
               for i in range(args.steps)]
    want = setup.shard((None, cache))[1]
    ldiff = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(logits, ref))
    rdiff, kept = 0.0, True
    for got, w, before in zip(*(_flatten_with_names(t)[1]
                                for t in (local[1], want, given))):
        changed = (w != before).any(dim=tuple(
            d for d in range(w.dim()) if d != 2))
        kept &= torch.equal(got[:, :, ~changed], w[:, :, ~changed])
        if changed.any():
            scale = float(w[:, :, changed].float().abs().max())
            rdiff = max(rdiff, float((got[:, :, changed].float()
                                      - w[:, :, changed].float()).abs().max())
                        / max(scale, 1e-30))
    return {"arch": arch, "shape": shape_name, "batch": B, "rows": S,
            "mesh": list(mesh_shape), "max_logit_diff": ldiff,
            "written_rows_rel_diff": rdiff, "other_rows_bitwise": bool(kept),
            "merge_check": merge, "collectives": counts,
            "step_ms_host": [round(x, 3) for x in step_ms],
            "peak_gib": peak / 2 ** 30}


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist
    rank, world, dev = _ranks.start_rank(args, "decode_attention")
    out = []
    try:
        for leg in LEGS:
            out.append(_leg(torch, args, dev, *leg))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            dist.barrier()
        # every rank's written-row reading (only the ranks holding a
        # written row see one) for rank 0's report
        mine = torch.tensor([[r["written_rows_rel_diff"],
                              float(r["other_rows_bitwise"])] for r in out],
                            dtype=torch.float64, device=dev)
        every = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(every, mine)
        for i, r in enumerate(out):
            r["written_rows_rel_diff_by_rank"] = [float(t[i, 0])
                                                  for t in every]
            r["other_rows_bitwise_every_rank"] = all(bool(t[i, 1])
                                                     for t in every)
    finally:
        dist.destroy_process_group()
    bad = [r for r in out if not (r["max_logit_diff"] <= LOGIT_TOL
                                  and r["written_rows_rel_diff"] <= ROW_RTOL
                                  and r["other_rows_bitwise"]
                                  and (r["merge_check"] is None
                                       or r["merge_check"]["ok"]))]
    if rank == 0:
        for r in out:
            print(json.dumps(r), flush=True)
    if bad:
        print(f"rank {rank}: the sharded decode differs from the "
              f"single-device step: {bad}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = _ranks.parser()
    ap.add_argument("--reduce", type=int, default=0)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    if _ranks.is_rank():
        return rank_main(args)
    n = 4
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < n:
            print(f"serving_ranks: needs {n} cards", file=sys.stderr)
            return 2
    return _ranks.launch(__file__, n, argv or sys.argv[1:], args.timeout)

if __name__ == "__main__":
    sys.exit(main())
