#!/usr/bin/env python3
"""The distributed BlockLLM step across ranks, against the single-device
step, on every rank.

    python3 scripts/distributed_ranks.py                  # all cards
    python3 scripts/distributed_ranks.py --device cpu --ranks 4 --reduce 8

Starts one process per rank (NCCL on the cards, one card each; gloo on
the CPU), meeting through a ``file://`` rendezvous in a temporary
directory.  On a ``(ranks / 2, 2)`` mesh (data x model: Megatron tensor
parallelism with ZeRO over the data axis) and a ``(ranks, 1)`` mesh
(pure data parallelism with ZeRO), each rank builds
``launch.steps.build_train_setup`` for ``--arch`` (full width unless
``--reduce``; f32 compute, f32 masters, 8 x 256), runs one step on its
shard, gathers the loss and the updated rows, and runs the same step on
its own device over the whole batch with ``setup.fn`` (no mesh).  Rank 0
prints, per mesh, the loss of both, the largest row difference, the
collective counter, the distributed step's time (host clock around a
synchronised call; the masked-Adam kernel is built before it) and the
peak memory, and each card's name and power limit; it fails unless the
loss agrees within rtol 2e-4 and the rows within atol 3e-4 (the bounds
JAX's own test holds its sharded step to).
Adam's eps is 1e-3, as the port's CPU trajectory tests: at 1e-8 the
first step's ``g / (|g| + eps)`` flips sign on gradients near zero.
Imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import sys
import time

import _ranks


def rank_main(args) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world, dev = _ranks.start_rank(args, "masked_adam")
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.optim.adam import Adam
    from repro_torch.runtime import shard_ctx
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_config(cfg, args.reduce)
    cfg = cfg.replace(dtype="float32")
    shape = ShapeConfig("ranks", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch, seed=0))
    out = []
    try:
        for model_axis in (2, 1):
            mesh = mesh_lib.make_host_mesh(model_axis,
                                           device_type=args.device)
            setup = steps.build_train_setup(
                cfg, shape, mesh, optimizer="blockllm", attn_impl="full",
                param_dtype=torch.float32, device=dev,
                adam=Adam(lr=1e-3, eps=1e-3))
            core = setup.meta["core"]

            def full_args():
                state = core.init(torch.Generator(dev).manual_seed(0))
                batch = core.to_device(pipe.batch(0))
                return list(core.lowerable(state, batch).args)

            local = setup.shard(full_args())
            shard_ctx.reset_collectives()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.monotonic()
            res = setup(*local)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_ms = (time.monotonic() - t0) * 1e3
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
            counts = {k: list(v) for k, v in shard_ctx.COLLECTIVES.items()}
            sel = setup.gather((res[0],) + (None,) * (len(res) - 1))[0]
            loss = float(res[3])
            del local, res
            single = setup.fn(*full_args())
            diff = max(float((a - b).abs().max()) for a, b in zip(
                _flatten_with_names(sel)[1],
                _flatten_with_names(single[0])[1]))
            out.append({"mesh": [world // model_axis, model_axis],
                        "loss": loss, "loss_single": float(single[3]),
                        "max_row_diff": diff, "step_ms_host": step_ms,
                        "peak_gib": peak / 2 ** 30, "collectives": counts})
            del single, setup, core
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()
    bad = [r for r in out
           if not np.isclose(r["loss"], r["loss_single"], rtol=2e-4, atol=0)
           or r["max_row_diff"] > 3e-4]
    if rank == 0:
        for r in out:
            print(json.dumps(r))
    if bad:
        print(f"rank {rank}: the distributed step differs from the "
              f"single-device step: {bad}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = _ranks.parser()
    ap.add_argument("--ranks", type=int, default=0,
                    help="rank processes (default: every card)")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduce", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args(argv)
    if _ranks.is_rank():
        return rank_main(args)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("distributed_ranks: no CUDA device", file=sys.stderr)
            return 2
        n = args.ranks or torch.cuda.device_count()
    else:
        n = args.ranks or 4
    if n % 2:
        print(f"distributed_ranks: {n} ranks do not make a model axis of 2",
              file=sys.stderr)
        return 2
    return _ranks.launch(__file__, n, argv or sys.argv[1:], args.timeout)

if __name__ == "__main__":
    sys.exit(main())
