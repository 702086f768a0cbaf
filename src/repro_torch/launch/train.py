"""Training launcher (counterpart of ``python -m repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch internlm2-1.8b --reduce 0 --optimizer blockllm+q8 \\
        --batch 8 --seq 256 --steps 8

The same flags as the JAX launcher, minus ``--tpu-flags``, plus
``--device`` (default: the CUDA device, raising without a card; ``cpu``
runs on the CPU with every kernel's plain PyTorch version).
``--optimizer`` is a ``repro_torch.trainers`` registry lookup:
``blockllm``, ``blockllm+q8``, ``adam``, ``adam+q8``; ``galore``,
``lora``, ``badam`` and ``badam+q8`` raise ``NotImplementedError``
(ROADMAP A8).  ``blockllm+q8`` on the card runs the fused Q8 masked-Adam
kernel by default.  ``--reduce N`` scales the arch down (0 = full width).
"""
from __future__ import annotations

import argparse

OPTIMIZERS = ["blockllm", "adam", "galore", "lora", "badam", "blockllm+q8",
              "adam+q8", "badam+q8"]


def make_trainer(cfg, args, params=None, device=None):
    """Registry lookup: ``--optimizer`` -> TrainerCore -> TrainerHandle."""
    import torch
    from repro_torch import trainers
    from repro_torch.optim import schedule
    from repro_torch.optim.adam import Adam

    lr = schedule.cosine(args.lr, args.steps) if args.cosine else args.lr
    adam = Adam(lr=lr, weight_decay=args.weight_decay)
    core = trainers.make(
        args.optimizer, cfg, adam=adam, lr=args.lr,
        sparsity=args.sparsity, patience=args.patience,
        policy=args.policy, k_frac=args.k_frac, rank=args.rank,
        switch_every=args.patience, quantize_state=args.quantize_state,
        device=device)
    gen = torch.Generator(core.device).manual_seed(args.seed)
    return trainers.TrainerHandle(core, core.init(gen, params))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-60m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--optimizer", default="blockllm", choices=OPTIMIZERS)
    ap.add_argument("--quantize-state", action="store_true",
                    help="Q8State: store Adam moments int8 + per-block "
                         "f32 scales (blockllm/adam — equivalent to the "
                         "+q8 registry names)")
    ap.add_argument("--sparsity", type=float, default=0.95)
    ap.add_argument("--patience", type=int, default=100)
    ap.add_argument("--policy", default="static",
                    choices=["static", "greedy"])
    ap.add_argument("--k-frac", type=float, default=0.25)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--cosine", action="store_true")
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduce", type=int, default=0,
                    help="divide model dims by this factor (CPU runs)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a TraceKit trace: .jsonl = event log "
                         "(per-step selection telemetry), else Chrome/"
                         "Perfetto trace JSON")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="dump the metrics registry as text every N "
                         "steps (0 = off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions of the kernels on the CPU)")
    args = ap.parse_args(argv)

    if args.quantize_state and args.optimizer.split("+")[0] not in (
            "blockllm", "adam", "badam"):
        ap.error(f"--quantize-state is not supported by "
                 f"--optimizer {args.optimizer} (Q8State cores: "
                 f"blockllm, adam, badam)")

    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.train_loop import TrainLoopConfig, run

    device = model_lib.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_config(cfg, args.reduce)
    model_lib.check_supported(cfg)
    trainer = make_trainer(cfg, args, device=device)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch,
                                    seed=args.seed))

    tracer, metrics = None, None
    if args.trace or args.metrics_every:
        from repro_torch.obs import MetricsRegistry, Tracer
        metrics = MetricsRegistry()
        if args.trace:
            tracer = Tracer()
    out = run(trainer, pipe.batch,
              TrainLoopConfig(total_steps=args.steps,
                              ckpt_every=args.ckpt_every,
                              ckpt_dir=args.ckpt_dir,
                              metrics_every=args.metrics_every),
              tracer=tracer, metrics=metrics)
    rep = trainer.memory_report()
    print(f"final loss: {out['losses'][-1]:.4f}")
    print("memory report:", {k: f"{v/2**20:.1f}MiB" for k, v in rep.items()})
    if tracer is not None:
        from repro_torch.obs import write_trace
        p = write_trace(args.trace, tracer, metrics)
        print(f"trace: {len(tracer)} events -> {p}")
    out["trainer"] = trainer
    return out


if __name__ == "__main__":
    main()
