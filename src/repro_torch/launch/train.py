"""Training launcher (counterpart of ``python -m repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch internlm2-1.8b --reduce 0 --optimizer blockllm+q8 \\
        --batch 8 --seq 256 --steps 8

The same flags as the JAX launcher, minus ``--tpu-flags``, plus
``--device`` (default: the CUDA device, raising without a card; ``cpu``
runs on the CPU with every kernel's plain PyTorch version).
``--optimizer`` is a ``repro_torch.trainers`` registry lookup:
``blockllm``, ``blockllm+q8``, ``adam``, ``adam+q8``, and the paper's
baselines ``galore`` (``--rank``), ``lora`` (``--rank``), ``badam`` and
``badam+q8`` (a block switch every ``--patience`` steps).  ``blockllm``,
``badam`` and their ``+q8`` forms on the card run the fused masked-Adam
kernels (f32 and Q8 moments) by default.  ``--reduce
N`` scales the arch down (0 = full width).  Hybrid archs
(``--arch recurrentgemma-2b``) run their RG-LRU scans through the scan
kernel, forward and backward.  An encoder-decoder arch (``--arch
whisper-large-v3``) gets stub frame embeddings ``frames`` [batch,
encoder_seq_len, encoder_feature_dim] ~ N(0, 1) beside each step's
tokens (``frames_for``), as the JAX launcher's ``batch_fn`` draws them;
a VLM (``--arch pixtral-12b``) likewise gets stub patch embeddings
``patch_embeds`` [batch, num_patches, vision_embed_dim] ~ N(0, 1)
(``patch_embeds_for``), which take the first ``num_patches`` positions
(so ``--seq`` must be at least that).  ``--layers N`` cuts the depth to
N layers (0: the config's), for a model whose full depth does not train
on one card.
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


def _step_generator(seed: int, step: int, device):
    """A generator on ``device`` seeded from ``(seed, step)``: a resumed
    run draws at a step what an uninterrupted one drew there.  The pair is
    hashed (``numpy.random.SeedSequence``), so the low 32 bits, all that
    the CPU generator keeps of a seed, depend on both."""
    import numpy as np
    import torch
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device).manual_seed(int(mixed[0]) >> 1)


def frames_for(cfg, batch: int, seed: int, step: int, device):
    """Step ``step``'s stub frame embeddings [batch, encoder_seq_len,
    encoder_feature_dim] ~ N(0, 1), drawn on ``device`` from
    ``_step_generator(seed, step)``."""
    import torch
    return torch.randn(batch, cfg.encoder_seq_len, cfg.encoder_feature_dim,
                       generator=_step_generator(seed, step, device),
                       device=device)


def patch_embeds_for(cfg, batch: int, seed: int, step: int, device):
    """Step ``step``'s stub patch embeddings [batch, num_patches,
    vision_embed_dim] ~ N(0, 1), drawn as ``frames_for`` draws the
    frames."""
    import torch
    return torch.randn(batch, cfg.num_patches, cfg.vision_embed_dim,
                       generator=_step_generator(seed, step, device),
                       device=device)


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
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the "
                         "config's)")
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
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    model_lib.check_supported(cfg)
    trainer = make_trainer(cfg, args, device=device)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch,
                                    seed=args.seed))

    def batch_fn(step):
        b = pipe.batch(step)
        if cfg.family == "vlm":
            b["patch_embeds"] = patch_embeds_for(cfg, args.batch, args.seed,
                                                 step, device)
        if cfg.is_encoder_decoder:
            b["frames"] = frames_for(cfg, args.batch, args.seed, step,
                                     device)
        return b

    tracer, metrics = None, None
    if args.trace or args.metrics_every:
        from repro_torch.obs import MetricsRegistry, Tracer
        metrics = MetricsRegistry()
        if args.trace:
            tracer = Tracer()
    out = run(trainer, batch_fn,
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
