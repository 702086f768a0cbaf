#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 29 (distributed BlockLLM training over NCCL)
alone on one card.

    python3 scripts/distributed_probe.py [--profile ROUNDS]

Builds the masked-Adam kernels from the checkout at first use, then runs
``chip_smoke.distributed_train`` with every gate of the script: the
distributed step of ``internlm2-1.8b`` at full width and depth at world
size 1 bitwise the single-device step, the masked-Adam launches the plan
gives, the int8 error-feedback all-reduce's gates, and the collective
counter.  With ``--profile``, it then times the distributed step and the
core's single-device raw step alternately for ROUNDS rounds after one
warm-up each (CUDA events and the host clock), profiles one step of each
with ``torch.profiler``, and prints the ops whose device time differs
most between the two; the tables go to ``chiprun_out/``.  Needs one
card; imports nothing of the JAX package.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _device_ms(prof):
    """Per kernel (and device copy) name: device milliseconds of one
    profiled step; the host ops that launched them are left out, so the
    sum is the device's busy time."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t:
            out[e.key] = out.get(e.key, 0.0) + t / 1e3
    return out


def profile_steps(torch, np, card, rounds):
    """The distributed step against the single-device raw step of the same
    core, alternated, then one profiled step of each."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    out_dir = chip_smoke.OUT
    out_dir.mkdir(exist_ok=True)
    with chip_smoke.world_of_one():
        setup, core, state, batches, full, local = \
            chip_smoke.distributed_setup(torch)
        fn = core.lowerable(state, batches[0]).fn
        single = list(full)

        def dist_step(b):
            local[7] = setup.shard((None,) * 7 + (b,))[7]
            sel, opt, masks, loss, _, _ = setup(*local)
            local[1], local[5], local[6] = sel, opt, masks

        def single_step(b):
            single[7] = b
            sel, opt, masks, loss, _, _ = fn(*single)
            single[1], single[5], single[6] = sel, opt, masks

        times = {"distributed": ([], []), "single-device": ([], [])}
        for r in range(rounds + 1):
            for name, step in (("distributed", dist_step),
                               ("single-device", single_step)):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda.synchronize()
                h0 = time.monotonic()
                ev[0].record()
                step(batches[r % 3])
                ev[1].record()
                torch.cuda.synchronize()
                if r:                        # round 0 is the warm-up
                    times[name][0].append((time.monotonic() - h0) * 1e3)
                    times[name][1].append(ev[0].elapsed_time(ev[1]))
        for name, (host, dev) in times.items():
            print(f"profile: {name} step, {rounds} rounds after a warm-up, "
                  f"ms host {[round(x, 1) for x in host]} (p50 "
                  f"{np.percentile(host, 50):.1f}), CUDA events "
                  f"{[round(x, 1) for x in dev]} (p50 "
                  f"{np.percentile(dev, 50):.1f}) ({card})")
        per_op = {}
        for name, step in (("distributed", dist_step),
                           ("single-device", single_step)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(batches[0])
                torch.cuda.synchronize()
            per_op[name] = _device_ms(prof)
            table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                              row_limit=40)
            (out_dir / f"profile_{name}.txt").write_text(table)
            print(f"profile: {name} step, device busy "
                  f"{sum(per_op[name].values()):.2f} ms")
        d, s_ = per_op["distributed"], per_op["single-device"]
        diff = sorted(((d.get(k, 0.0) - s_.get(k, 0.0), k)
                       for k in set(d) | set(s_)), key=lambda x: -abs(x[0]))
        print("profile: device ms, distributed - single-device, by kernel: "
              + "; ".join(f"{k[:90]} {v:+.3f} ({d.get(k, 0.0):.3f} vs "
                          f"{s_.get(k, 0.0):.3f})" for v, k in diff[:8]))
        del setup, core, state, full, local, single


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("distributed_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from repro_torch.kernels import ops
    card = chip_smoke.smi()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.monotonic()
    launches = chip_smoke.distributed_train(torch, np, ops, card)
    print(f"distributed_probe: masked_adam launches {launches}, "
          f"{time.monotonic() - t0:.1f} s with the kernel build ({card})")
    if "--profile" in sys.argv:
        rounds = int(sys.argv[sys.argv.index("--profile") + 1])
        profile_steps(torch, np, card, rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
