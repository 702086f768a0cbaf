#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 28 (the zoo) alone on one card.

    python3 scripts/zoo_probe.py                          # the whole phase
    python3 scripts/zoo_probe.py --deepseek-layers 15 16 17

Builds the kernels from the checkout, then runs ``chip_smoke.zoo_family``
(the decode kernels at the zoo's shapes; ``gemma3-1b``, ``gemma-2b`` and
``deepseek-7b`` card vs CPU, BlockLLM training through the launcher,
serving at full width and depth) with every gate of the script, and
prints the phase's time and each kernel's numbers.  With
``--deepseek-layers`` it runs only phase 28 (b)'s ``deepseek-7b``
training leg at each depth given and prints each peak (a depth over 70
GiB fails its gate and is reported, and the next depth runs), which is
how ``ZOO_TRAIN_LAYERS`` is chosen.  Needs one card; imports nothing of
the JAX package.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--deepseek-layers", type=int, nargs="*", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("zoo_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as da
    chip_smoke.OUT.mkdir(exist_ok=True)
    card = chip_smoke.smi()
    t0 = time.monotonic()
    build.build_all()
    print(f"{card}; kernel build {time.monotonic() - t0:.1f} s", flush=True)
    if args.deepseek_layers:
        for layers in args.deepseek_layers:
            chip_smoke.ZOO_TRAIN_LAYERS["deepseek-7b"] = layers
            try:
                chip_smoke.zoo_train(torch, np, ops, "deepseek-7b")
            except (AssertionError, torch.OutOfMemoryError) as e:
                print(f"deepseek-7b at {layers} layers: {e}")
            torch.cuda.empty_cache()
        return 0
    results = {"decode_attention": {}, "paged_decode_attention": {}}
    t0 = time.monotonic()
    chip_smoke.zoo_family(torch, np, ops, da, results, card)
    print(f"phase 28: {time.monotonic() - t0:.1f} s")
    for name, r in results.items():
        print(f"{name}: {r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
