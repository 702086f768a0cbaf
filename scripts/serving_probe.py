#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 30 (the sharded serving setups) alone on
one card.

    python3 scripts/serving_probe.py

Builds the kernels from the checkout, then runs
``chip_smoke.sharded_serving`` with every gate of the script: (a) the
decode kernel's shard variant at gemma3-1b's global shape against one
whole-cache call and its plain version, with its times beside the bound
and SDPA; (b) the decode setups of gemma3-1b (long_500k) and
internlm2-1.8b (one data rank's share of decode_32k) at world size 1
over NCCL, bitwise the single-device step; (c) gemma3-1b's prefill
setup, bitwise the single-device prefill.  Prints the phase's time and
the decode kernel's numbers.  Needs one card; imports nothing of the JAX
package.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serving_probe: no CUDA device", file=sys.stderr)
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
    results = {"decode_attention": {}}
    launches = chip_smoke.sharded_serving(torch, np, ops, da, results, card)
    print(f"phase 30 decode_attention launches {launches}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
