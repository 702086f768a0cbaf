#!/usr/bin/env python3
"""Do a prompt's K/V rows depend on how it is primed?  On one card.

    python3 scripts/prefill_rows_probe.py [--arch internlm2-1.8b]

At the full width and depth of ``--arch`` (random weights from a seed,
bf16 compute, the decode-attention kernel), 8 slots, max_seq 64, primes
slot 0's 3-token prompt through ``model.prefill_into_slots`` with the
other 7 slots holding 6-token prompts, and compares slot 0's K/V rows
(every layer, bit for bit):

1. chunks of 4, 8 and 64 positions (the widths a bucketing server gives
   a 3-token prompt admitted alone, beside a 6-token one, and the fixed
   grid of ``prefill_chunk=64``), each against the 64-wide chunk;
2. 6 more tokens written by 6 decode steps against the same 9 tokens
   primed in one 64-wide chunk (what a failover replay does when it
   primes its streamed tokens in a chunk).

Prints ``equal`` / ``differ`` per comparison and the largest bf16 row
difference.  Needs one card; imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("prefill_rows_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    params = model_lib.init_params(
        cfg, generator=torch.Generator("cuda").manual_seed(23),
        device="cuda")
    rng = np.random.default_rng(5)
    slots, seq = 8, 64
    prompts = [rng.integers(0, cfg.vocab_size, 3 if s == 0 else 6)
               for s in range(slots)]
    streamed = rng.integers(0, cfg.vocab_size, 6)

    def rows(cache, lo, hi):
        return [t[:, 0, lo:hi].clone()
                for t in _flatten_with_names(cache)[1]]

    def prime(k, first=None):
        """Slot 0's prompt (or ``first``) and the others' in ``k``-wide
        chunks; returns the cache."""
        ps = list(prompts)
        if first is not None:
            ps[0] = first
        lengths = np.asarray([len(p) for p in ps], np.int32)
        cache = model_lib.init_cache(cfg, slots, seq, device="cuda")
        for start in range(0, int(lengths.max()), k):
            toks = np.zeros((slots, k), np.int32)
            for s, p in enumerate(ps):
                seg = p[start:start + k]
                toks[s, :len(seg)] = seg
            model_lib.prefill_into_slots(
                params, cfg, cache, torch.as_tensor(toks, device="cuda"),
                lengths, chunk_start=start, attn_impl="kernel")
        return cache

    def report(name, a, b):
        same = all(torch.equal(x.view(torch.int16), y.view(torch.int16))
                   for x, y in zip(a, b))
        worst = max(float((x.float() - y.float()).abs().max())
                    for x, y in zip(a, b))
        print(f"{name}: {'equal' if same else 'differ'} (largest row "
              f"difference {worst:.6g}) ({card})")

    with torch.no_grad():
        ref = rows(prime(64), 0, 3)
        for k in (4, 8, 64):
            report(f"3-token prompt rows, chunk {k} vs chunk 64",
                   rows(prime(k), 0, 3), ref)
        decoded = prime(64)
        tok = np.zeros((slots, 1), np.int32)
        pos = np.zeros(slots, np.int32)
        act = np.zeros(slots, bool)
        act[0] = True
        for i, t in enumerate(streamed):
            tok[0, 0], pos[0] = t, 3 + i
            model_lib.decode_step(
                params, cfg, decoded, torch.as_tensor(tok, device="cuda"),
                torch.as_tensor(pos, device="cuda"), attn_impl="kernel",
                active=torch.as_tensor(act, device="cuda"))
        chunked = prime(64, first=np.concatenate([prompts[0], streamed]))
        report("6 streamed tokens' rows, decode steps vs one chunk",
               rows(decoded, 3, 9), rows(chunked, 3, 9))
        report("the prompt's rows under them",
               rows(decoded, 0, 3), rows(chunked, 0, 3))
    return 0


if __name__ == "__main__":
    sys.exit(main())
