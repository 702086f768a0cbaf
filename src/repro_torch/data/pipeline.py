"""Deterministic, shardable synthetic token pipeline (a copy of the JAX
package's pipeline: numpy, so its batches are bit-identical to the JAX
package's for the same seed; they come back as int32 CPU tensors, which
the trainer moves to its device).

Production layout: every host materializes ONLY its shard of the global
batch (``host_slice``), indexed by (step, host) — restart-safe (the stream
is a pure function of the step, so resuming at step N reproduces the exact
batch), elastic-safe (re-slicing for a different host count changes
nothing about the underlying global stream).

Two sources:
- ``synthetic``  — hash-mixed token stream with local n-gram structure so
  models actually learn (loss decreases measurably within tens of steps);
  used by benchmarks/examples (the C4/Alpaca stand-in).
- ``file``       — byte-level tokenization of a local text file, packed
  into fixed-length sequences (no external downloads).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"      # synthetic | file
    path: Optional[str] = None
    structure: int = 64            # n-gram determinism (learnability)


def _rng_for(cfg: DataConfig, step: int, row: int) -> np.random.Generator:
    h = hashlib.blake2b(
        f"{cfg.seed}:{step}:{row}".encode(), digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(h, "little"))


def _synthetic_row(cfg: DataConfig, step: int, row: int) -> np.ndarray:
    """Markov-ish stream: next token = f(prev token, theme) mostly."""
    rng = _rng_for(cfg, step, row)
    theme = rng.integers(0, cfg.structure)
    toks = np.empty(cfg.seq_len, np.int32)
    toks[0] = rng.integers(0, cfg.vocab_size)
    noise = rng.random(cfg.seq_len)
    rand = rng.integers(0, cfg.vocab_size, cfg.seq_len)
    for t in range(1, cfg.seq_len):
        if noise[t] < 0.15:
            toks[t] = rand[t]
        else:  # deterministic successor given (prev, theme)
            toks[t] = (toks[t - 1] * 31 + theme * 7 + 13) % cfg.vocab_size
    return toks


class TokenPipeline:
    def __init__(self, cfg: DataConfig, *, host_id: int = 0,
                 num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0, \
            "global batch must divide across hosts"
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self._file_tokens: Optional[np.ndarray] = None
        if cfg.source == "file":
            with open(cfg.path, "rb") as f:
                raw = f.read()
            self._file_tokens = np.frombuffer(raw, np.uint8).astype(np.int32)

    def global_rows(self, step: int):
        return range(self.cfg.global_batch)

    def host_rows(self, step: int):
        lo = self.host_id * self.local_batch
        return range(lo, lo + self.local_batch)

    def _row(self, step: int, row: int) -> np.ndarray:
        if self._file_tokens is not None:
            n = len(self._file_tokens) - self.cfg.seq_len - 1
            off = int(_rng_for(self.cfg, step, row).integers(0, max(n, 1)))
            return self._file_tokens[off:off + self.cfg.seq_len].copy()
        return _synthetic_row(self.cfg, step, row)

    def batch(self, step: int) -> dict:
        """Host-local batch for ``step`` -> {"tokens": [local_B, S]}."""
        rows = [self._row(step, r) for r in self.host_rows(step)]
        return {"tokens": torch.from_numpy(np.stack(rows))}

    def global_batch_all_hosts(self, step: int) -> dict:
        rows = [self._row(step, r) for r in self.global_rows(step)]
        return {"tokens": torch.from_numpy(np.stack(rows))}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
