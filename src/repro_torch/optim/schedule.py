"""Learning-rate schedules (counterpart of ``repro.optim.schedule``).

A schedule maps the optimizer's step count to a float32 learning rate,
computed on the host in numpy float32 (the JAX package computes the same
formula in jnp float32): cosine annealing to 10% of peak with optional
linear warmup, as the paper's pretraining setup uses.
"""
from __future__ import annotations

import numpy as np

_f = np.float32


def _step(step) -> np.float32:
    return _f(int(step)) if not isinstance(step, float) else _f(step)


def constant(lr):
    return lambda step: _f(lr)


def cosine(peak_lr, total_steps, *, warmup_steps=0, final_frac=0.1):
    total_steps = max(total_steps, 1)

    def sched(step):
        step = _step(step)
        warm = _f(peak_lr) * step / _f(max(warmup_steps, 1))
        t = np.clip((step - _f(warmup_steps))
                    / _f(max(total_steps - warmup_steps, 1)), _f(0), _f(1))
        cos = _f(final_frac) + _f(1 - final_frac) * _f(0.5) * (
            _f(1) + np.cos(_f(np.pi) * t))
        return warm if step < warmup_steps else _f(peak_lr) * cos

    return sched


def linear_warmup_rsqrt(peak_lr, warmup_steps=1000):
    def sched(step):
        step = _step(step) + _f(1)
        return _f(peak_lr) * min(step / _f(warmup_steps),
                                 np.sqrt(_f(warmup_steps) / step))

    return sched
