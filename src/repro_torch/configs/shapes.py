"""Assigned input-shape sets (a copy of ``repro.configs.shapes``).

Every LM-family architecture is paired with all four shapes.  ``decode_*`` /
``long_*`` are one new token against a KV cache of ``seq_len``;
``prefill_*`` is the prefill forward; ``train_*`` the train step
(``launch.steps.build_setup`` dispatches on ``kind``).

``long_500k`` requires sub-quadratic attention: it runs only for the
archs in ``LONG_CONTEXT_ARCHS`` (SSM / hybrid / local-attention
families).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# Archs with a sub-quadratic path for 500k-token decode.
LONG_CONTEXT_ARCHS = {"gemma3-1b", "recurrentgemma-2b", "xlstm-1.3b"}


def shape_applicable(arch_name: str, shape: ShapeConfig, cfg=None) -> bool:
    if shape.name == "long_500k":
        return arch_name in LONG_CONTEXT_ARCHS
    return True


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
