"""Meta-device stand-ins for every model input (counterpart of
``repro.launch.specs``): shapes and dtypes, no storage, no draws —
the ``meta`` device is the port's ``jax.eval_shape``.

``concrete_batch`` draws a real batch of the same shapes from an
explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import model as model_lib

META = torch.device("meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                dtype=torch.bfloat16):
    """The batch of a (arch, shape) cell as meta tensors."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = _meta(
                (B, cfg.num_patches, cfg.vision_embed_dim), dtype)
        if cfg.is_encoder_decoder:
            batch["frames"] = _meta(
                (B, cfg.encoder_seq_len, cfg.encoder_feature_dim), dtype)
        return batch
    return {"token": _meta((B, 1), torch.int32),
            "pos": _meta((), torch.int32)}


def params_abstract(cfg: ModelConfig, dtype=torch.bfloat16):
    """``model.init_params`` on the meta device (shapes, no draws)."""
    return model_lib.init_params(cfg, device=META, dtype=dtype)


def cache_specs_abstract(cfg: ModelConfig, shape: ShapeConfig,
                         dtype=torch.bfloat16):
    return model_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                dtype, device=META)


def concrete_batch(cfg: ModelConfig, shape_or_specs,
                   generator: Optional[torch.Generator] = None,
                   dtype=torch.bfloat16, device=None):
    """A random batch matching ``input_specs``: tokens uniform below
    ``min(vocab, 32768)``, the rest standard normal; keys drawn in sorted
    order from ``generator`` (seed 0 on ``device`` without one)."""
    specs = (shape_or_specs if isinstance(shape_or_specs, dict)
             else input_specs(cfg, shape_or_specs, dtype=dtype))
    dev = model_lib.resolve_device(device)
    gen = generator or torch.Generator(dev).manual_seed(0)
    out = {}
    for k, v in sorted(specs.items()):
        if v.dtype in (torch.int32, torch.int64):
            out[k] = torch.randint(0, min(cfg.vocab_size, 32768),
                                   tuple(v.shape), generator=gen,
                                   device=dev, dtype=v.dtype)
        else:
            out[k] = torch.randn(tuple(v.shape), generator=gen, device=dev,
                                 dtype=torch.float32).to(v.dtype)
    return out
