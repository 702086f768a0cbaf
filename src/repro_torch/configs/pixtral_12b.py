"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409].

Mistral-NeMo style text backbone; the Pixtral ViT vision tower is a STUB —
``input_specs`` provides precomputed patch embeddings (width 1024) which a
learned projection maps into the token stream (they replace the first
``num_patches`` positions: multimodal packing).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    vision_embed_dim=1024,
    num_patches=256,
    rope_theta=1000000000.0,
))
