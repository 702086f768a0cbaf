"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427].

Pattern (recurrent, recurrent, local-attn) — 1 attention per 2 RG-LRU
blocks; MQA local attention with 2048 window, GeGLU MLP, lru_width=2560.
"""
from repro_torch.configs.base import (
    BLOCK_LOCAL_ATTN, BLOCK_RECURRENT, ModelConfig, register)

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=(BLOCK_RECURRENT, BLOCK_RECURRENT, BLOCK_LOCAL_ATTN),
    window_size=2048,
    mlp_type="geglu",
    lru_width=2560,
    tie_embeddings=True,
))
