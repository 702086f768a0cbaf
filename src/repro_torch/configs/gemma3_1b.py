"""Gemma-3 1B [hf:google/gemma-3-1b-pt].

5:1 local(512-window):global pattern, MQA (kv=1), head_dim=256, 262k vocab.
"""
from repro_torch.configs.base import (
    BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN, ModelConfig, register)

CONFIG = register(ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    pattern=(BLOCK_LOCAL_ATTN,) * 5 + (BLOCK_GLOBAL_ATTN,),
    window_size=512,
    mlp_type="geglu",
    rope_theta=1000000.0,
    tie_embeddings=True,
))
