"""IBM Granite-3.0 MoE [hf:ibm-granite/granite-3.0-*-base family].

40 routed experts, top-8, GQA kv=8, per-expert d_ff=512.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    num_experts_per_tok=8,
    moe_d_ff=512,
    tie_embeddings=True,
))
