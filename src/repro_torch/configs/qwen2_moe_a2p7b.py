"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

60 routed experts top-4 + shared expert; GQA with kv=16 (MHA-equal here).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,            # routed-expert intermediate
    vocab_size=151936,
    num_experts=60,
    num_experts_per_tok=4,
    moe_d_ff=1408,
    shared_expert_d_ff=5632,  # 4 shared experts fused (4 x 1408)
    rope_theta=1000000.0,
))
