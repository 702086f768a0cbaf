"""InternLM2-1.8B [arXiv:2403.17297] — dense, GQA kv=8."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
))
