"""LLaMA pretraining configs from the BlockLLM paper (Table 10): 60M/130M/350M.

Matches the GaLore/ReLoRA experimental setup (seq 256, C4).  These are the
paper's own models, used by the paper-table benchmarks; the tokenizer vocab
is 32000 (llama).
"""
from repro_torch.configs.base import ModelConfig, register

LLAMA_60M = register(ModelConfig(
    name="llama-60m", family="dense", num_layers=8, d_model=512,
    num_heads=8, num_kv_heads=8, d_ff=1376, vocab_size=32000))

LLAMA_130M = register(ModelConfig(
    name="llama-130m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=2048, vocab_size=32000))

LLAMA_350M = register(ModelConfig(
    name="llama-350m", family="dense", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=2736, vocab_size=32000))

LLAMA_7B = register(ModelConfig(
    name="llama-7b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=32, d_ff=11008, vocab_size=32000))
