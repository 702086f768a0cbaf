"""Whisper large-v3 [arXiv:2212.04356].

Encoder-decoder transformer backbone.  The conv/mel frontend is a STUB:
``input_specs`` provides precomputed frame embeddings [B, 1500, 1280]; a
learned linear maps them into the encoder.  LM shapes apply to the DECODER
sequence with the fixed 1500-frame encoder context (mechanical extension far
beyond Whisper's 448-token practical decode ceiling — see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp_type="gelu_mlp",
    norm_eps=1e-5,
    is_encoder_decoder=True,
    num_encoder_layers=32,
    encoder_seq_len=1500,
    encoder_feature_dim=1280,
    rope_theta=0.0,  # learned/sinusoidal positions; we use rope_theta=0 -> absolute
))
