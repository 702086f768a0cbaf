"""xLSTM-1.3B [arXiv:2405.04517].

48 blocks, 7:1 mLSTM:sLSTM, 4 heads, no FFN (d_ff=0; mLSTM blocks carry a
2x up-projection internally).
"""
from repro_torch.configs.base import BLOCK_MLSTM, BLOCK_SLSTM, ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    mlp_type="none",
    vocab_size=50304,
    pattern=(BLOCK_MLSTM,) * 7 + (BLOCK_SLSTM,),
))
