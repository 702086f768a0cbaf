"""Model / run configuration system.

A single frozen ``ModelConfig`` dataclass describes every assigned
architecture; the model zoo (``repro_torch.models.model``) assembles the network
from it.  Architectures register themselves into ``REGISTRY`` (one module per
arch under ``repro_torch/configs/``) and are selected by ``--arch <id>``.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from dataclasses import dataclass, field
from typing import Optional

# Block types a layer can have.  ``pattern`` in the config cycles over the
# layer stack (e.g. gemma3: 5 local + 1 global; recurrentgemma: rec,rec,attn).
BLOCK_GLOBAL_ATTN = "global"
BLOCK_LOCAL_ATTN = "local"
BLOCK_RECURRENT = "recurrent"  # RG-LRU
BLOCK_MLSTM = "mlstm"
BLOCK_SLSTM = "slstm"
VALID_BLOCKS = {
    BLOCK_GLOBAL_ATTN,
    BLOCK_LOCAL_ATTN,
    BLOCK_RECURRENT,
    BLOCK_MLSTM,
    BLOCK_SLSTM,
}


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture description (frozen => hashable => jit-friendly)."""

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # Block pattern, cycled over the decoder stack.
    pattern: tuple = (BLOCK_GLOBAL_ATTN,)
    window_size: int = 0  # for local attention blocks

    # MLP
    mlp_type: str = "swiglu"  # swiglu | geglu | none
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # Recurrent (RG-LRU)
    lru_width: int = 0
    conv1d_width: int = 4

    # Encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0  # fixed audio frame count (post-conv), stub
    encoder_feature_dim: int = 0  # stubbed frontend feature width

    # VLM (pixtral): the vision tower is a stub; ``input_specs`` provides
    # precomputed patch embeddings of this width which we project in.
    vision_embed_dim: int = 0
    num_patches: int = 0

    # Numerics
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True

    def __post_init__(self):
        for b in self.pattern:
            assert b in VALID_BLOCKS, f"unknown block type {b}"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def layer_types(self) -> tuple:
        """Per-layer block type, cycling ``pattern`` over ``num_layers``."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def stages(self):
        """Partition the stack into scan stages.

        Returns a list of (pattern, n_groups): full repetitions of the cyclic
        pattern are scanned together; a trailing remainder (a prefix of the
        pattern) forms a second stage.  Each stage's params are stacked
        ``[n_groups, ...]`` per pattern position.
        """
        p, L = self.pattern, self.num_layers
        full, rem = divmod(L, len(p))
        out = []
        if full:
            out.append((tuple(p), full))
        if rem:
            out.append((tuple(p[:rem]), 1))
        return out

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter counts (used by memory accounting + tests) ----
    def param_count(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        H, KV = self.num_heads, self.num_kv_heads
        n = 0
        # embeddings (+ untied head)
        n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_layer = {}
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d  # q,k,v,o
        if self.mlp_type in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        elif self.mlp_type == "none":
            mlp = 0
        else:
            mlp = 2 * d * self.d_ff
        moe = 0
        if self.num_experts:
            moe = self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts
            if self.shared_expert_d_ff:
                moe += 3 * d * self.shared_expert_d_ff
            mlp = 0
        rec = 0
        if BLOCK_RECURRENT in self.pattern:
            w = self.lru_width or d
            rec = 2 * d * w + w * d + 2 * w * w + self.conv1d_width * w + 2 * w
        mlstm = 4 * d * (2 * d) + 2 * d * d  # up/down proj + qkv-ish, approx
        for i, t in enumerate(self.layer_types()):
            if t in (BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN):
                n += attn + (moe if self.num_experts else mlp) + 2 * d
            elif t == BLOCK_RECURRENT:
                n += rec + mlp + 2 * d
            elif t in (BLOCK_MLSTM, BLOCK_SLSTM):
                n += mlstm + 2 * d
        if self.is_encoder_decoder:
            # encoder stack + cross attention in decoder
            n += self.num_encoder_layers * (attn + mlp + 2 * d)
            n += self.num_layers * (attn + d)  # cross-attn per decoder layer
            n += (self.encoder_feature_dim or d) * d  # frontend stub proj
        if self.vision_embed_dim:
            n += self.vision_embed_dim * d
        return n


REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


_ARCH_MODULES = [
    "qwen2_moe_a2p7b",
    "granite_moe_3b_a800m",
    "deepseek_7b",
    "internlm2_1p8b",
    "gemma3_1b",
    "gemma_2b",
    "pixtral_12b",
    "recurrentgemma_2b",
    "xlstm_1p3b",
    "whisper_large_v3",
    "llama_pretrain",  # paper's own pretraining configs (60M/130M/350M)
]


def load_all():
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    return REGISTRY


def get_config(name: str) -> ModelConfig:
    if not REGISTRY:
        load_all()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduce_config(cfg: ModelConfig, factor: int = 4) -> ModelConfig:
    """Scale an assigned arch down for CPU execution, same family/blocks.

    A copy of ``repro.launch.train.reduce_config`` (identical shapes, so
    the port and the JAX package build the same reduced architecture).
    """
    pat_len = len(cfg.pattern)
    layers = max(pat_len, (cfg.num_layers // factor) // pat_len * pat_len)
    heads = max(1, cfg.num_heads // factor)
    kv = max(1, min(cfg.num_kv_heads, heads))
    return cfg.replace(
        num_layers=layers,
        d_model=max(32, cfg.d_model // factor),
        num_heads=heads, num_kv_heads=kv,
        head_dim=max(8, cfg.resolved_head_dim // factor),
        d_ff=max(32, cfg.d_ff // factor) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 2048),
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        moe_d_ff=max(16, cfg.moe_d_ff // factor) if cfg.moe_d_ff else 0,
        shared_expert_d_ff=(max(16, cfg.shared_expert_d_ff // factor)
                            if cfg.shared_expert_d_ff else 0),
        lru_width=max(32, cfg.lru_width // factor) if cfg.lru_width else 0,
        window_size=min(cfg.window_size, 64) if cfg.window_size else 0,
        num_encoder_layers=(max(1, cfg.num_encoder_layers // factor)
                            if cfg.num_encoder_layers else 0),
        encoder_seq_len=(min(cfg.encoder_seq_len, 64)
                         if cfg.encoder_seq_len else 0),
        encoder_feature_dim=(min(cfg.encoder_feature_dim, 80)
                             if cfg.encoder_feature_dim else 0),
        vision_embed_dim=(min(cfg.vision_embed_dim, 64)
                          if cfg.vision_embed_dim else 0),
        num_patches=min(cfg.num_patches, 8) if cfg.num_patches else 0,
        remat=False,
    )
