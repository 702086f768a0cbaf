"""BAdam baseline as a ``TrainerCore`` (Luo et al., 2024; counterpart of
``repro.trainers.badam``).

Block-coordinate Adam: cycles through parameter blocks (one layer row
at a time) in a fixed order, switching every K steps, with no gradient
scoring, masks or probes: ``BlockLLMCore`` with the ``cyclic`` selector,
the relationship the paper draws (BlockLLM = BAdam + informed selection
+ masks + an adaptive trigger).  With no masks every step is an update
step, so on the card each one runs the masked-Adam kernels with no mask
(``fused_update="kernel"``, as ``make_blockllm`` chooses there).
"""
from __future__ import annotations

from repro_torch.core.blockllm import BlockLLMConfig
from repro_torch.core.selection import SelectorConfig
from repro_torch.models import model as model_lib
from repro_torch.optim.adam import Adam
from repro_torch.trainers.blockllm import BlockLLMCore
from repro_torch.trainers.registry import register


def badam_config(switch_every: int = 100, block_rows: int = 1,
                 train_embeddings: bool = False,
                 fused_update: str = "off") -> BlockLLMConfig:
    leaves = ("embed", "head") if train_embeddings else ()
    return BlockLLMConfig(
        selector=SelectorConfig(
            policy="cyclic",
            cyclic_block_rows=block_rows,
            reselect_every=switch_every,
            probe_rows_per_stack=0,
            use_visit_frequency=False,
            mask_updates=False,
            always_active_leaves=("final_norm",) + leaves,
            selectable_leaves=(),
        ),
        mask_refresh="never",
        fused_update=fused_update,
    )


class BAdamCore(BlockLLMCore):
    name = "badam"

    def __init__(self, cfg, *, switch_every=100, block_rows=1,
                 train_embeddings=False, adam=None, loss_fn=None,
                 attn_impl="full", bcfg=None, quantize_state=False,
                 device=None):
        device = model_lib.resolve_device(device)
        if bcfg is None:
            fused = "kernel" if device.type == "cuda" else "off"
            bcfg = badam_config(switch_every, block_rows, train_embeddings,
                                fused_update=fused)
        super().__init__(cfg, bcfg=bcfg, adam=adam or Adam(lr=1e-3),
                         loss_fn=loss_fn, attn_impl=attn_impl,
                         quantize_state=quantize_state, device=device)


@register("badam")
def make_badam(cfg, *, switch_every=100, block_rows=1,
               train_embeddings=False, adam=None, loss_fn=None,
               attn_impl="full", quantize_state=False, bcfg=None,
               device=None, **_) -> BAdamCore:
    return BAdamCore(cfg, switch_every=switch_every, block_rows=block_rows,
                     train_embeddings=train_embeddings, adam=adam,
                     loss_fn=loss_fn, attn_impl=attn_impl, bcfg=bcfg,
                     quantize_state=quantize_state, device=device)


@register("badam+q8")
def make_badam_q8(cfg, **kw) -> BAdamCore:
    """BAdam with Q8State moments (int8 + block scales)."""
    kw["quantize_state"] = True
    return make_badam(cfg, **kw)
