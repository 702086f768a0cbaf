"""The MoE island: per-shard capacity dispatch and expert tensor
parallelism (counterpart of ``repro.runtime.moe_parallel``).

- data axes: each data rank routes its own tokens, with the capacity of
  its own token count (GShard semantics): no cross-rank token traffic —
  in the port a rank holds only its batch shard, so this is
  ``moe_apply`` on the local tokens;
- model axis: each expert's hidden dim is column (``w_gate`` /
  ``w_up``) and row (``w_down``) parallel, and one all-reduce over the
  model group combines the routed experts and the shared expert
  (Megatron's pair: f on the tokens, g on the output).

If the expert hidden dims do not divide the model axis, the weights are
replicated and every model rank computes the whole MoE, with no
all-reduce (JAX's fallback).  The aux loss is averaged over the data
group (each rank's gradient is its own term's; the gradient hook takes
the mean).
"""
from __future__ import annotations

from repro_torch.models import moe as moe_lib
from repro_torch.runtime import shard_ctx


def moe_apply_maybe_sharded(params, x, cfg, *, with_aux=True):
    """``moe_apply`` on this rank's tokens ``x`` [B_local, S, D]."""
    ctx = shard_ctx.get()
    if ctx is None:
        return moe_lib.moe_apply(params, x, cfg, with_aux=with_aux)
    tp = shard_ctx.tp_split(params["w_down"].shape[-2], cfg.moe_d_ff)
    y, aux = moe_lib.moe_apply(params, x, cfg, with_aux=with_aux,
                               tp_group=tp)
    if aux is not None:
        aux = shard_ctx.data_mean(aux)
    return y, aux
