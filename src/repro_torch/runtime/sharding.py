"""Logical-axis sharding rules with divisibility-aware fallback
(counterpart of ``repro.runtime.sharding``).

``param_specs`` walks a parameter tree and assigns a spec per leaf from
its path, leaf for leaf JAX's rules; every rule is pruned per dimension
against the mesh (``shard_ctx.prune_spec``): a head count or vocab that
does not divide the model axis falls back to replication for that dim.
The rules are pure functions of (path, shape, cfg, mesh shape): ``mesh``
is a ``DeviceMesh`` or anything ``shard_ctx.mesh_shape`` reads.
"""
from __future__ import annotations

from typing import Any, Tuple

from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.runtime.shard_ctx import P, mesh_shape, prune_spec

Pytree = Any

TP = "model"


def path_keys(name: str) -> Tuple[str, ...]:
    """A flattened leaf name (``checkpointer._flatten_with_names``) as
    JAX's path keys (a NamedTuple field ``.mu`` is ``mu``)."""
    return tuple(k.lstrip(".") for k in name.split("/"))


def map_with_keys(fn, tree: Pytree) -> Pytree:
    """``fn(keys, leaf)`` over every leaf (JAX's
    ``tree_map_with_path``)."""
    names, leaves, td = _flatten_with_names(tree)
    return td.unflatten([fn(path_keys(n), l) for n, l in zip(names, leaves)])


def _leaf_spec(keys: Tuple[str, ...], shape, cfg, dp_axes) -> P:
    """Raw (un-pruned) spec for a parameter leaf."""
    last = keys[-1]
    nd = len(shape)

    def tail(*spec):
        return P(*((None,) * (nd - len(spec)) + spec))

    if last == "embed":
        return P(TP, None)                      # vocab-sharded
    if last == "head":
        return P(None, TP)                      # vocab-sharded output
    if last in ("wq", "wk", "wv"):
        return tail(None, TP)                   # column parallel (head dim)
    if last == "wo":
        return tail(TP, None)                   # row parallel
    if last in ("w_gate", "w_up", "in_x", "in_y",
                "w_i", "w_f", "w_z", "w_o", "gate_a", "gate_x"):
        return tail(None, TP)                   # column parallel
    if last in ("w_down", "out"):
        return tail(TP, None)                   # row parallel
    if last == "router":
        return tail(None, None)                 # tiny; replicate
    if last in ("lambda", "b_a", "b_x"):
        return tail(TP)                         # follows lru width sharding
    if last == "w" and "conv" in keys:
        return tail(None, TP)                   # depthwise conv channels
    if last == "b" and "conv" in keys:
        return tail(TP)
    if last == "frontend":
        return tail(None, None)
    if last == "vision_proj" or keys[0] == "vision_proj":
        return P(None, None)
    return P(*((None,) * nd))                   # norms, biases: replicate


def _head_aware_prune(keys, shape, spec, cfg, mesh) -> P:
    """Attention q/kv sharding keeps whole heads per shard: replicate
    when the heads do not divide the model axis."""
    last = keys[-1]
    tp_size = int(mesh_shape(mesh)[TP])
    per_head = len(shape) >= 3 and shape[-1] == shape[-2]  # xLSTM [H,hd,hd]
    none = P(*((None,) * len(shape)))
    if last == "wq" and not per_head and cfg.num_heads % tp_size:
        return none
    if last in ("wk", "wv") and not per_head:
        heads = (cfg.num_heads if "xattn" in keys or "encoder" in keys
                 else cfg.num_kv_heads)
        if heads % tp_size:
            return none
    if last == "wo" and cfg.num_heads % tp_size:
        return none
    return spec


def pure_dp(cfg) -> bool:
    """SSM (mLSTM/sLSTM) archs run pure data parallel over every mesh
    axis: parameters replicated, batch sharded over all ranks."""
    return cfg.family == "ssm"


def leaf_spec(keys, shape, cfg, mesh) -> P:
    """The pruned spec of one parameter leaf (``param_specs``'s rule)."""
    if pure_dp(cfg):
        return P(*((None,) * len(shape)))
    spec = _leaf_spec(keys, shape, cfg, None)
    spec = _head_aware_prune(keys, shape, spec, cfg, mesh)
    return prune_spec(shape, spec, mesh)


def param_specs(cfg, params: Pytree, mesh, dp_axes=("data",)) -> Pytree:
    """A spec per leaf of a parameter-shaped tree."""
    return map_with_keys(lambda keys, leaf: leaf_spec(
        keys, tuple(leaf.shape), cfg, mesh), params)


def batch_specs(shape_kind: str, batch: Pytree, mesh,
                dp_axes=("data",)) -> Pytree:
    dp = tuple(dp_axes)

    def one(keys, leaf):
        if leaf.dim() == 0:
            return P()
        return prune_spec(tuple(leaf.shape),
                          P(dp, *((None,) * (leaf.dim() - 1))), mesh)

    return map_with_keys(one, batch)


def _size(mesh, axes) -> int:
    ms = mesh_shape(mesh)
    out = 1
    for a in axes:
        out *= ms[a]
    return out


def cache_specs(cfg, cache: Pytree, mesh, dp_axes=("data",)) -> Pytree:
    """Decode-cache specs: batch over the data axes; with a batch of one
    (the long-context cell) the sequence / state dim over every axis
    that divides."""
    dp = tuple(dp_axes)
    all_axes = dp + (TP,)
    tp_size = int(mesh_shape(mesh)[TP])

    def kv_spec(shape):
        G, B, C, KV, hd = shape
        if B % _size(mesh, dp) == 0 and _size(mesh, dp) > 1:
            if KV % tp_size == 0:
                spec = P(None, dp, None, TP, None)
            else:
                spec = P(None, dp, TP, None, None)
        else:
            spec = P(None, None, all_axes, None, None)
        return prune_spec(shape, spec, mesh)

    def generic(shape):
        nd = len(shape)
        if nd >= 2 and shape[1] % _size(mesh, dp) == 0 \
                and _size(mesh, dp) > 1:
            spec = P(None, dp, *((None,) * (nd - 2)))
        elif nd >= 3:
            spec = P(*((None,) * (nd - 1)), TP)
        else:
            spec = P(*((None,) * nd))
        return prune_spec(shape, spec, mesh)

    def one(keys, leaf):
        shape = tuple(leaf.shape)
        if keys[-1] in ("k", "v") and len(shape) == 5:
            return kv_spec(shape)
        return generic(shape)

    return map_with_keys(one, cache)

