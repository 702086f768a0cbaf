"""Distributed step builders: (arch x shape x mesh) -> ``StepSetup``
(counterpart of ``repro.launch.steps``), on ``torch.distributed``.

The train builder is protocol-generic: it resolves the trainer through
the registry, asks the core for its abstract state (``init_abstract``,
meta tensors) and its raw positional step (``lowerable``: the same
function the single-device path runs), and derives every argument's
layout from the ``state_spec`` sharding roles — parameter trees get the
logical rules (``runtime.sharding``), optimizer moments the ZeRO
extension over the data axes, index vectors and scalars replicate.

In place of JAX's ``lower()``, a ``StepSetup`` runs: ``shard`` cuts
each full argument to this rank's local shard by its layout, calling
the setup runs ``fn`` on the local shards under ``shard_ctx.use(rules)``
(the model's collectives and the gradient hook act there), and
``gather`` puts outputs back together (for tests).  Every rank holds
the full concrete arguments (drawn from one seed) and keeps its slice.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import trainers as trainers_lib
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import dp_axes as mesh_dp_axes
from repro_torch.models import model as model_lib
from repro_torch.optim.adam import AdamState
from repro_torch.optim.q8adam import (Q8AdamState, dequantize_int8,
                                      quantize_int8)
from repro_torch.runtime import shard_ctx, sharding
from repro_torch.runtime.shard_ctx import P, _axes, mesh_shape

Pytree = Any


def check_tensor_parallel(cfg: ModelConfig, mesh) -> None:
    """Raise where a model axis above 1 meets blocks the port does not
    split yet (``model.check_tensor_parallel``); the ``ssm`` family folds
    the model axis into data parallelism."""
    if not sharding.pure_dp(cfg):
        model_lib.check_tensor_parallel(
            cfg, int(mesh_shape(mesh).get(sharding.TP, 1)))


def _rules_for(mesh, cfg=None, tp_leaves=frozenset()) -> shard_ctx.ShardRules:
    dp = mesh_dp_axes(mesh)
    if cfg is not None and sharding.pure_dp(cfg):
        # SSM archs: batch over every axis, no tensor parallelism
        dp_all = dp + (sharding.TP,)
        return shard_ctx.ShardRules(mesh=mesh, dp_axes=dp_all)
    return shard_ctx.ShardRules(mesh=mesh, dp_axes=dp, tp_leaves=tp_leaves)


def _zero_extend(spec: P, shape, mesh, dp) -> P:
    """ZeRO: also shard a leaf over the data axes on the first dim after
    the stacked-rows axis that is unsharded and divisible (JAX's
    ``_zero_extend``)."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    start = 1 if len(shape) > 1 else 0
    n = math.prod(mesh_shape(mesh)[a] for a in dp)
    for i in range(start, len(shape)):
        if spec[i] is None and shape[i] % n == 0 and shape[i] > 1:
            spec[i] = tuple(dp) if len(dp) > 1 else dp[0]
            break
    return P(*spec)


@dataclass(frozen=True)
class Layout:
    """One leaf's DTensor placements on the setup's mesh (one per mesh
    dim: ``Shard(d)`` or ``Replicate()``), from its spec."""
    placements: Tuple

    @classmethod
    def of(cls, spec: P, mesh) -> "Layout":
        return cls(shard_ctx.placements(spec, mesh))


@dataclass(frozen=True)
class Q8Chunks:
    """Layout of a Q8 moment leaf (int8 ``[NB, 256]`` codes or f32
    ``[NB]`` scales of the parameter leaf ``shape``): the codec blocks
    of the model-local leaf chunked along NB over ``dp``
    (``shard_ctx.q8_chunk``).  ``param``: the parameter's layout; a
    model-split parameter's codes are re-blocked over its local shard
    (``StepSetup.shard`` requantizes them)."""
    param: Layout
    shape: Tuple[int, ...]
    dp: Tuple[str, ...]


def _zero_specs(cfg, tree, mesh, dp):
    """The moments' specs: the parameter rules plus the ZeRO extension."""
    return sharding.map_with_keys(lambda keys, leaf: _zero_extend(
        sharding.leaf_spec(keys, tuple(leaf.shape), cfg, mesh),
        tuple(leaf.shape), mesh, dp), tree)


def _layouts(specs, mesh):
    return sharding.map_with_keys(lambda keys, spec: Layout.of(spec, mesh),
                                  specs)


def _role_shardings(role: str, tree, cfg, mesh, dp, shape_kind: str,
                    like=None):
    """``state_spec`` role -> a ``Layout`` (or ``Q8Chunks``) per leaf of
    ``tree``; ``like``: the parameter-shaped tree of an ``opt`` arg."""
    if tree is None:
        return None
    whole = Layout.of(P(), mesh)
    if role == "batch":
        return _layouts(sharding.batch_specs(shape_kind, tree, mesh, dp),
                        mesh)
    if role in ("index", "scalar"):
        return sharding.map_with_keys(lambda keys, leaf: whole, tree)
    if role == "opt":
        if isinstance(tree, AdamState):
            return AdamState(whole,
                             _layouts(_zero_specs(cfg, tree.mu, mesh, dp),
                                      mesh),
                             _layouts(_zero_specs(cfg, tree.nu, mesh, dp),
                                      mesh))
        if isinstance(tree, Q8AdamState):
            chunks = sharding.map_with_keys(lambda keys, leaf: Q8Chunks(
                Layout.of(sharding.leaf_spec(keys, tuple(leaf.shape), cfg,
                                             mesh), mesh),
                tuple(leaf.shape), tuple(dp)), like)
            return Q8AdamState(whole, chunks, chunks, chunks, chunks)
        # GaLore's state: whole on every rank (its refresh is an SVD of
        # the whole gradient)
        return sharding.map_with_keys(lambda keys, leaf: whole, tree)
    return _layouts(sharding.param_specs(cfg, tree, mesh), mesh)


def local_slice(t: torch.Tensor, layout: Layout, rules) -> torch.Tensor:
    """This rank's block of ``t`` (a view): each ``Shard(d)`` in mesh-dim
    order cuts dim ``d`` into the mesh dim's size, DTensor's order."""
    for name, p in zip(mesh_shape(rules.mesh), layout.placements):
        if p.is_shard():
            size = t.shape[p.dim] // rules.axis_size(name)
            t = t.narrow(p.dim, rules.coord(name) * size, size)
    return t


@dataclass
class StepSetup:
    name: str
    fn: Callable
    args: Tuple            # abstract (meta) arguments, positional
    in_shardings: Tuple    # per arg: a tree of Layouts (or Q8Chunks)
    rules: shard_ctx.ShardRules
    roles: Tuple = ()      # per arg: its state_spec sharding role
    donate: Tuple = ()     # args the step updates in place
    out_args: Tuple = ()   # per output: the arg whose layout it has
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- local slices ------------------------------------------------- #

    def _splits(self, layout: Layout) -> bool:
        return any(p.is_shard() and self.rules.axis_size(name) > 1
                   for name, p in zip(mesh_shape(self.rules.mesh),
                                      layout.placements))

    def _slice(self, t: torch.Tensor, layout: Layout) -> torch.Tensor:
        return local_slice(t, layout, self.rules)

    def _shard_q8(self, q8: Q8AdamState, lay: Q8AdamState) -> Q8AdamState:
        _, specs, _ = _flatten_with_names(lay.mu_q)
        n = self.rules.axis_size(specs[0].dp) if specs else 1
        r = self.rules.coord(specs[0].dp) if specs else 0
        out = []
        for codes, scales in ((q8.mu_q, q8.mu_scale), (q8.nu_q, q8.nu_scale)):
            cs, ss = [], []
            for q, s, lay_ in zip(_flatten_with_names(codes)[1],
                                  _flatten_with_names(scales)[1], specs):
                if self._splits(lay_.param):
                    # a model-split leaf: its local shard's own blocks
                    x = self._slice(dequantize_int8(q, s, lay_.shape),
                                    lay_.param)
                    q, s = quantize_int8(x.contiguous())
                    numel = x.numel()
                else:
                    numel = math.prod(lay_.shape)
                _, lo, hi = shard_ctx.q8_chunk(numel, n, r)
                cs.append(q[lo:hi].clone())
                ss.append(s[lo:hi].clone())
            td = _flatten_with_names(codes)[2]
            out += [td.unflatten(cs), td.unflatten(ss)]
        return Q8AdamState(q8.count.clone(), out[0], out[1], out[2], out[3])

    def shard(self, concrete_args) -> Tuple:
        """This rank's local arguments (copies: the step updates them in
        place) from the full ones."""
        out = []
        for arg, lay in zip(concrete_args, self.in_shardings):
            if lay is None or not isinstance(arg, (dict, list, tuple,
                                                   torch.Tensor)):
                out.append(arg)
            elif isinstance(lay, Q8AdamState):
                out.append(self._shard_q8(arg, lay))
            else:
                _, leaves, td = _flatten_with_names(arg)
                specs = _flatten_with_names(lay)[1]
                out.append(td.unflatten([
                    self._slice(t, s).clone() if t.dim() else t.clone()
                    for t, s in zip(leaves, specs)]))
        return tuple(out)

    def __call__(self, *local_args):
        with shard_ctx.use(self.rules):
            return self.fn(*local_args)

    # -- gather (tests) ----------------------------------------------- #

    def _gather_leaf(self, t: torch.Tensor, spec) -> torch.Tensor:
        with shard_ctx.use(self.rules):
            if isinstance(spec, Q8Chunks):
                if self._splits(spec.param):
                    raise NotImplementedError(
                        "gather of Q8 moments of a model-split leaf")
                n = self.rules.axis_size(spec.dp)
                c, _, _ = shard_ctx.q8_chunk(math.prod(spec.shape), n, 0)
                pad = c - t.shape[0]
                if pad:
                    t = torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                full = shard_ctx.all_gather(t, spec.dp, "test/all_gather")
                nb = shard_ctx.q8_chunk(math.prod(spec.shape), 1, 0)[0]
                return full[:nb]
            names = list(mesh_shape(self.rules.mesh))
            for name, p in reversed(list(zip(names, spec.placements))):
                if p.is_shard():
                    t = shard_ctx.all_gather(t.movedim(p.dim, 0), name,
                                             "test/all_gather").movedim(
                                                 0, p.dim)
            return t

    def gather(self, outputs) -> Tuple:
        """Full outputs from every rank's local ones (``out_args`` says
        each output's layout; None: replicated, returned as it is)."""
        full = []
        for out, i in zip(outputs, self.out_args):
            lay = None if i is None else self.in_shardings[i]
            if lay is None or out is None:
                full.append(out)
                continue
            _, leaves, td = _flatten_with_names(out)
            specs = _flatten_with_names(lay)[1]
            full.append(td.unflatten([
                self._gather_leaf(t, s) if t.dim() else t
                for t, s in zip(leaves, specs)]))
        return tuple(full)


def _tp_leaves(cfg, params, mesh) -> frozenset:
    """Names of the parameter leaves a model axis above 1 splits."""
    if int(mesh_shape(mesh).get(sharding.TP, 1)) <= 1:
        return frozenset()
    specs = sharding.param_specs(cfg, params, mesh)
    names, leaves, _ = _flatten_with_names(specs)
    return frozenset(n for n, s in zip(names, leaves)
                     if sharding.TP in sum((_axes(e) for e in s), ()))


def build_train_setup(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                      optimizer: str = "blockllm", sparsity: float = 0.95,
                      k_frac: float = 0.25, attn_impl: str = "chunked",
                      param_dtype=torch.bfloat16, **hyper) -> StepSetup:
    """The distributed train step of any registered trainer, over meta
    arguments.  ``hyper`` reaches the trainer's factory (``device``,
    ``adam``, ``bcfg``, ...); the factory's device is where ``fn`` runs.
    The meta state's selection plan is the one a real ``init`` of the
    same config makes (``meta["plan"]`` for BlockLLM cores)."""
    check_tensor_parallel(cfg, mesh)
    params = specs_lib.params_abstract(cfg, dtype=param_dtype)
    rules = _rules_for(mesh, cfg, _tp_leaves(cfg, params, mesh))
    dp = rules.dp_axes
    core = trainers_lib.make(optimizer, cfg, sparsity=sparsity,
                             k_frac=k_frac, policy="static",
                             attn_impl=attn_impl, **hyper)
    state = core.init_abstract(params)
    batch = specs_lib.input_specs(cfg, shape)
    low = core.lowerable(state, batch)
    like = {"opt": low.args[low.roles.index("active")]
            if "active" in low.roles else low.args[0]}
    in_shardings = tuple(
        _role_shardings(role, arg, cfg, mesh, dp, shape.kind,
                        like=like.get(role))
        for role, arg in zip(low.roles, low.args))
    return StepSetup(
        name=f"{cfg.name}:{shape.name}", fn=low.fn, args=low.args,
        in_shardings=in_shardings, rules=rules, roles=low.roles,
        donate=low.donate, out_args=low.out_args,
        meta={"kind": "train", "optimizer": optimizer, "core": core,
              **low.meta})


def build_setup(cfg: ModelConfig, shape: ShapeConfig, mesh,
                **kw) -> StepSetup:
    if shape.kind == "train":
        return build_train_setup(cfg, shape, mesh, **kw)
    raise NotImplementedError(
        f"{shape.kind} setups are not ported yet (ROADMAP queue A, item "
        f"4a: slice 17, prefill / decode with the cross-rank softmax "
        f"merge)")
