"""The port's sharding rules against the JAX package's, without ranks.

``runtime.sharding``'s rules are pure functions of (leaf path, shape,
config, mesh shape), so both packages' rules run here over a stand-in
mesh (an object with a ``shape`` mapping: JAX's ``_leaf_spec`` ->
``_head_aware_prune`` -> ``prune_spec`` chain reads nothing else; its
``NamedSharding`` wrapper is swapped for the bare spec).  JAX's shapes
come from ``jax.eval_shape`` of its ``init_params`` / ``init_cache``,
the port's from its meta-device params and cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro.configs import base as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.runtime import sharding as jsharding
from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.configs import base as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as tsteps
from repro_torch.models import xlstm as txlstm
from repro_torch.runtime import shard_ctx
from repro_torch.runtime import sharding as tsharding

ARCHS = [
    "qwen2-moe-a2.7b", "granite-moe-3b-a800m", "deepseek-7b",
    "internlm2-1.8b", "gemma3-1b", "gemma-2b", "pixtral-12b",
    "recurrentgemma-2b", "xlstm-1.3b", "whisper-large-v3",
]
MESHES = [(16, 16), (32, 8), (4, 2)]


@dataclasses.dataclass
class StandInMesh:
    shape: dict


def _norm(spec, nd):
    """A spec as a tuple of ``nd`` entries, each None or a tuple of
    axis names."""
    out = []
    for e in tuple(spec) + (None,) * (nd - len(tuple(spec))):
        out.append(None if e is None else
                   ((e,) if isinstance(e, str) else tuple(e)))
    return tuple(out)


class _NS:
    """Stand-in ``NamedSharding``: the spec alone."""

    def __init__(self, spec):
        self.spec = spec


@pytest.fixture
def bare_jax_specs(monkeypatch):
    monkeypatch.setattr(jsharding, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.sharding, "NamedSharding",
                        lambda mesh, spec: spec)


def _port_name(name, tnames):
    """JAX's xLSTM cache states are tuples (``stages/0/pos0/1``), the
    port's dicts keyed in the tuples' order (``MLSTM_FRESH`` /
    ``SLSTM_FRESH``)."""
    head, _, last = name.rpartition("/")
    if not last.isdigit() or name in tnames:
        return name
    keys = [n.rpartition("/")[2] for n in tnames if n.startswith(head + "/")]
    order = list(txlstm.MLSTM_FRESH if len(keys) == 3 else txlstm.SLSTM_FRESH)
    return f"{head}/{order[int(last)]}"


def _compare(jspecs, jshapes_, tspecs_, tshapes_):
    jn, jl, _ = jflat(jspecs)
    tn, tl, _ = _flatten_with_names(tspecs_)
    rename = {n: _port_name(n, set(tn)) for n in jn}
    jn = [rename[n] for n in jn]
    jshapes_ = {rename.get(n, n): v for n, v in jshapes_.items()}
    assert sorted(jn) == sorted(tn)
    tmap = dict(zip(tn, tl))
    for n, js in zip(jn, jl):
        nd = len(jshapes_[n].shape)
        assert tuple(tshapes_[n].shape) == tuple(jshapes_[n].shape), n
        assert _norm(tmap[n], nd) == _norm(js, nd), (n, js, tmap[n])
    return len(jn)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_jax(arch, bare_jax_specs):
    jcfg = jconfigs.get_config(arch)
    tcfg = tconfigs.get_config(arch)
    tparams = tspecs.params_abstract(tcfg, dtype=torch.float32)
    tnames, tleaves, _ = _flatten_with_names(tparams)
    tp_shapes = dict(zip(tnames, tleaves))
    jp_shapes = jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    jp_named = dict(zip(*jflat(jp_shapes)[:2]))
    dshape = jshapes.get_shape("decode_32k")
    jc_shapes = jax.eval_shape(lambda: jmodel.init_cache(
        jcfg, dshape.global_batch, dshape.seq_len, jnp.bfloat16))
    jc_named = dict(zip(*jflat(jc_shapes)[:2]))
    tcache = tspecs.cache_specs_abstract(tcfg, tshapes.get_shape(
        "decode_32k"))
    tc_named = dict(zip(*_flatten_with_names(tcache)[:2]))
    n = 0
    for shape in MESHES:
        mesh = StandInMesh(dict(zip(("data", "model"), shape)))
        jp_specs = jsharding.param_specs(jcfg, jp_shapes, mesh)
        n += _compare(jp_specs, jp_named,
                      tsharding.param_specs(tcfg, tparams, mesh), tp_shapes)
        n += _compare(jsharding.cache_specs(jcfg, jc_shapes, mesh),
                      jc_named, tsharding.cache_specs(tcfg, tcache, mesh),
                      tc_named)
        # the ZeRO extension of the optimizer moments, leaf for leaf
        for name, js in zip(*jflat(jp_specs)[:2]):
            nd = len(jp_named[name].shape)
            jz = jsteps._zero_extend(_NS(js), jp_named[name].shape, mesh,
                                     ("data",))
            tz = tsteps._zero_specs(tcfg, {name: tp_shapes[name]}, mesh,
                                    ("data",))[name]
            assert _norm(tz, nd) == _norm(jz, nd), name
    assert n > 0


def test_param_specs_of_moments_follow_the_leaf_name():
    """Optimizer trees (Adam's ``mu`` / ``nu``) and BlockLLM's selection
    tree key their leaves by the parameter's last path key, as JAX."""
    cfg = tconfigs.get_config("internlm2-1.8b")
    mesh = StandInMesh({"data": 4, "model": 2})
    rows = torch.empty(3, cfg.d_model, cfg.num_heads
                       * cfg.resolved_head_dim, device="meta")
    tree = {"mu": {"stacks": {"s0/pos0": {"attn": {"wq": rows}}}}}
    spec = tsharding.param_specs(cfg, tree, mesh)
    assert _norm(spec["mu"]["stacks"]["s0/pos0"]["attn"]["wq"], 3) == \
        (None, None, ("model",))


def test_shapes_equal_jax():
    assert set(tshapes.SHAPES) == set(jshapes.SHAPES)
    for name, s in jshapes.SHAPES.items():
        assert dataclasses.asdict(tshapes.SHAPES[name]) == \
            dataclasses.asdict(s)
        assert tshapes.get_shape(name) == tshapes.SHAPES[name]
        for arch in ARCHS:
            assert tshapes.shape_applicable(arch, tshapes.SHAPES[name]) == \
                jshapes.shape_applicable(arch, s)
    assert tshapes.LONG_CONTEXT_ARCHS == jshapes.LONG_CONTEXT_ARCHS


def test_prune_spec_and_fits_equal_jax():
    from jax.sharding import PartitionSpec as JP
    from repro.runtime import shard_ctx as jctx
    mesh = StandInMesh({"data": 4, "model": 6})
    for shape in [(24, 12), (10, 7), (48, 5, 6)]:
        for spec in [(("data", "model"), None), ("model", "data"),
                     (None, ("model", "data")), ("data",)]:
            spec = spec[:len(shape)]
            j = jctx.prune_spec(shape, JP(*spec), mesh)
            t = shard_ctx.prune_spec(shape, shard_ctx.P(*spec), mesh)
            assert _norm(t, len(shape)) == _norm(j, len(shape))
            assert shard_ctx.fits(shape, shard_ctx.P(*spec), mesh) == \
                jctx.fits(shape, JP(*spec), mesh)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = StandInMesh({"data": 2, "model": 2})
    assert shard_ctx.placements(shard_ctx.P(None, "model"), mesh) == \
        (Replicate(), Shard(1))
    assert shard_ctx.placements(shard_ctx.P(("data", "model")), mesh) == \
        (Shard(0), Shard(0))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-large-v3",
                                  "pixtral-12b"])
def test_tensor_parallel_refused_where_not_ported(arch):
    cfg = tconfigs.get_config(arch)
    mesh = StandInMesh({"data": 2, "model": 2})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsteps.check_tensor_parallel(cfg, mesh)
    tsteps.check_tensor_parallel(cfg, StandInMesh({"data": 4, "model": 1}))
