"""Q8 deltas in the port (``repro_torch.adapters.quantize_delta`` and the
dequantizing ``apply_delta``) against the JAX package.

The same seeded numpy trees go through both packages.  Bitwise, as the
codec promises (round half to even, one IEEE division, one multiply and
one cast on the way back):

- the codes, the scales, which entries stay unquantized (tiny rows pad
  to a 256-element block and would grow) and ``meta["quantized"]``;
- the dequantized rows (``materialize_rows``), in f32 and bf16;
- the applied tree, against JAX's ``apply_delta`` of the same payload;
- revert (the displaced side holds the exact resident values).

Payloads written by either package load in the other, and
``TrainLoopConfig(quantize_deltas=True)`` exports a delta that the JAX
registry reads.  These mirror ``tests/test_q8state.py``'s Q8 delta
tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adapters import AdapterRegistry as JRegistry
from repro.adapters import apply_delta as japply
from repro.adapters import extract_delta as jextract
from repro.adapters import quantize_delta as jquantize
from repro.adapters import revert_delta as jrevert
from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro_torch import adapters as tad
from repro_torch import interop, trainers
from repro_torch.core.blockllm import BlockLLMConfig
from repro_torch.core.selection import SelectorConfig
from repro_torch.optim.adam import Adam
from repro_torch.runtime import train_loop as tloop

torch.set_num_threads(2)


def _trees(dtype, seed=0):
    """A [32, 64, 32] stack with rows 3 and 7 edited, a [16] norm edited
    whole (16 floats: smaller than one codec block, so it stays fp), a
    [2, 300] leaf edited whole (two blocks, quantized) and an int leaf."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(32, 64, 32)).astype(np.float32)
    base = {"w": w, "norm": rng.normal(size=16).astype(np.float32),
            "wide": rng.normal(size=(2, 300)).astype(np.float32),
            "ids": np.arange(8, dtype=np.int32).reshape(2, 4)}
    tuned = {k: v.copy() for k, v in base.items()}
    tuned["w"][3] += 0.1
    tuned["w"][7] -= 0.2
    tuned["norm"] += 1.0
    tuned["wide"] *= 3.0
    tuned["ids"] += 5
    jb = {k: jnp.asarray(v, dtype if v.dtype == np.float32 else v.dtype)
          for k, v in base.items()}
    jt = {k: jnp.asarray(v, dtype if v.dtype == np.float32 else v.dtype)
          for k, v in tuned.items()}
    return jb, jt


def _port(tree):
    return interop.tree_to_torch(jax.tree.map(np.asarray, tree),
                                 device="cpu")


def _bits(x):
    if isinstance(x, torch.Tensor):
        return interop.named_numpy({"x": x})["x"].tobytes()
    return np.asarray(x).tobytes()


def _same_tree(port_tree, jax_tree):
    got = interop.named_numpy(port_tree)
    names, leaves, _ = jflat(jax_tree)
    assert list(got) == names
    for n, leaf in zip(names, leaves):
        assert got[n].tobytes() == np.asarray(leaf).tobytes(), n


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_delta_is_bitwise_jax(dtype):
    jb, jt = _trees(dtype)
    jq = jquantize(jextract(jb, jt))
    tq = tad.quantize_delta(tad.extract_delta(_port(jb), _port(jt)))
    assert sorted(tq.entries) == sorted(jq.entries)
    assert tq.meta["quantized"] is jq.meta["quantized"] is True
    assert tq.nbytes == jq.nbytes and tq.num_rows() == jq.num_rows()
    for name, je in jq.entries.items():
        te = tq.entries[name]
        assert te.quantized == je.quantized, name
        assert _bits(te.rows) == _bits(je.rows), name
        if je.quantized:
            assert _bits(te.scale) == _bits(je.scale), name
            assert te.row_shape == tuple(je.row_shape)
            assert te.row_dtype == je.row_dtype
            assert _bits(te.materialize_rows()) == \
                _bits(je.materialize_rows()), name
    # which entries the rules keep fp: the int rows pass through, the
    # 16-float norm would grow, the rest shrink
    assert [n for n, e in tq.entries.items() if not e.quantized] == \
        ["ids", "norm"]
    # quantizing again changes nothing; no float entry => flag stays off
    assert tad.quantize_delta(tq).nbytes == tq.nbytes
    ints = tad.SparseDelta({"ids": tq.entries["ids"]})
    assert tad.quantize_delta(ints).meta["quantized"] is False


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_apply_q8_delta_bitwise_jax_and_revert_exact(dtype):
    jb, jt = _trees(dtype, seed=1)
    jq = jquantize(jextract(jb, jt))
    want, jdisp = japply(jb, jq)
    tq = tad.quantize_delta(tad.extract_delta(_port(jb), _port(jt)))
    base = _port(jb)
    new, disp = tad.apply_delta(base, tq)
    _same_tree(new, want)
    _same_tree(base, jb)                      # not donated: untouched
    back = tad.revert_delta(new, disp, donate=True)
    _same_tree(back, jb)
    _same_tree(back, jrevert(want, jdisp))


def test_q8_payloads_move_between_packages(tmp_path):
    jb, jt = _trees(jnp.float32, seed=2)
    jq = jquantize(jextract(jb, jt, meta={"adapter_id": "j"}))
    JRegistry(tmp_path / "reg").put("j", jq)
    treg = tad.AdapterRegistry(tmp_path / "reg")
    tq = treg.get("j")                       # JAX's checksum verified
    assert tq.quantized and tq.meta["quantized"]
    for name, je in jq.entries.items():
        assert _bits(tq.entries[name].materialize_rows()) == \
            _bits(je.materialize_rows()), name
    # and back: the port writes it, JAX reads it and applies the same rows
    treg.put("t", tad.quantize_delta(tad.extract_delta(_port(jb),
                                                       _port(jt))))
    back = JRegistry(tmp_path / "reg").get("t")
    assert back.quantized
    assert back.meta["payload_sha256"] == tq.meta["payload_sha256"]
    a1, _ = japply(jb, back)
    a2, _ = japply(jb, jq)
    for x, y in zip(jax.tree.leaves(a1), jax.tree.leaves(a2)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def test_quantized_export_is_read_by_jax_registry(tmp_path):
    """``TrainLoopConfig(quantize_deltas=True)``: the exporter publishes
    an int8 payload; the JAX registry loads it, and the rows it applies
    are the port's dequantized rows, bit for bit."""
    from repro.configs.base import get_config as jget_config
    from repro.data.pipeline import DataConfig, TokenPipeline
    from repro.launch.train import reduce_config as jreduce
    from repro_torch.configs import base as tconfigs
    from repro_torch.models import model as tmodel
    jcfg = jreduce(jget_config("internlm2-1.8b"), 8).replace(
        dtype="float32")
    tcfg = tconfigs.ModelConfig(**dataclasses.asdict(jcfg))
    params = tmodel.init_params(tcfg, generator=torch.Generator(
        "cpu").manual_seed(0), device="cpu")
    base = tad.copy_tree(params)
    th = trainers.handle(
        "blockllm", tcfg, params, device="cpu", adam=Adam(lr=1e-2),
        bcfg=BlockLLMConfig(selector=SelectorConfig(
            sparsity=0.9, static_k_frac=0.34)))
    pipe = TokenPipeline(DataConfig(vocab_size=tcfg.vocab_size, seq_len=16,
                                    global_batch=2, seed=0))
    reg_dir = tmp_path / "adapters"
    tloop.run(th, pipe.batch, tloop.TrainLoopConfig(
        total_steps=2, ckpt_every=100, adapter_dir=str(reg_dir),
        adapter_id="q", quantize_deltas=True, log_every=0))
    jd = JRegistry(reg_dir).get("q")
    td = tad.AdapterRegistry(reg_dir).get("q")
    assert jd.quantized and jd.meta["quantized"] and td.quantized
    assert sorted(jd.entries) == sorted(td.entries)
    for name, je in jd.entries.items():
        assert _bits(td.entries[name].materialize_rows()) == \
            _bits(je.materialize_rows()), name
    # applied: the trained rows up to the codec's bound, reverted exactly
    new, disp = tad.apply_delta(tad.copy_tree(base), td)
    merged = interop.named_numpy(th.merged_params())
    for name, arr in interop.named_numpy(new).items():
        err = np.abs(arr - merged[name]).max()
        assert err <= np.abs(merged[name]).max() / 200.0, name
    back = tad.revert_delta(new, disp)
    for name, arr in interop.named_numpy(back).items():
        assert arr.tobytes() == interop.named_numpy(base)[name].tobytes()
