"""The port's sharded prefill and decode setups on CPU ranks (gloo),
against the JAX package's single-device ``prefill`` and ``decode_step``.

Each case builds ``launch.steps.build_setup`` for a (config, mesh,
shape) on 4 (or 2) rank processes of ``tests/torch_dist_ranks.py``
(scenario ``serving``), from the port's seeded weights (which the test
hands JAX through ``interop``'s leaf names) and the test's numpy cache,
token and position (decode) or batch (prefill); the ranks gather the
logits and the cache.  The JAX references run here on one CPU device:
``decode_step(attn_impl="chunked")`` (XLA's decode attention) and
``prefill``.  The cases cover every branch of ``sharding.cache_specs``:
batch over the data axes with KV heads over the model axis (``dense``
at (2, 2)), KV heads that do not divide the model axis so the sequence
splits over it (``dense`` at (1, 4), the reduced gemma3's KV 1 with
local rings), a batch of one with the sequence over every axis, MoE,
xLSTM's states split on their last dim (pure data parallel at batch 1),
and the RG-LRU, encoder-decoder and VLM families at (4, 1) — whose
setups refuse a model axis above 1 naming ROADMAP item 4b.

Tolerance, f32: logits and every written cache leaf within 1e-4 of the
largest magnitude of JAX's (the ranks sum in other orders: tensor-
parallel partial products, the sequence shards' softmax merge, batch
shards of the matmuls); rows of the decode cache other than the written
slot bitwise the input's.
"""
import dataclasses
import functools
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro.configs.base import get_config as jget_config
from repro.launch.train import reduce_config
from repro.models import model as jmodel
from test_torch_distributed import DENSE, XLSTM, Launch, _family_cfg

RTOL = 1e-4
G3 = reduce_config(jget_config("gemma3-1b"), 8).replace(
    name="g3", num_heads=4, window_size=16, dtype="float32")
FAMILY = {"rg": "recurrentgemma-2b", "whisper": "whisper-large-v3",
          "pixtral": "pixtral-12b", "moe": "granite-moe-3b-a800m"}


def _cfgs():
    out = {"dense": DENSE, "g3": G3, "xlstm": XLSTM}
    for name, arch in FAMILY.items():
        out[name] = _family_cfg(arch).replace(name=name)
    return out


CFGS = _cfgs()

# (key, config, mesh, kind, batch, sequence, position, attention)
FOUR = [
    ("dense-2x2", "dense", (2, 2), "decode", 4, 32, 13, "full"),
    ("dense-1x4", "dense", (1, 4), "decode", 4, 32, 29, "kernel"),
    ("dense-b1-2x2", "dense", (2, 2), "decode", 1, 32, 29, "kernel"),
    ("dense-4x1", "dense", (4, 1), "decode", 4, 32, 20, "full"),
    ("g3-2x2", "g3", (2, 2), "decode", 4, 64, 40, "kernel"),
    ("g3-b1-4x1", "g3", (4, 1), "decode", 1, 64, 50, "full"),
    ("moe-2x2", "moe", (2, 2), "decode", 4, 32, 20, "full"),
    ("xlstm-b1-2x2", "xlstm", (2, 2), "decode", 1, 16, 5, "full"),
    ("rg-4x1", "rg", (4, 1), "decode", 4, 32, 20, "full"),
    ("whisper-4x1", "whisper", (4, 1), "decode", 4, 32, 20, "full"),
    ("pixtral-4x1", "pixtral", (4, 1), "decode", 4, 32, 20, "kernel"),
    ("rg-2x2", "rg", (2, 2), "decode", 4, 32, 20, "full"),
    ("whisper-2x2", "whisper", (2, 2), "prefill", 4, 32, 0, ""),
    ("pixtral-2x2", "pixtral", (2, 2), "decode", 4, 32, 20, "full"),
    ("p-dense-2x2", "dense", (2, 2), "prefill", 4, 32, 0, ""),
    ("p-dense-b1-1x4", "dense", (1, 4), "prefill", 1, 32, 0, ""),
    ("p-g3-2x2", "g3", (2, 2), "prefill", 4, 64, 0, ""),
    ("p-moe-2x2", "moe", (2, 2), "prefill", 4, 32, 0, ""),
    ("p-xlstm-b1-2x2", "xlstm", (2, 2), "prefill", 1, 16, 0, ""),
    ("p-rg-4x1", "rg", (4, 1), "prefill", 4, 32, 0, ""),
    ("p-whisper-4x1", "whisper", (4, 1), "prefill", 4, 32, 0, ""),
    ("p-pixtral-4x1", "pixtral", (4, 1), "prefill", 4, 32, 0, ""),
]
TWO = [
    ("dense-1x2", "dense", (1, 2), "decode", 2, 32, 17, "kernel"),
    ("dense-2x1", "dense", (2, 1), "decode", 2, 32, 30, "full"),
    ("p-dense-1x2", "dense", (1, 2), "prefill", 2, 32, 0, ""),
]
REFUSED = ("rg-2x2", "whisper-2x2", "pixtral-2x2")
CASES = {c[0]: c for c in FOUR + TWO}


@functools.lru_cache(maxsize=None)
def _params(name):
    """The port's seeded weights of config ``name`` (the ranks' own
    draw) in JAX's tree."""
    import torch
    from repro_torch import interop
    from repro_torch.configs.base import ModelConfig as TConfig
    from repro_torch.models import model as tmodel
    cfg = CFGS[name]
    named = interop.named_numpy(tmodel.init_params(
        TConfig(**dataclasses.asdict(cfg)), device="cpu",
        generator=torch.Generator().manual_seed(0)))
    names, _, td = jflat(jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), cfg)))
    return td.unflatten([jnp.asarray(named[n]) for n in names])


def _port_name(jname, cfg):
    """The port's leaf name of a JAX cache leaf: JAX keeps an xLSTM
    block's state as a tuple, the port as a dict in ``*_FRESH`` order."""
    from repro_torch.models.xlstm import MLSTM_FRESH, SLSTM_FRESH
    parts = jname.split("/")
    if not parts[-1].isdigit():
        return jname
    pattern = cfg.stages()[int(parts[1])][0]
    order = list(MLSTM_FRESH if pattern[int(parts[2][3:])] == "mlstm"
                 else SLSTM_FRESH)
    return "/".join(parts[:-1] + [order[int(parts[-1])]])


@functools.lru_cache(maxsize=None)
def _inputs(key):
    """The case's numpy inputs by the port's names: a decode cache (K/V
    rows normal, recurrent states their fresh values plus 0.1 x |normal|)
    and token; or a prefill batch."""
    _, name, _, kind, B, S, pos, _ = CASES[key]
    cfg = CFGS[name]
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    out = {}
    if kind == "decode":
        fresh = jmodel.init_cache(cfg, B, S, jnp.float32)
        names, leaves, _ = jflat(fresh)
        for n, a in zip(names, leaves):
            noise = rng.standard_normal(a.shape).astype(np.float32)
            kv = n.split("/")[-1] in ("k", "v")
            out[f"cache/{_port_name(n, cfg)}"] = (
                noise if kv else np.asarray(a) + 0.1 * np.abs(noise))
        out["token"] = rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
        return out
    out["batch/tokens"] = rng.integers(0, cfg.vocab_size, (B, S),
                                       dtype=np.int32)
    if cfg.is_encoder_decoder:
        out["batch/frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.encoder_feature_dim)).astype(
                np.float32)
    if cfg.family == "vlm":
        out["batch/patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.vision_embed_dim)).astype(np.float32)
    return out


def _cache_tree(key, arrays):
    _, name, _, _, B, S, _, _ = CASES[key]
    cfg = CFGS[name]
    names, _, td = jflat(jax.eval_shape(
        lambda: jmodel.init_cache(cfg, B, S, jnp.float32)))
    return td.unflatten([jnp.asarray(arrays[f"cache/{_port_name(n, cfg)}"])
                         for n in names])


def _launch(tmp_path_factory, tag, world, cases):
    io = str(tmp_path_factory.mktemp(tag))
    arrays = {f"{c[0]}/{n}": a for c in cases for n, a in
              _inputs(c[0]).items()}
    np.savez(os.path.join(io, "inputs.npz"), **arrays)
    with open(os.path.join(io, "configs.json"), "w") as f:
        json.dump({n: dataclasses.asdict(c) for n, c in CFGS.items()}, f)
    with open(os.path.join(io, "serving.json"), "w") as f:
        json.dump([dict(key=k, cfg=n, mesh=m, kind=kd, B=B, S=S, pos=p,
                        impl=i) for k, n, m, kd, B, S, p, i in cases], f)
    return Launch(io, world, ["serving"])


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    runs = {"four": _launch(tmp_path_factory, "serving4", 4, FOUR),
            "two": _launch(tmp_path_factory, "serving2", 2, TWO)}
    yield runs
    for run in runs.values():
        run.kill()


@functools.lru_cache(maxsize=None)
def _reference(key):
    """JAX's single-device step of the case: (logits, cache leaves by
    name)."""
    _, name, _, kind, B, S, pos, _ = CASES[key]
    cfg, params, arrays = CFGS[name], _params(name), _inputs(key)
    if kind == "decode":
        logits, cache = jax.jit(lambda p, c, t: jmodel.decode_step(
            p, cfg, c, t, pos, attn_impl="chunked"))(
                params, _cache_tree(key, arrays), jnp.asarray(arrays["token"]))
    else:
        batch = {k.split("/")[1]: jnp.asarray(a) for k, a in arrays.items()}
        logits, cache = jax.jit(lambda p, b: jmodel.prefill(p, cfg, b))(
            params, batch)
    names, leaves, _ = jflat(cache)
    return np.asarray(logits), {_port_name(n, cfg): np.asarray(a)
                                for n, a in zip(names, leaves)}


def _ranks(run):
    io = run.done()
    out = [dict(np.load(os.path.join(io, f"serving.r{r}.npz")))
           for r in range(run.world)]
    assert len({str(o["digest"]) for o in out}) == 1, "ranks gathered " \
        "different outputs"
    return out[0], json.loads(str(out[0]["result"]))


def _run_of(launches, key):
    return launches["four" if key in dict((c[0], c) for c in FOUR)
                    else "two"]


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max |diff| {err} vs {scale}"


DECODE = [c[0] for c in FOUR + TWO if c[3] == "decode" and c[0] not in REFUSED]
PREFILL = [c[0] for c in FOUR + TWO if c[3] == "prefill"
           and c[0] not in REFUSED]


@pytest.mark.parametrize("key", DECODE)
def test_decode_setup_matches_jax(launches, key):
    want_logits, want_cache = _reference(key)
    arrays, res = _ranks(_run_of(launches, key))
    assert "error" not in res[key], res[key]
    _close(arrays[f"{key}|logits"], want_logits, "logits")
    _, name, _, _, B, S, pos, _ = CASES[key]
    cfg, given = CFGS[name], _inputs(key)
    for n, want in want_cache.items():
        got = arrays[f"{key}|cache|{n}"]
        assert got.shape == want.shape, n
        _close(got, want, n)
        if n.split("/")[-1] in ("k", "v") and n.startswith("stages"):
            # every row but the written slot keeps its bits
            ring = got.shape[2] < S
            slot = pos % got.shape[2] if ring else pos
            keep = np.ones(got.shape[2], bool)
            keep[slot] = False
            assert np.array_equal(got[:, :, keep],
                                  given[f"cache/{n}"][:, :, keep]), n


@pytest.mark.parametrize("key", PREFILL)
def test_prefill_setup_matches_jax(launches, key):
    want_logits, want_cache = _reference(key)
    arrays, res = _ranks(_run_of(launches, key))
    assert "error" not in res[key], res[key]
    _close(arrays[f"{key}|logits"], want_logits, "logits")
    for n, want in want_cache.items():
        got = arrays[f"{key}|cache|{n}"]
        assert got.shape == want.shape, n
        _close(got, want, n)


@pytest.mark.parametrize("key", REFUSED)
def test_tensor_parallel_over_4b_blocks_is_refused(launches, key):
    _, res = _ranks(launches["four"])
    assert "item 4b" in res[key]["error"], res[key]


# per case: whether the sequence of some attention cache splits (the
# merge's all-gather runs), and whether q heads are gathered
MERGE = {"dense-2x2": False, "dense-1x4": True, "dense-b1-2x2": True,
         "dense-4x1": False, "g3-2x2": True, "g3-b1-4x1": True,
         "moe-2x2": True, "rg-4x1": False, "whisper-4x1": False,
         "pixtral-4x1": False, "dense-1x2": True, "dense-2x1": False}


@pytest.mark.parametrize("key", sorted(MERGE))
def test_merge_collectives_where_the_sequence_splits(launches, key):
    """The softmax merge's all-gather (B * H * (hd + 1) * 4 bytes a rank
    and attention layer) runs where a cache's sequence dim splits and
    nowhere else; the xLSTM states' all-gather where they split."""
    _, res = _ranks(_run_of(launches, key))
    counts = res[key]["counts"]
    _, name, mesh, _, B, S, _, _ = CASES[key]
    cfg = CFGS[name]
    merge = counts.get("decode/all_gather")
    if not MERGE[key]:
        assert merge is None, counts
        return
    n_attn = sum(t in ("global", "local") for t in cfg.layer_types())
    B_local = B // mesh[0] if B % mesh[0] == 0 and mesh[0] > 1 else B
    assert merge == [n_attn, n_attn * B_local * cfg.num_heads
                     * (cfg.resolved_head_dim + 1) * 4], counts


def test_xlstm_states_are_gathered_at_batch_one(launches):
    _, res = _ranks(launches["four"])
    counts = res["xlstm-b1-2x2"]["counts"]
    assert counts.get("decode/state_all_gather", [0])[0] > 0, counts
    assert "decode/all_gather" not in counts
