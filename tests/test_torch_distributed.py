"""The port's distributed training step on CPU ranks (gloo), against the
JAX package's single-device step.

Each launch starts its rank processes (``tests/torch_dist_ranks.py``,
``PYTHONPATH=src``, ``RANK`` / ``WORLD_SIZE``); they meet through a
``file://`` rendezvous under the test's temporary directory, so xdist
workers cannot collide on a port, and are killed when the launch's time
limit runs out.  The JAX references run here, on one CPU device — the
step JAX's own ``tests/test_distributed.py`` holds its sharded step to.
The test writes the JAX weights and batches for the ranks (the other
families' cases start both packages from the port's seeded weights);
the ranks write their gathered outputs back.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import trainers as jtrainers
from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import get_config as jget_config
from repro.configs.shapes import ShapeConfig
from repro.launch.specs import concrete_batch, input_specs
from repro.launch.train import reduce_config
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.optim.adam import Adam as JAdam
from repro.runtime import compression as jcomp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_ranks.py")
LIMIT = 120          # seconds per launch

# JAX's tests/test_distributed.py config, sparsity and active fraction
DENSE = JConfig(name="dense", family="dense", num_layers=4, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                remat=False, dtype="float32")
# JAX's K/L-scaling config (the ranks draw its weights themselves)
WIDE = JConfig(name="wide", family="dense", num_layers=8, d_model=256,
               num_heads=4, num_kv_heads=4, d_ff=1024, vocab_size=2048,
               remat=False, dtype="float32")
XLSTM = jget_config("xlstm-1.3b").replace(
    name="xlstm", num_layers=8, d_model=64, num_heads=2, num_kv_heads=2,
    vocab_size=256, dtype="float32", remat=False)
# JAX's MoE island config, with a shared expert folded into the
# expert-parallel all-reduce
MOE = JConfig(name="moe", family="moe", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=2, d_ff=0, vocab_size=64,
              num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
              shared_expert_d_ff=64, capacity_factor=16.0, remat=False,
              dtype="float32")
MOE_DROPS = dataclasses.replace(MOE, name="moe_drops", capacity_factor=1.0,
                                shared_expert_d_ff=0)
SPARSITY, K_FRAC = 0.8, 0.5
# every other family, reduced by 8 in f32, from the port's seeded
# weights (which the ranks draw themselves).  The MoE archs at a capacity
# that drops no pair and with no router aux loss: per-shard capacity
# drops other pairs, and the data mean of per-shard aux losses is another
# function, than one device over the whole batch (GShard, as JAX's
# island; both held against JAX in the MoE island test)
FAMILY_ARCHS = ("recurrentgemma-2b", "whisper-large-v3", "pixtral-12b",
                "granite-moe-3b-a800m", "qwen2-moe-a2.7b", "gemma3-1b")


def _family_cfg(arch):
    cfg = reduce_config(jget_config(arch), 8).replace(dtype="float32")
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=cfg.num_experts
                          / cfg.num_experts_per_tok, router_aux_coef=0.0)
    return cfg


def _named(tree):
    names, leaves, _ = jflat(tree)
    return {n: np.asarray(l) for n, l in zip(names, leaves)}


@functools.lru_cache(maxsize=None)
def _jax_params(cfg):
    return jmodel.init_params(jax.random.PRNGKey(0), cfg)


def _batch(cfg, B, S, key):
    b = concrete_batch(cfg, {"tokens": jax.ShapeDtypeStruct((B, S),
                                                             jnp.int32)},
                       key=jax.random.PRNGKey(key))
    return {"tokens": b["tokens"] % cfg.vocab_size}


@functools.lru_cache(maxsize=None)
def _family_params(arch):
    """The port's seeded weights of ``arch`` (the ranks' own draw) in
    JAX's tree."""
    import torch
    from repro_torch import interop
    from repro_torch.configs.base import ModelConfig as TConfig
    from repro_torch.models import model as tmodel
    cfg = _family_cfg(arch)
    named = interop.named_numpy(tmodel.init_params(
        TConfig(**dataclasses.asdict(cfg)), device="cpu",
        generator=torch.Generator().manual_seed(0)))
    names, _, td = jflat(jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), cfg)))
    return td.unflatten([jnp.asarray(named[n]) for n in names])


@functools.lru_cache(maxsize=None)
def _family_batch(arch):
    cfg = _family_cfg(arch)
    shape = ShapeConfig("t", 32, 8, "train")
    return concrete_batch(cfg, input_specs(cfg, shape, dtype=jnp.float32),
                          key=jax.random.PRNGKey(1))


def _pinned_factors(tree, seed=0):
    """LoRA factors shaped as ``tree`` from a fixed numpy seed (``A``
    normal / sqrt(m), ``B`` zero: ``lora_init``'s distributions): JAX's
    own ``lora_init`` folds Python's salted ``hash`` into its key, so
    its draw differs from process to process."""
    rng = np.random.RandomState(seed)

    def draw(f):
        if f is None:
            return None
        m = f["A"].shape[-2]
        return {"A": jnp.asarray(rng.standard_normal(f["A"].shape)
                                 / np.sqrt(m), jnp.float32),
                "B": jnp.zeros(f["B"].shape, jnp.float32)}

    return jax.tree.map(draw, tree, is_leaf=lambda x: x is None or (
        isinstance(x, dict) and "A" in x))


@functools.lru_cache(maxsize=None)
def _lora_factors():
    core = jtrainers.make("lora", DENSE)
    return _pinned_factors(core.init(jax.random.PRNGKey(0),
                                     _jax_params(DENSE)).arrays["factors"])


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    arrays = {}
    for cfg in (DENSE, XLSTM):
        for n, a in _named(_jax_params(cfg)).items():
            arrays[f"{cfg.name}/params/{n}"] = a
    arrays["dense/tokens"] = np.asarray(_batch(DENSE, 8, 32, 1)["tokens"])
    arrays["xlstm/tokens"] = np.asarray(_batch(XLSTM, 8, 32, 1)["tokens"])
    arrays["wide/tokens"] = rng.integers(0, WIDE.vocab_size, (8, 32),
                                         dtype=np.int32)
    for arch in FAMILY_ARCHS:
        for k, a in _family_batch(arch).items():
            arrays[f"{arch}/batch/{k}"] = np.asarray(a)
    for n, a in _named(_lora_factors()).items():
        arrays[f"lora/factors/{n}"] = a
    for n, a in _named(jmoe.moe_init(jax.random.PRNGKey(0), MOE)).items():
        arrays[f"moe/{n}"] = a
    arrays["moe/x"] = rng.standard_normal((8, 16, 32)).astype(np.float32)
    arrays["ef/g_equal"] = rng.standard_normal((64, 64)).astype(np.float32)
    arrays["ef/g"] = rng.standard_normal((4, 64, 64)).astype(np.float32)
    arrays["ef/e"] = (rng.standard_normal((4, 64, 64)) * 0.01).astype(
        np.float32)
    arrays["ef/gb"] = rng.standard_normal((4, 300)).astype(np.float32)
    arrays["ef/eb"] = (rng.standard_normal((4, 300)) * 0.01).astype(
        np.float32)
    return arrays


class Launch:
    """``world`` rank processes over ``scenarios`` in ``io``, started at
    once; ``done()`` waits for them (killing them all at LIMIT after the
    start) and returns ``io``.  The test process computes its JAX
    references while the ranks run."""

    def __init__(self, io, world, scenarios):
        self.io, self.world = io, world
        env = dict(os.environ, PYTHONPATH="src", WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1")
        env.pop("JAX_PLATFORMS", None)
        self.logs = [open(os.path.join(io, f"rank{r}.log"), "w")
                     for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, io, ",".join(scenarios)], cwd=REPO,
            env=dict(env, RANK=str(r)), stdout=self.logs[r],
            stderr=subprocess.STDOUT) for r in range(world)]
        self.deadline = time.monotonic() + LIMIT

    def done(self):
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            self.kill()
        tails = [open(os.path.join(self.io, f"rank{r}.log")).read()[-3000:]
                 for r in range(self.world)]
        assert all(p.returncode == 0 for p in self.procs), tails
        return self.io

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()


def _prepare(tmp_path_factory, name, prefix=""):
    io = str(tmp_path_factory.mktemp(name))
    np.savez(os.path.join(io, "inputs.npz"),
             **{k: a for k, a in _inputs().items() if k.startswith(prefix)})
    with open(os.path.join(io, "configs.json"), "w") as f:
        json.dump({c.name: dataclasses.asdict(c) for c in
                   (DENSE, WIDE, XLSTM, MOE, MOE_DROPS)
                   + tuple(map(_family_cfg, FAMILY_ARCHS))}, f)
    return io


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both launches, running side by side from the first test on."""
    runs = {"four": Launch(_prepare(tmp_path_factory, "four_ranks"), 4, [
                "blockllm_2x2", "blockllm_4x1", "blockllm_1x4",
                "blockllm_q8_2x2", "xlstm", "moe_island", "compressed",
                "cores", "kl_scaling", "families"]),
            "two": Launch(_prepare(tmp_path_factory, "two_ranks",
                                   "dense/"), 2, ["q8_bitwise"])}
    yield runs
    for run in runs.values():
        run.kill()


@pytest.fixture
def four(launches, jax_dense, jax_dense_q8, jax_xlstm, jax_families,
         jax_cores):
    """The 4-rank launch; the slowest JAX references are computed while
    it runs."""
    return launches["four"]


@pytest.fixture
def two(launches):
    return launches["two"]


def _read(run, scenario):
    io = run.done()
    return [dict(np.load(os.path.join(io, f"{scenario}.r{r}.npz")))
            for r in range(run.world)]


def _jax_lowered(cfg, batch, optimizer="blockllm", params=None, **hyper):
    """JAX's single-device step (``build_step_fn`` through the core's
    ``lowerable``) from ``init``'s state over ``params`` (default: JAX's
    weights; LoRA: with the pinned factors): its outputs and the state's
    meta."""
    core = jtrainers.make(optimizer, cfg, sparsity=SPARSITY, k_frac=K_FRAC,
                          policy="static", attn_impl="full", **hyper)
    state = core.init(jax.random.PRNGKey(0),
                      _jax_params(cfg) if params is None else params)
    if optimizer == "lora":
        state.arrays["factors"] = _lora_factors()
        state.arrays["opt"] = core.adam.init(_lora_factors())
    low = core.lowerable(state, dict(batch))
    return jax.jit(low.fn)(*low.args), state.meta


def _jax_step(out, meta):
    """A BlockLLM step's loss, selected rows and selection."""
    sel, _, _, loss, *_ = out
    idx = {k: [int(x) for x in v] for k, v in meta["stack_idx"].items()}
    return float(loss), [np.asarray(a, np.float32)
                         for a in jflat(sel)[1]], idx


@pytest.fixture(scope="module")
def jax_cores():
    """Every core's single-device step on DENSE from JAX's weights."""
    return {name: _jax_lowered(DENSE, _batch(DENSE, 8, 32, 1), name)
            for name in jtrainers.names()}


@pytest.fixture(scope="module")
def jax_dense(jax_cores):
    return _jax_step(*jax_cores["blockllm"])


@pytest.fixture(scope="module")
def jax_dense_q8(jax_cores):
    return _jax_step(*jax_cores["blockllm+q8"])


@pytest.fixture(scope="module")
def jax_xlstm():
    return _jax_step(*_jax_lowered(
        XLSTM, {"tokens": _batch(XLSTM, 8, 32, 1)["tokens"][:, :16]},
        adam=JAdam(lr=1e-3, eps=1e-3)))


@pytest.fixture(scope="module")
def jax_families():
    """Adam's eps is 1e-3 here, as in the xLSTM case (see there)."""
    return {arch: _jax_step(*_jax_lowered(
        _family_cfg(arch), _family_batch(arch),
        params=_family_params(arch), adam=JAdam(lr=1e-3, eps=1e-3)))
        for arch in FAMILY_ARCHS}


def _check_against_jax(results, ref):
    loss, sel, idx = ref
    for r in results:
        assert json.loads(str(r["stack_idx"])) == idx
        np.testing.assert_allclose(float(r["loss"]), loss, rtol=2e-4)
        got = [r[f"sel{i}"] for i in range(len(sel))]
        assert f"sel{len(sel)}" not in r
        for a, b in zip(got, sel):
            np.testing.assert_allclose(a, b, atol=3e-4)


@pytest.mark.parametrize("scenario", ["blockllm_2x2", "blockllm_4x1",
                                      "blockllm_1x4"])
def test_sharded_blockllm_step_matches_jax(four, jax_dense, scenario):
    """Tensor x data parallel (2, 2), pure data parallel with ZeRO (4, 1)
    and a model axis of 4 over 2 K/V heads (1, 4: K/V replicated beside
    split query heads): every rank's gathered loss and selected rows
    equal JAX's single-device step within JAX's own bounds."""
    _check_against_jax(_read(four, scenario), jax_dense)


def test_tensor_parallel_step_communicates_over_both_groups(four):
    counts = json.loads(str(_read(four, "blockllm_2x2")[0]["counts"]))
    assert counts["tp/all_reduce"][0] > 0
    assert counts["grad/reduce_scatter"][0] == 1
    assert counts["grad/all_reduce"][0] <= 1
    c41 = json.loads(str(_read(four, "blockllm_4x1")[0]["counts"]))
    assert "tp/all_reduce" not in c41


def test_q8_blockllm_runs_on_2x2_like_one_process(four, jax_dense_q8):
    """``blockllm+q8`` on (2, 2) against JAX's single-device step, within
    the bounds JAX holds its sharded step to."""
    _check_against_jax(_read(four, "blockllm_q8_2x2"), jax_dense_q8)


@pytest.mark.parametrize("fused", ["off", "plain"])
def test_q8_update_over_block_chunks_is_bitwise_single_device(two, fused):
    """(2, 1), equal batch shards: the reduced gradient is each rank's
    own, and the Q8 update over ZeRO chunks of whole codec blocks equals
    the single-device update bit for bit (rows, codes, scales, masks and
    the loss)."""
    for r in _read(two, "q8_bitwise"):
        res = json.loads(str(r["result"]))[fused]
        assert res["rows_and_moments_bitwise"] and res["leaves"] > 0
        assert res["loss_bitwise"]


def test_every_core_runs_on_4x1(four, jax_cores):
    """Every registered core's distributed step on (4, 1) against the
    same step on one process (within 1e-5), and against JAX's
    single-device step (JAX's sharded-step bounds): the loss and every
    floating output before it (updated weights, factors, projections,
    moments and Q8 scales), by leaf name."""
    from repro_torch.trainers import names
    out = _read(four, "cores")
    res = [json.loads(str(r["result"])) for r in out]
    assert sorted(res[0]) == names() and len(names()) == 8
    assert sorted(jax_cores) == names()
    for r, per_rank in zip(out, res):
        for name, got in per_rank.items():
            np.testing.assert_allclose(got["loss"], got["loss_single"],
                                       rtol=1e-5, err_msg=name)
            assert got["max_diff"] <= 1e-5, (name, got["max_diff"])
            ref = jax_cores[name][0]
            at = got["loss_at"]
            np.testing.assert_allclose(got["loss"], float(ref[at]),
                                       rtol=2e-4, err_msg=name)
            want = {}
            for i in range(at):
                names_i, vals, _ = jflat(ref[i])
                want.update({f"{i}/{n}": np.asarray(v, np.float32)
                             for n, v in zip(names_i, vals)
                             if jnp.issubdtype(v.dtype, jnp.floating)})
            assert got["leaves"] == sorted(want), name
            for k in got["leaves"]:
                a, b = r[f"{name}|{k}"], want[k]
                if name == "galore" and ("/.proj/" in k or "/.mu/" in k):
                    # LAPACK in the two packages picks other signs for
                    # some projector columns (ROADMAP C): the projector
                    # and the first moment in its space agree up to
                    # those signs; the updated weights do not see them
                    a, b = np.abs(a), np.abs(b)
                np.testing.assert_allclose(a, b, atol=3e-4,
                                           err_msg=(name, k))
            grad = {k: v for k, v in got["counts"].items()
                    if k.startswith("grad/")}
            assert grad, name
    zero = res[0]["adam"]["counts"]
    assert zero["grad/reduce_scatter"][0] == 1, zero
    assert zero["zero/all_gather"][0] > 0


def test_every_family_runs_data_and_tensor_parallel(four, jax_families):
    """Data parallelism with ZeRO for every other family on (4, 1) — the
    RG-LRU scan on a batch shard, whisper, pixtral, MoE, local attention
    — and tensor parallelism on (2, 2) where the port splits the blocks
    (expert TP with a folded shared expert, K/V replicated beside local
    windows, a tied vocab-parallel head), each against JAX's
    single-device step within JAX's sharded-step bounds."""
    outs = _read(four, "families")
    # every rank gathered the same rows (rank 0 wrote them)
    assert len({str(o["digest"]) for o in outs}) == 1
    for rank, out in enumerate(outs):
        res = json.loads(str(out["result"]))
        assert len(res) == 9
        for key, r in res.items():
            loss, sel, idx = jax_families[key.split("@")[0]]
            assert r["stack_idx"] == idx, key
            np.testing.assert_allclose(r["loss"], loss, rtol=2e-4,
                                       err_msg=key)
            assert r["n_sel"] == len(sel), key
            for i, b in enumerate(sel if rank == 0 else ()):
                np.testing.assert_allclose(out[f"{key}|sel{i}"], b,
                                           atol=3e-4, err_msg=(key, i))
            assert (r["tp"] > 0) == key.endswith("(2, 2)"), (key, r["tp"])


def test_xlstm_pure_dp_matches_jax_with_one_reduction_per_bucket(four,
                                                                jax_xlstm):
    """xLSTM over all 4 ranks of a (2, 2) mesh against JAX's step; the
    gradient collectives are one per bucket per step (a reduce-scatter
    into the ZeRO chunks, an all-reduce of the rest), the same at 16 and
    32 tokens: nothing is reduced inside the sLSTM time loop.  Adam's
    eps is 1e-3 on both sides (as the port's trajectory tests): at 1e-8
    the first step's ``g / (|g| + eps)`` flips sign on gradients near
    zero, which the ranks' other order of sums can move."""
    res = _read(four, "xlstm")
    _check_against_jax(res, jax_xlstm)
    counts = json.loads(str(res[0]["counts"]))
    for S in ("16", "32"):
        grad = {k: v[0] for k, v in counts[S].items()
                if k.startswith("grad/")}
        assert grad == {"grad/reduce_scatter": 1, "grad/all_reduce": 1}, grad
        assert "tp/all_reduce" not in counts[S]


def test_moe_island_matches_unsharded_and_per_shard_capacity(four):
    """(2, 2): per-shard dispatch and expert tensor parallelism equal the
    unsharded ``moe_apply`` with no drops (atol 2e-4, JAX's bound);
    (4, 1) with drops: JAX's ``moe_apply`` on each data shard alone
    (GShard's per-shard capacity).  The aux loss on both is the mean of
    JAX's per-shard aux losses over the data shards (JAX's island
    ``pmean``)."""
    x = jnp.asarray(np.asarray(_inputs()["moe/x"]))
    p = jmoe.moe_init(jax.random.PRNGKey(0), MOE)
    y_ref, _ = jmoe.moe_apply(p, x, MOE, token_chunk=16)
    # the aux loss: the mean over the data shards of each shard's own
    aux_ref = np.mean([float(jmoe.moe_apply(p, x[4 * r:4 * r + 4], MOE)[1])
                       for r in range(2)])
    pd = {k: v for k, v in p.items() if k != "shared"}
    shards = [jmoe.moe_apply(pd, x[2 * r:2 * r + 2], MOE_DROPS)
              for r in range(4)]
    y_shard = jnp.concatenate([y for y, _ in shards])
    aux_shard = np.mean([float(a) for _, a in shards])
    y_whole, _ = jmoe.moe_apply(pd, x, MOE_DROPS)
    assert float(jnp.abs(y_shard - y_whole).max()) > 1e-3  # drops differ
    for r in _read(four, "moe_island"):
        np.testing.assert_allclose(r["y"], np.asarray(y_ref), atol=2e-4)
        np.testing.assert_allclose(float(r["aux"]), aux_ref, rtol=1e-5)
        np.testing.assert_allclose(r["y_drops"], np.asarray(y_shard),
                                   atol=2e-4)
        np.testing.assert_allclose(float(r["aux_drops"]), aux_shard,
                                   rtol=1e-5)
        assert int(r["dropped"]) > 0


def test_compressed_allreduce_matches_jax(four):
    from jax.sharding import Mesh
    inp = _inputs()
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    g = {"w": jnp.asarray(inp["ef/g_equal"])}
    mean_eq, err_eq = jax.jit(lambda g, e: jcomp.compressed_psum_tree(
        g, e, mesh, ("data",)))(g, jcomp.init_errors(g))
    deqs, errs, codes = {"w": [], "b": []}, {"w": [], "b": []}, []
    for r in range(4):
        for k, gk, ek in (("w", "ef/g", "ef/e"), ("b", "ef/gb", "ef/eb")):
            gc = jnp.asarray(inp[gk][r]) + jnp.asarray(inp[ek][r])
            q, s = jcomp.quantize_int8(gc)
            d = jcomp.dequantize_int8(q, s, gc.shape)
            deqs[k].append(np.asarray(d, np.float64))
            errs[k].append(np.asarray(gc - d))
            if k == "w":
                codes.append((np.asarray(q), np.asarray(s)))
    # the errors against JAX's codec outside jit: XLA fuses the jitted
    # ``gc - q * s`` into one multiply-add (other bits, ~1 ulp)
    qe, se = jcomp.quantize_int8(g["w"])
    err_codec = np.asarray(g["w"] - jcomp.dequantize_int8(qe, se, (64, 64)))
    np.testing.assert_allclose(err_codec, np.asarray(err_eq["w"]),
                               atol=1e-6)
    res = _read(four, "compressed")
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["mean_eq"], np.asarray(mean_eq["w"]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(out["err_eq"], err_codec)
        for k in ("w", "b"):
            np.testing.assert_allclose(out[f"mean_{k}"],
                                       np.mean(deqs[k], axis=0), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_array_equal(out[f"err_{k}"], errs[k][r])
        np.testing.assert_array_equal(out["codes"], codes[r][0])
        np.testing.assert_array_equal(out["scales"], codes[r][1])
        # every rank holds the same bits
        np.testing.assert_array_equal(out["mean_w"], res[0]["mean_w"])
    counts = json.loads(str(res[0]["counts"]))
    # int8 codes + f32 scales of both leaves, each rank's contribution
    wire = 64 * 64 + 16 * 4 + 512 + 2 * 4
    assert counts["ef/all_gather"] == [4, wire]


def test_blockllm_scales_dp_gradient_bytes_with_active_fraction(four):
    """JAX's condition from ``test_blockllm_scales_dp_allreduce_with_
    active_fraction`` (an xfail there: GSPMD reduces inside the layer
    scan); the port reduces the active rows only, once per step."""
    res = json.loads(str(_read(four, "kl_scaling")[0]["result"]))
    small, large = res["0.125"], res["1.0"]
    assert small < 0.6 * large, (small, large)
