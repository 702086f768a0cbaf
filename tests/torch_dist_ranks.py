"""One rank of the port's multi-rank CPU checks (gloo).

Run by ``tests/test_torch_distributed.py``, one process per rank:

    RANK=r WORLD_SIZE=n PYTHONPATH=src python tests/torch_dist_ranks.py \
        <io dir> <scenario>[,<scenario>...]

The ranks meet through a ``file://`` rendezvous in ``<io dir>``, read
their inputs (written by the test from the JAX package's references)
from ``<io dir>/inputs.npz`` and ``<io dir>/configs.json``, and each
writes ``<io dir>/<scenario>.r<rank>.npz``.  This module imports the
port only (torch and numpy), never JAX.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import _flatten_with_names
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model, moe
from repro_torch.optim.adam import Adam
from repro_torch.runtime import compression, shard_ctx, sharding

IO = sys.argv[1]
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
INPUTS = np.load(os.path.join(IO, "inputs.npz"))     # read per key
CONFIGS = json.load(open(os.path.join(IO, "configs.json")))


def cfg_of(name: str) -> ModelConfig:
    return ModelConfig(**CONFIGS[name])


def tensor(key: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(INPUTS[key]))


def params_of(name: str, cfg: ModelConfig):
    """The JAX package's weights (saved by leaf path) in the port's tree;
    the port's own seeded draw where the test saved none."""
    tree = model.init_params(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    names, _, td = _flatten_with_names(tree)
    if f"{name}/params/{names[0]}" not in INPUTS:
        return tree
    return td.unflatten([tensor(f"{name}/params/{n}") for n in names])


def flat(tree):
    return [np.asarray(t.detach().float()) for t in
            _flatten_with_names(tree)[1]]


def save(scenario: str, **arrays):
    np.savez(os.path.join(IO, f"{scenario}.r{RANK}.npz"), **arrays)


def run_setup(cfg, mesh_shape, optimizer, batch, *, patch=None, **hyper):
    """Build the distributed step of ``optimizer``, run it once from the
    state ``init`` gives the JAX weights (then ``patch(core, state)``),
    and gather the outputs."""
    mesh = mesh_lib.make_host_mesh(mesh_shape[1], device_type="cpu")
    B, S = batch["tokens"].shape
    shape = ShapeConfig("t", seq_len=S, global_batch=B, kind="train")
    kw = dict(sparsity=0.8, k_frac=0.5, attn_impl="full", device="cpu")
    kw.update(hyper)
    setup = steps.build_train_setup(cfg, shape, mesh, optimizer=optimizer,
                                    param_dtype=torch.float32, **kw)
    core = setup.meta["core"]

    state = core.init(torch.Generator("cpu").manual_seed(0),
                      params_of(cfg.name, cfg))
    if patch is not None:
        patch(core, state)
    local = setup.shard(core.lowerable(state, dict(batch)).args)
    shard_ctx.reset_collectives()
    out = setup(*local)
    counts = {k: list(v) for k, v in shard_ctx.COLLECTIVES.items()}
    shard_ctx.reset_collectives()
    if optimizer.endswith("+q8") and mesh_shape[1] > 1:
        # Q8 codes of a model-split leaf are the local shard's own blocks
        out = tuple(None if i is not None and setup.roles[i] == "opt" else o
                    for o, i in zip(out, setup.out_args))
    return setup, state, setup.gather(out), counts


# --------------------------------------------------------------------- #
# scenarios
# --------------------------------------------------------------------- #


def blockllm(scenario, mesh_shape, optimizer="blockllm"):
    cfg = cfg_of("dense")
    batch = {"tokens": tensor("dense/tokens")}
    setup, state, full, counts = run_setup(cfg, mesh_shape, optimizer,
                                           batch)
    save(scenario, loss=np.float64(full[3]),
         stack_idx=json.dumps(state.meta["stack_idx"]),
         counts=json.dumps(counts),
         **{f"sel{i}": a for i, a in enumerate(flat(full[0]))})


def q8_bitwise(scenario):
    """blockllm+q8 on (2, 1) with both ranks' batch shards equal, so the
    reduced gradient is each rank's own: the update over ZeRO chunks of
    the codec blocks is the single-device update bit for bit (the
    unfused Q8 Adam and the kernel's plain version)."""
    from repro_torch.core.blockllm import BlockLLMConfig
    from repro_torch.core.selection import SelectorConfig
    cfg = cfg_of("dense")
    half = tensor("dense/tokens")[:4]
    res = {}
    for fused in ("off", "plain"):
        bcfg = BlockLLMConfig(selector=SelectorConfig(
            sparsity=0.8, policy="static", static_k_frac=0.5),
            fused_update=fused)
        mesh = mesh_lib.make_host_mesh(1, device_type="cpu")
        shape = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
        setup = steps.build_train_setup(
            cfg, shape, mesh, optimizer="blockllm+q8", attn_impl="full",
            device="cpu", bcfg=bcfg, adam=Adam(lr=1e-2),
            param_dtype=torch.float32)
        core = setup.meta["core"]

        def state():
            return core.init(torch.Generator("cpu").manual_seed(0),
                             params_of("dense", cfg))

        full_args = core.lowerable(state(), {"tokens": torch.cat(
            [half, half])}).args
        out = setup.gather(setup(*setup.shard(full_args)))
        low = core.lowerable(state(), {"tokens": half})
        ref = low.fn(*low.args)
        same = [torch.equal(a, b) for a, b in zip(
            _flatten_with_names(out[:3])[1], _flatten_with_names(ref[:3])[1])]
        res[fused] = dict(rows_and_moments_bitwise=all(same),
                          leaves=len(same),
                          loss_bitwise=bool(torch.equal(out[3], ref[3])))
    save(scenario, result=json.dumps(res))


def _pin_lora_factors(core, state):
    """The LoRA factors the test drew (JAX's ``lora_init`` folds Python's
    salted ``hash`` into its key, so both packages start from one numpy
    draw instead), and fresh moments for them."""
    names, _, td = _flatten_with_names(state.arrays["factors"])
    factors = td.unflatten([tensor(f"lora/factors/{n}") for n in names])
    state.arrays["factors"] = factors
    state.arrays["opt"] = core.adam.init(factors)


def cores(scenario):
    """Every registered core on (4, 1): one distributed step from JAX's
    weights (LoRA: and the test's factors); the gathered outputs before
    the loss, by leaf name, and their largest difference from the same
    step on this process alone over the whole batch."""
    from repro_torch.trainers import names
    cfg = cfg_of("dense")
    batch = {"tokens": tensor("dense/tokens")}
    res, arrays = {}, {}
    for name in names():
        patch = _pin_lora_factors if name == "lora" else None
        setup, _, full, counts = run_setup(cfg, (4, 1), name, batch,
                                           patch=patch)
        core = setup.meta["core"]
        state = core.init(torch.Generator("cpu").manual_seed(0),
                          params_of("dense", cfg))
        if patch is not None:
            patch(core, state)
        single = setup.fn(*core.lowerable(state, dict(batch)).args)
        loss_at = setup.out_args.index(None)
        leaves, diffs = {}, [0.0]
        for i in range(loss_at):
            for n, a, b in zip(*_flatten_with_names(full[i])[:2],
                               _flatten_with_names(single[i])[1]):
                if a.dtype.is_floating_point:
                    leaves[f"{i}/{n}"] = np.asarray(a.detach().float())
                    diffs.append(float((a.float() - b.float()).abs().max()))
        arrays.update({f"{name}|{k}": a for k, a in leaves.items()})
        res[name] = dict(loss=float(full[loss_at]),
                         loss_single=float(single[loss_at]),
                         max_diff=max(diffs), loss_at=loss_at,
                         leaves=sorted(leaves), counts=counts)
    save(scenario, result=json.dumps(res), **arrays)


FAMILIES = {(4, 1): ("recurrentgemma-2b", "whisper-large-v3", "pixtral-12b",
                     "granite-moe-3b-a800m", "qwen2-moe-a2.7b", "gemma3-1b"),
            (2, 2): ("granite-moe-3b-a800m", "qwen2-moe-a2.7b",
                     "gemma3-1b")}


def families(scenario):
    """Every other family reduced by 8 (the test's configs and JAX's
    batch; the port's seeded weights, which the test hands JAX too): data parallelism with ZeRO on (4, 1) (the RG-LRU
    scan on a batch shard, the encoder-decoder, the VLM, MoE, local
    attention) and tensor parallelism on (2, 2) where the port splits
    the blocks (MoE with expert TP and a folded shared expert, heads
    that do not divide the model axis, a tied vocab-parallel head).
    Rank 0 writes the gathered rows, every rank their digest."""
    res, arrays = {}, {}
    for mesh_shape, archs in FAMILIES.items():
        for arch in archs:
            cfg = cfg_of(arch)
            batch = {k: tensor(f"{arch}/batch/{k}")
                     for k in ("tokens", "frames", "patch_embeds")
                     if f"{arch}/batch/{k}" in INPUTS}
            _, state, full, counts = run_setup(
                cfg, mesh_shape, "blockllm", batch,
                adam=Adam(lr=1e-3, eps=1e-3))
            key = f"{arch}@{mesh_shape}"
            sel = flat(full[0])
            arrays.update({f"{key}|sel{i}": a for i, a in enumerate(sel)})
            res[key] = dict(loss=float(full[3]), n_sel=len(sel),
                            stack_idx=state.meta["stack_idx"],
                            tp=counts.get("tp/all_reduce", [0, 0])[0])
    # every rank gathers the same rows: rank 0 writes them, the others
    # their digest
    digest = hashlib.sha256()
    for k in sorted(arrays):
        digest.update(k.encode() + arrays[k].tobytes())
    save(scenario, result=json.dumps(res), digest=digest.hexdigest(),
         **(arrays if RANK == 0 else {}))


def kl_scaling(scenario):
    """DP gradient bytes of the BlockLLM step at k_frac 1/8 and 8/8."""
    cfg = cfg_of("wide")
    batch = {"tokens": tensor("wide/tokens")}
    res = {}
    for k in (0.125, 1.0):
        *_, counts = run_setup(cfg, (4, 1), "blockllm", batch, sparsity=0.5,
                               k_frac=k)
        res[str(k)] = sum(v[1] for key, v in counts.items()
                          if key.startswith("grad/"))
    save(scenario, result=json.dumps(res))


def xlstm(scenario):
    """Pure data parallel over all 4 ranks of a (2, 2) mesh; the
    gradient collectives of one step at two sequence lengths."""
    cfg = cfg_of("xlstm")
    res = {}
    for S in (16, 32):
        batch = {"tokens": tensor("xlstm/tokens")[:, :S]}
        setup, state, full, counts = run_setup(
            cfg, (2, 2), "blockllm", batch, adam=Adam(lr=1e-3, eps=1e-3))
        res[S] = counts
        if S == 16:
            arrays = {f"sel{i}": a for i, a in enumerate(flat(full[0]))}
            loss = float(full[3])
            idx = state.meta["stack_idx"]
    save(scenario, loss=np.float64(loss), counts=json.dumps(res),
         stack_idx=json.dumps(idx), **arrays)


def _moe_local(cfg, mesh_shape, x):
    mesh = mesh_lib.make_host_mesh(mesh_shape[1], device_type="cpu")
    rules = steps._rules_for(mesh, cfg)
    p = {k: tensor(f"moe/{k}") for k in ("router", "w_gate", "w_up",
                                          "w_down")}
    if cfg.shared_expert_d_ff:
        p["shared"] = {k: tensor(f"moe/shared/{k}")
                       for k in ("w_gate", "w_up", "w_down")}
    specs = sharding.param_specs(cfg, p, mesh)
    pl = _flatten_with_names(p)
    sl = _flatten_with_names(specs)[1]
    p_loc = pl[2].unflatten([steps.local_slice(
        t, steps.Layout.of(s, mesh), rules).contiguous()
        for t, s in zip(pl[1], sl)])
    x_loc = steps.local_slice(
        x, steps.Layout.of(shard_ctx.P(rules.dp_axes), mesh), rules)
    from repro_torch.runtime.moe_parallel import moe_apply_maybe_sharded
    with shard_ctx.use(rules), moe.route_log() as log:
        y, aux = moe_apply_maybe_sharded(p_loc, x_loc.contiguous(), cfg)
        y = shard_ctx.all_gather(y, rules.dp_axes, "test/all_gather")
    return y, aux, log.dropped


def moe_island(scenario):
    x = tensor("moe/x")
    y, aux, _ = _moe_local(cfg_of("moe"), (2, 2), x)
    y2, aux2, dropped = _moe_local(cfg_of("moe_drops"), (4, 1), x)
    save(scenario, y=y.numpy(), aux=np.float64(aux), y_drops=y2.numpy(),
         aux_drops=np.float64(aux2), dropped=np.int64(dropped))


def compressed(scenario):
    """The int8 error-feedback all-reduce over 4 ranks: equal replicas,
    then a different gradient and error on each rank."""
    mesh = mesh_lib.make_host_mesh(1, device_type="cpu")
    rules = steps._rules_for(mesh)
    g = {"w": tensor("ef/g_equal")}
    with shard_ctx.use(rules):
        mean_eq, err_eq = compression.compressed_psum_tree(
            g, compression.init_errors(g))
        gr = {"w": tensor("ef/g")[RANK], "b": tensor("ef/gb")[RANK]}
        er = {"w": tensor("ef/e")[RANK], "b": tensor("ef/eb")[RANK]}
        shard_ctx.reset_collectives()
        mean, new_e = compression.compressed_psum_tree(gr, er)
        counts = {k: list(v) for k, v in shard_ctx.COLLECTIVES.items()}
    q, s = compression.quantize_int8(gr["w"].float() + er["w"])
    save(scenario, mean_eq=mean_eq["w"].numpy(), err_eq=err_eq["w"].numpy(),
         mean_w=mean["w"].numpy(), mean_b=mean["b"].numpy(),
         err_w=new_e["w"].numpy(), err_b=new_e["b"].numpy(),
         codes=q.numpy(), scales=s.numpy(), counts=json.dumps(counts))


def _tree_from(prefix: str, like):
    """A tree shaped as ``like`` whose leaves the test saved by name
    under ``prefix``."""
    names, _, td = _flatten_with_names(like)
    return td.unflatten([tensor(f"{prefix}/{n}") for n in names])


def serving(scenario):
    """The prefill and decode setups (``launch.steps.build_setup``) of
    the test's cases (``serving.json``): each case's setup from the
    port's seeded weights and the test's batch or cache, token and
    position, run once; the gathered logits and cache, the collective
    counts, or the ``NotImplementedError`` of the build.  Rank 0 writes
    the arrays, every rank their digest."""
    cases = json.load(open(os.path.join(IO, "serving.json")))
    res, arrays = {}, {}
    for c in cases:
        key, cfg = c["key"], cfg_of(c["cfg"])
        mesh = mesh_lib.make_host_mesh(c["mesh"][1], device_type="cpu")
        shape = ShapeConfig(key, seq_len=c["S"], global_batch=c["B"],
                            kind=c["kind"])
        params = params_of(c["cfg"], cfg)
        try:
            if c["kind"] == "decode":
                setup = steps.build_decode_setup(
                    cfg, shape, mesh, attn_impl=c["impl"],
                    param_dtype=torch.float32)
                like = model.init_cache(cfg, c["B"], c["S"], torch.float32,
                                        device="meta")
                args = (params, _tree_from(f"{key}/cache", like),
                        tensor(f"{key}/token"),
                        torch.tensor(c["pos"], dtype=torch.int32))
            else:
                setup = steps.build_prefill_setup(cfg, shape, mesh,
                                                  param_dtype=torch.float32)
                args = (params, {k: tensor(f"{key}/batch/{k}")
                                 for k in setup.args[1]})
        except NotImplementedError as e:
            res[key] = {"error": str(e)}
            continue
        shard_ctx.reset_collectives()
        out = setup(*setup.shard(args))
        counts = {k: list(v) for k, v in shard_ctx.COLLECTIVES.items()}
        logits, cache = setup.gather(out)
        arrays[f"{key}|logits"] = logits.numpy()
        names, leaves, _ = _flatten_with_names(cache)
        arrays.update({f"{key}|cache|{n}": t.numpy()
                       for n, t in zip(names, leaves)})
        res[key] = {"counts": counts}
    digest = hashlib.sha256()
    for k in sorted(arrays):
        digest.update(k.encode() + arrays[k].tobytes())
    save(scenario, result=json.dumps(res), digest=digest.hexdigest(),
         **(arrays if RANK == 0 else {}))


SCENARIOS = {
    "blockllm_2x2": lambda s: blockllm(s, (2, 2)),
    "blockllm_4x1": lambda s: blockllm(s, (4, 1)),
    "blockllm_1x4": lambda s: blockllm(s, (1, 4)),
    "blockllm_q8_2x2": lambda s: blockllm(s, (2, 2), "blockllm+q8"),
    "q8_bitwise": q8_bitwise,
    "cores": cores,
    "kl_scaling": kl_scaling,
    "families": families,
    "xlstm": xlstm,
    "moe_island": moe_island,
    "compressed": compressed,
    "serving": serving,
}


def main():
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(IO, 'rendezvous')}",
        rank=RANK, world_size=WORLD)
    try:
        for name in sys.argv[2].split(","):
            t0 = time.monotonic()
            SCENARIOS[name](name)
            dist.barrier()
            print(f"{name}: {time.monotonic() - t0:.1f} s", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
