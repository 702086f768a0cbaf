"""Multi-pod dry run of the port: build and run every (arch x shape x
mesh) cell as one rank of a fake process group (counterpart of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch all|a,b] [--shape all|s,t] [--mesh single|multi|both] \\
        [--out results_torch] [--rank 0]

JAX lowers and compiles each cell for 512 placeholder devices.  The
port has no compiler to ask: this process joins a fake process group
(backend ``"fake"``, ``FakeStore``) of 256 ranks for the ``single``
mesh ``(32, 8)`` and 512 for the ``multi`` mesh ``(2, 32, 8)``, builds
the mesh with ``make_production_mesh(device_type="cpu")``, builds the
cell with ``launch.steps.build_setup``, cuts the setup's meta arguments
to rank ``--rank``'s shards and runs the step on them under
``op_cost.OpCounter``: every op runs on meta tensors (shapes, no data)
and every collective is a no-op that is still counted.  Each cell
records, for that rank:

- ``status`` (``ok``, ``skipped`` where ``shape_applicable`` says so,
  or ``error`` with the exception, as JAX's ``run_cell``);
- ``build_s`` / ``run_s`` (in place of JAX's lower and compile times);
- ``memory``: argument, output and alias bytes (the distinct storages
  of the local arguments and outputs; alias: outputs that are argument
  storages, the donated decode cache) and ``peak_bytes``, the arguments
  plus the most bytes of storages the step allocated alive at once
  (a liveness count of meta storages);
- ``cost``: the counter's totals (matmul FLOPs, the unfused program's
  HBM bytes, all collective bytes);
- ``collectives``: bytes and counts per ``shard_ctx`` kind;
- ``meta``: BlockLLM's ``q`` / ``active_fraction`` for train cells.

Results go to ``<out>/dryrun_<mesh>.json`` (one per mesh), keyed
``arch|shape``; a cell already recorded ``ok`` there is not run again
(JAX's cache-and-resume).  The exit code is 1 if any cell raised.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ARCHS = [
    "qwen2-moe-a2.7b", "granite-moe-3b-a800m", "deepseek-7b",
    "internlm2-1.8b", "gemma3-1b", "gemma-2b", "pixtral-12b",
    "recurrentgemma-2b", "xlstm-1.3b", "whisper-large-v3",
]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
WORLD = {"single": 256, "multi": 512}


def fake_world(world: int, rank: int):
    """Join a fake process group of ``world`` ranks as ``rank``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             verbose: bool = True) -> dict:
    """One cell as this process's rank (the fake group must span
    ``WORLD[mesh_kind]`` ranks)."""
    import torch.distributed as dist

    from repro_torch.configs import base as config_base
    from repro_torch.configs.shapes import SHAPES, shape_applicable
    from repro_torch.launch import op_cost
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_production_mesh
    cfg = config_base.get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "kind": shape.kind, "rank": dist.get_rank(), "ts": time.time()}
    if not shape_applicable(arch, shape, cfg):
        rec["status"] = "skipped"
        rec["reason"] = ("long_500k needs sub-quadratic attention; "
                         "pure full-attention arch")
        return rec
    t0 = time.monotonic()
    try:
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                    device_type="cpu")
        kw = {"device": "meta"} if shape.kind == "train" else {}
        setup = steps_lib.build_setup(cfg, shape, mesh, **kw)
        local = setup.shard(setup.args)
        t1 = time.monotonic()
        with op_cost.OpCounter() as counter:
            out = setup(*local)
        t2 = time.monotonic()
        args_b = op_cost.storage_bytes(local)
        arg_ids = {id(t.untyped_storage()) for t in op_cost._tensors(local)}
        alias = [t for t in op_cost._tensors(out)
                 if id(t.untyped_storage()) in arg_ids]
        tot = counter.totals
        rec.update({
            "status": "ok",
            "build_s": round(t1 - t0, 2),
            "run_s": round(t2 - t1, 2),
            "memory": {
                "argument_bytes": args_b,
                "output_bytes": op_cost.storage_bytes(out),
                "alias_bytes": op_cost.storage_bytes(alias),
                "peak_bytes": args_b + counter.peak_bytes,
            },
            "cost": {
                "flops": tot.flops,
                "hbm_bytes": tot.hbm_bytes,
                "total_collective_bytes": tot.total_collective_bytes,
            },
            "collectives": {"bytes": dict(tot.collective_bytes),
                            "counts": dict(tot.collective_counts),
                            "total_bytes": tot.total_collective_bytes},
            "meta": {k: (float(v) if isinstance(v, (int, float)) else None)
                     for k, v in setup.meta.items()
                     if k in ("q", "active_fraction")},
        })
    except Exception as e:  # a failing cell is recorded, loudly
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    if verbose:
        mem = rec.get("memory", {})
        print(f"[{mesh_kind}] {arch} x {shape_name}: {rec['status']}"
              + (f" build={rec.get('build_s')}s run={rec.get('run_s')}s"
                 f" args={mem.get('argument_bytes', 0) / 2 ** 30:.2f}GiB"
                 f" peak={mem.get('peak_bytes', 0) / 2 ** 30:.2f}GiB"
                 f" flops={rec['cost']['flops']:.3g}"
                 f" coll={rec['collectives']['total_bytes'] / 2 ** 20:.1f}"
                 f"MiB" if rec["status"] == "ok" else
                 f" {rec.get('reason', rec.get('error', ''))[:200]}"),
              flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results_torch",
                    help="directory of the dryrun_<mesh>.json files")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the fake group this process plays")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = SHAPE_NAMES if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    n_fail, errors = 0, []
    for mesh_kind in meshes:
        fake_world(WORLD[mesh_kind], args.rank)
        path = outdir / f"dryrun_{mesh_kind}.json"
        results = json.loads(path.read_text()) if path.exists() else {}
        for arch in archs:
            for shape in shapes:
                key = f"{arch}|{shape}"
                if results.get(key, {}).get("status") == "ok":
                    print(f"[{mesh_kind}] {key}: cached", flush=True)
                    continue
                rec = run_cell(arch, shape, mesh_kind)
                results[key] = rec
                if rec["status"] == "error":
                    n_fail += 1
                    errors.append(f"[{mesh_kind}] {key}: {rec['error']}")
                path.write_text(json.dumps(results, indent=1))
        dist.destroy_process_group()
    for line in errors:
        print(f"error: {line[:300]}")
    print(f"done; failures={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
