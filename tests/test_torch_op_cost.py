"""The port's op-cost counter (``launch/op_cost.py``) and its dry run
(``launch/dryrun.py``), against exact counts and the JAX package's
``hlo_cost``.

- Synthetic programs, as ``tests/test_hlo_cost.py`` holds JAX's counter:
  a 10-step loop of 128^3 matmuls counts exactly 10 * 2 * 128^3 FLOPs,
  nested loops multiply, a collective inside a loop counts once per
  call, and bytes count each op's operands and outputs once.
- The matmul FLOPs of reduced dense decode and prefill cells at world 1
  against ``repro.launch.hlo_cost.analyze`` of JAX's compiled
  ``build_setup`` for the same cell on one CPU device.  Decode agrees
  exactly.  Prefill differs by exactly 2 * B * (S - 1) * D * vocab: JAX
  unembeds every position and keeps the last, the port unembeds the
  last position only.
- ``python -m repro_torch.launch.dryrun`` in a subprocess over a fake
  process group of 256 ranks for production cells: status, argument
  bytes equal to the rank's share of parameters, cache, token and
  position under the port's sharding rules, the softmax merge's
  collectives where the cache's sequence splits (and not elsewhere), and
  the item-4b cells recorded as errors.
"""
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.configs.shapes import ShapeConfig as JShape
from repro.launch import hlo_cost
from repro.launch import steps as jsteps
from repro_torch.launch.op_cost import OpCounter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
ENV.pop("JAX_PLATFORMS", None)
DENSE = dict(name="dense", family="dense", num_layers=4, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             remat=False, dtype="float32")
CELLS = {"decode": (2, 64), "prefill": (2, 64)}      # (batch, sequence)


def _run(code: str, timeout: int = 60) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_loop_of_matmuls_counts_exact_flops():
    w = torch.randn(128, 128)
    with OpCounter() as c:
        x = torch.ones(128, 128)
        for _ in range(10):
            x = x @ w
    assert c.totals.flops == 10 * 2 * 128 ** 3


def test_nested_loops_multiply():
    w = torch.empty(64, 64, device="meta")
    with OpCounter() as c:
        x = torch.ones(64, 64, device="meta")
        for _ in range(3):
            for _ in range(5):
                x = torch.einsum("ij,jk->ik", x, w)
    assert c.totals.flops == 15 * 2 * 64 ** 3
    # ones (write) + 15 products (two operands read, one output written)
    assert c.totals.hbm_bytes == (1 + 15 * 3) * 64 * 64 * 4


def test_views_and_allocations_move_no_bytes():
    x = torch.empty(256, 64, device="meta")
    with OpCounter() as c:
        y = torch.empty(256, 64, device="meta")
        _ = x[16:48].reshape(-1).view(32, 64).t()
        z = x + y
    assert c.totals.hbm_bytes == 3 * 256 * 64 * 4
    assert c.peak_bytes == 2 * 256 * 64 * 4      # y and z
    del z


def test_collective_in_a_loop_counts_per_call():
    got = _run("""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import mesh, steps
from repro_torch.launch.op_cost import OpCounter
from repro_torch.runtime import shard_ctx
dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=4)
rules = steps._rules_for(mesh.make_host_mesh(4, device_type="cpu"))
with OpCounter() as c:
    x = torch.empty(16, 16, device="meta")
    for _ in range(5):
        x = shard_ctx.all_reduce(x, "model", "loop/all_reduce", rules=rules)
print(json.dumps({k: [c.totals.collective_counts[k],
                      c.totals.collective_bytes[k]]
                  for k in c.totals.collective_counts}))
""")
    assert got == {"loop/all_reduce": [5, 5 * 16 * 16 * 4]}


@pytest.fixture(scope="module")
def port_flops():
    """The port's counted FLOPs of the reduced dense cells at world 1."""
    return _run(f"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import mesh, steps
from repro_torch.launch.op_cost import OpCounter
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
m = mesh.make_host_mesh(1, device_type="cpu")
cfg = ModelConfig(**{DENSE!r})
out = {{}}
for kind, (B, S) in {CELLS!r}.items():
    setup = steps.build_setup(cfg, ShapeConfig(kind, S, B, kind), m)
    with OpCounter() as c:
        setup(*setup.shard(setup.args))
    out[kind] = c.totals.flops
print(json.dumps(out))
""")


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_matmul_flops_match_jax_hlo_cost(port_flops, kind):
    cfg = JConfig(**DENSE)
    B, S = CELLS[kind]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    setup = jsteps.build_setup(cfg, JShape(kind, S, B, kind), mesh)
    want = hlo_cost.analyze(setup.lower().compile().as_text()).flops
    if kind == "prefill":
        want -= 2 * B * (S - 1) * cfg.d_model * cfg.vocab_size
    assert port_flops[kind] == want


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1.8b,gemma3-1b,recurrentgemma-2b", "--shape",
         "decode_32k,long_500k", "--mesh", "single", "--out", str(out)],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=150)
    recs = json.loads((out / "dryrun_single.json").read_text())
    return proc, recs


def _share(cfg_name, shape_name):
    """Bytes of rank 0's shards of a decode cell's arguments under the
    port's rules on (32, 8): parameters and cache in bf16, token, pos."""
    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import specs
    from repro_torch.runtime import sharding
    from repro_torch.runtime.shard_ctx import _axes
    ms = {"data": 32, "model": 8}
    cfg, shape = get_config(cfg_name), SHAPES[shape_name]
    params = specs.params_abstract(cfg)
    cache = specs.cache_specs_abstract(cfg, shape)

    def total(tree, spec_tree):
        from repro_torch.checkpoint.checkpointer import _flatten_with_names
        n = 0
        for t, sp in zip(_flatten_with_names(tree)[1],
                         _flatten_with_names(spec_tree)[1]):
            split = math.prod(ms[a] for e in sp for a in _axes(e))
            n += t.numel() * t.element_size() // split
        return n

    B = shape.global_batch
    tok = 4 * (B // 32 if B % 32 == 0 else B)
    return (total(params, sharding.param_specs(cfg, params, ms))
            + total(cache, sharding.cache_specs(cfg, cache, ms)) + tok + 4)


@pytest.mark.parametrize("key,status", [
    ("internlm2-1.8b|decode_32k", "ok"), ("gemma3-1b|decode_32k", "ok"),
    ("gemma3-1b|long_500k", "ok"), ("internlm2-1.8b|long_500k", "skipped"),
    ("recurrentgemma-2b|decode_32k", "error"),
    ("recurrentgemma-2b|long_500k", "error")])
def test_dryrun_cells(dryrun, key, status):
    proc, recs = dryrun
    assert proc.returncode == 1, proc.stderr[-2000:]   # the 4b cells
    rec = recs[key]
    assert rec["status"] == status, rec.get("error")
    if status == "error":
        assert "item 4b" in rec["error"]
        assert key in proc.stdout
        return
    if status == "skipped":
        return
    arch, shape = key.split("|")
    assert rec["rank"] == 0
    assert rec["memory"]["argument_bytes"] == _share(arch, shape)
    # the donated cache comes back in place
    assert rec["memory"]["alias_bytes"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["cost"]["hbm_bytes"] > 0
    merge = rec["collectives"]["bytes"].get("decode/all_gather", 0)
    # internlm2's 8 KV heads divide the model axis: heads split, no merge;
    # gemma3's one KV head: the sequence splits and the merge runs
    assert (merge > 0) == arch.startswith("gemma3"), rec["collectives"]
