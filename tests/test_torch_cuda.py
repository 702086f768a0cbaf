"""Port kernels on the card: each CUDA kernel against its plain version.

Every test here carries the ``cuda`` marker and asks the ``cuda_device``
fixture for the card, which skips the test where there is none (the
CPU tests count them as skipped).  The file imports torch and the port
only, so on a machine with a card and no JAX it runs on its own:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 outputs rtol 1e-4 / atol 2e-5 (summation order), bf16
outputs atol 2e-2 (one bf16 rounding step below 4); the swap bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import model as tmodel

F32_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_ATOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run on the card "
                    "only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("G,window,ring,softcap,qdt,hd", [
    (2, 0, False, 0.0, torch.bfloat16, 128), (1, 0, False, 0.0,
                                              torch.float32, 128),
    (4, 256, False, 0.0, torch.float32, 64), (2, 512, True, 0.0,
                                             torch.float32, 128),
    (2, 0, False, 30.0, torch.float32, 256), (8, 0, False, 0.0,
                                              torch.float32, 32)])
def test_cuda_decode_attention_matches_plain(cuda_device, G, window, ring,
                                             softcap, qdt, hd):
    g = torch.Generator(cuda_device).manual_seed(0)
    B, C, KV = 8, 512 if ring else 2048, 8
    q = torch.randn(B, 1, KV * G, hd, generator=g, device=cuda_device).to(qdt)
    k = torch.randn(B, C, KV, hd, generator=g,
                    device=cuda_device).bfloat16()
    v = torch.randn(B, C, KV, hd, generator=g,
                    device=cuda_device).bfloat16()
    pos = torch.tensor([0, 127, 128, 1000, 2047, 513, 1536, 3000],
                       dtype=torch.int32, device=cuda_device)
    if not ring:
        pos = pos.clamp(max=C - 1)
    kw = dict(window=window, ring=ring, softcap=softcap)
    before = ops.LAUNCHES["decode_attention"]
    o = ops.decode_attention(q, k, v, pos, **kw)
    r = ops.decode_attention(q, k, v, pos, mode="plain", **kw)
    assert ops.LAUNCHES["decode_attention"] == before + 1
    if qdt == torch.float32:
        torch.testing.assert_close(o, r, **F32_TOL)
    else:
        torch.testing.assert_close(o.float(), r.float(), rtol=0,
                                   atol=BF16_ATOL)


@pytest.mark.cuda
def test_cuda_decode_attention_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(2, 1, 4, 16, device=cuda_device)      # head_dim 16
    k = torch.zeros(2, 64, 2, 16, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(q, k, k, torch.zeros(2, dtype=torch.int32,
                                                  device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row", [(4096, 3), (5,)])      # 16-byte / odd rows
def test_cuda_scatter_swap_bitwise_and_involution(cuda_device, dtype, row):
    full = torch.randn(24, *row, device=cuda_device).to(dtype)
    rows = torch.randn(2, *row, device=cuda_device).to(dtype)
    idx = np.asarray([3, 1], np.int32)
    before = ops.LAUNCHES["scatter_swap"]
    kf, kd = ops.scatter_swap(full, idx, rows)
    pf, pd = ops.scatter_swap(full, idx, rows, mode="plain")
    assert ops.LAUNCHES["scatter_swap"] == before + 1
    assert torch.equal(_bits(kf), _bits(pf))
    assert torch.equal(_bits(kd), _bits(pd))
    back, _ = ops.scatter_swap(kf, idx, kd, donate=True)
    assert back is kf and torch.equal(_bits(back), _bits(full))


@pytest.mark.cuda
def test_cuda_decode_steps_match_the_cpu_run(cuda_device):
    """The same f32 model and tokens on the card (kernel attention) and
    on the CPU (its plain version): logits within f32 tolerance."""
    cfg = ModelConfig(name="tiny-gqa", family="dense", num_layers=4,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=256, remat=False, dtype="float32")
    params = tmodel.init_params(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    on_card = tree_map(lambda a: a.to(cuda_device), params)
    rng = np.random.RandomState(0)
    lengths = np.asarray([40, 3, 0, 17])
    prompt = torch.from_numpy(rng.randint(0, 256, (4, 40)))
    fed = torch.from_numpy(rng.randint(0, 256, (6, 4, 1)))
    outs = []
    for dev, p in (("cpu", params), (cuda_device, on_card)):
        cache = tmodel.init_cache(cfg, 4, 64, dtype=torch.float32,
                                  device=dev)
        tmodel.prefill_into_slots(p, cfg, cache, prompt.to(dev), lengths)
        pos = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        got = []
        for t in fed:
            lg, _ = tmodel.decode_step(p, cfg, cache, t.to(dev), pos,
                                       attn_impl="kernel")
            got.append(lg.cpu())
            pos = pos + 1
        outs.append(torch.stack(got))
    torch.testing.assert_close(outs[1], outs[0], **F32_TOL)
