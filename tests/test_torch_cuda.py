"""Port kernels on the card: each CUDA kernel against its plain version.

Every test here carries the ``cuda`` marker and asks the ``cuda_device``
fixture for the card, which skips the test where there is none (the
CPU tests count them as skipped).  The file imports torch and the port
only, so on a machine with a card and no JAX it runs on its own:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 outputs rtol 1e-4 / atol 2e-5 (summation order), bf16
outputs atol 2e-2 (one bf16 rounding step below 4); the swap bitwise.
Masked Adam: the kernel and its plain version do the same IEEE
operations in the same order (no FMA), so f32 results are held within 2
ulp, bf16 parameters within one bf16 ulp, and the Q8 codes and scales
bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import masked_adam as ma
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


def _ulps(a, b):
    """Largest distance in units of the last place between two f32 or
    bf16 tensors (same-sign values; 0 where bitwise equal)."""
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return (a.contiguous().view(bits).long()
            - b.contiguous().view(bits).long()).abs().max().item()


def _adam_inputs(n, dtype, dev, seed=0, offset=0):
    g = torch.Generator(dev).manual_seed(seed)
    mk = lambda: torch.randn(n + offset, generator=g, device=dev)[offset:]
    p, gr = mk().to(dtype), mk().to(dtype)
    m = mk() * 0.1
    v = mk().abs() * 0.01
    mask = torch.rand(n, generator=g, device=dev) > 0.5
    return p, gr, m, v, mask


SCAL = ma.scalars(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                  count=4, tau=0.7)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(8 * 128, 0), (100 * 257, 0),
                                      (513 * 130, 0), (1, 0), (4099, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", ["mask", "none", "tau"])
def test_cuda_masked_adam_matches_plain(cuda_device, n, offset, dtype, gate):
    p, g, m, v, mask = _adam_inputs(n, dtype, cuda_device, offset=offset)
    mk = mask if gate == "mask" else None
    kp, km, kv = p.clone(), m.clone(), v.clone()
    before = ops.LAUNCHES["masked_adam"]
    ma.masked_adam_cuda(kp, g, km, kv, mk, SCAL, use_tau=gate == "tau")
    assert ops.LAUNCHES["masked_adam"] == before + 1
    ma.masked_adam_plain(p, g, m, v, mk, SCAL, use_tau=gate == "tau")
    torch.cuda.synchronize()
    assert _ulps(km, m) <= 2 and _ulps(kv, v) <= 2
    assert _ulps(kp, p) <= (1 if dtype == torch.bfloat16 else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 100 * 257, 513 * 130, 7, 4099])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", ["mask", "none", "tau"])
def test_cuda_masked_adam_q8_matches_plain_bitwise(cuda_device, n, dtype,
                                                   gate):
    from repro_torch.runtime.compression import quantize_int8
    p, g, m, v, mask = _adam_inputs(n, dtype, cuda_device, seed=1)
    mq, ms = quantize_int8(m)
    vq, vs = quantize_int8(v)
    mk = mask if gate == "mask" else None
    k = [t.clone() for t in (p, mq, ms, vq, vs)]
    before = ops.LAUNCHES["masked_adam_q8"]
    ma.masked_adam_q8_cuda(k[0], g, *k[1:], mk, SCAL, use_tau=gate == "tau")
    assert ops.LAUNCHES["masked_adam_q8"] == before + 1
    ma.masked_adam_q8_plain(p, g, mq, ms, vq, vs, mk, SCAL,
                            use_tau=gate == "tau")
    torch.cuda.synchronize()
    assert torch.equal(k[1], mq) and torch.equal(k[3], vq)
    assert torch.equal(k[2].view(torch.int32), ms.view(torch.int32))
    assert torch.equal(k[4].view(torch.int32), vs.view(torch.int32))
    assert _ulps(k[0], p) <= (1 if dtype == torch.bfloat16 else 2)


@pytest.mark.cuda
def test_cuda_masked_adam_tree_through_ops(cuda_device):
    """ops.masked_adam_tree / masked_adam_q8_tree route CUDA leaves to the
    kernels (one launch per leaf) and agree with mode='plain'."""
    from repro_torch.optim.q8adam import quantize_tree
    g0 = torch.Generator(cuda_device).manual_seed(3)
    tree = {"a": torch.randn(6, 33, 8, generator=g0, device=cuda_device),
            "b": torch.randn(300, generator=g0, device=cuda_device)}
    grads = tree_map(lambda a: a * 0.1, tree)
    mu = tree_map(lambda a: torch.zeros_like(a), tree)
    kw = dict(lr=1e-3, count=0, weight_decay=0.01)
    outs = []
    for mode in ("auto", "plain"):
        p = tree_map(lambda a: a.clone(), tree)
        m, v = tree_map(torch.clone, mu), tree_map(torch.clone, mu)
        before = ops.LAUNCHES["masked_adam"]
        ops.masked_adam_tree(p, grads, m, v, None, mode=mode, **kw)
        assert ops.LAUNCHES["masked_adam"] == before + (2 if mode == "auto"
                                                         else 0)
        q8 = [quantize_tree(m)[0], quantize_tree(m)[1], quantize_tree(v)[0],
              quantize_tree(v)[1]]
        p8 = tree_map(lambda a: a.clone(), tree)
        ops.masked_adam_q8_tree(p8, grads, *q8, None, mode=mode, **kw)
        outs.append((p, m, v, p8, q8))
    for a, b in zip(*(_flatten_leaves(o) for o in outs)):
        assert _ulps(a, b) <= 2 if a.is_floating_point() else torch.equal(a, b)


def _flatten_leaves(tree):
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    return _flatten_with_names(list(tree))[1]
