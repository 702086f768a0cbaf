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
bitwise.  Flash attention: f32 outputs atol 2e-5 (the JAX sweep's bound),
bf16 outputs within one bf16 ulp of the plain output plus 2e-5 (each
rounds its own f32 result once; bf16 runs the tensor-core kernel, f32 the
CUDA-core one); the op's gradients bitwise ``mode="plain"``'s (the same
chunked recompute).
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
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


POS8 = [0, 127, 128, 1000, 2047, 513, 1536, 3000]


def _same_bits_over_launches_and_replays(fn, ref):
    """3 back-to-back launches, then 20 calls captured in a CUDA graph and
    replayed twice: every output bitwise ``ref`` (a counter left non-zero
    by one launch would change the next one's merge)."""
    outs = [fn() for _ in range(3)]
    for o in outs:
        assert torch.equal(_bits(o), _bits(ref))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(20)]
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    for o in outs:
        assert torch.equal(_bits(o), _bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("G,window,ring,softcap,qdt,hd,cdt,C,block_k,pos", [
    (2, 0, False, 0.0, torch.bfloat16, 128, torch.bfloat16, 2048, 128, POS8),
    (1, 0, False, 0.0, torch.float32, 128, torch.bfloat16, 2048, 128, POS8),
    (4, 256, False, 0.0, torch.float32, 64, torch.bfloat16, 2048, 128, POS8),
    (2, 512, True, 0.0, torch.float32, 128, torch.bfloat16, 512, 128, POS8),
    (2, 0, False, 30.0, torch.float32, 256, torch.bfloat16, 2048, 128, POS8),
    (8, 0, False, 0.0, torch.float32, 32, torch.bfloat16, 2048, 128, POS8),
    # 32 k-blocks; C not a multiple of block_k; block_k 64 and 256; B 1;
    # every pos 0; an f32 cache at hd 256 (a ring of stages)
    (2, 0, False, 0.0, torch.bfloat16, 128, torch.bfloat16, 4096, 128,
     [0, 127, 4095, 1000, 2047, 3000, 4000, 64]),
    (2, 0, False, 0.0, torch.bfloat16, 128, torch.bfloat16, 1000, 128,
     [999, 127, 128, 998, 0, 513, 896, 64]),
    (2, 0, False, 0.0, torch.bfloat16, 128, torch.bfloat16, 2048, 64, POS8),
    (2, 0, False, 0.0, torch.bfloat16, 128, torch.bfloat16, 2048, 256,
     POS8),
    (2, 0, False, 0.0, torch.bfloat16, 128, torch.bfloat16, 2048, 128,
     [1500]),
    (2, 0, False, 0.0, torch.bfloat16, 128, torch.bfloat16, 2048, 128,
     [0] * 8),
    (2, 0, False, 0.0, torch.float32, 256, torch.float32, 2048, 128, POS8),
    # G = 3 at head_dim 64 (granite-moe-3b-a800m's GQA 24 / 8): tensor
    # cores with 3 of 8 head columns used; the f32 cache's CUDA cores
    (3, 0, False, 0.0, torch.bfloat16, 64, torch.bfloat16, 1024, 128,
     [0, 127, 128, 1000, 1023, 513, 700, 64]),
    (3, 0, False, 0.0, torch.float32, 64, torch.bfloat16, 2048, 128, POS8),
    (3, 0, False, 0.0, torch.float32, 64, torch.float32, 1024, 128,
     [0, 127, 128, 1000, 1023, 513, 700, 64])])
def test_cuda_decode_attention_matches_plain(cuda_device, G, window, ring,
                                             softcap, qdt, hd, cdt, C,
                                             block_k, pos):
    g = torch.Generator(cuda_device).manual_seed(0)
    B, KV = len(pos), 8
    q = torch.randn(B, 1, KV * G, hd, generator=g, device=cuda_device).to(qdt)
    k = torch.randn(B, C, KV, hd, generator=g, device=cuda_device).to(cdt)
    v = torch.randn(B, C, KV, hd, generator=g, device=cuda_device).to(cdt)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    if not ring:
        pos = pos.clamp(max=C - 1)
    kw = dict(window=window, ring=ring, softcap=softcap, block_k=block_k)
    before = ops.LAUNCHES["decode_attention"]
    o = ops.decode_attention(q, k, v, pos, **kw)
    r = ops.decode_attention(q, k, v, pos, mode="plain", **kw)
    assert ops.LAUNCHES["decode_attention"] == before + 1
    if qdt == torch.float32:
        torch.testing.assert_close(o, r, **F32_TOL)
    else:
        torch.testing.assert_close(o.float(), r.float(), rtol=0,
                                   atol=BF16_ATOL)
    _same_bits_over_launches_and_replays(
        lambda: ops.decode_attention(q, k, v, pos, **kw), o)


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


PAGED_POS = [16, 31, 200, 511, 900, 1023, 47, 64]


def _paged_state(dev, G, hd, qdt, pdt, seed=0, KV=8, ps=16, NP=64,
                 pos=PAGED_POS):
    """A valid paged decode state: shuffled pages, entries past pos
    unmapped; with 8 slots, slots 2/6/7 share their first two pages where
    none of them writes there, and slots 3 and 7 are inactive.  The
    default pos sits on a page's first and last rows."""
    rng = np.random.default_rng(seed)
    B = len(pos)
    P = B * NP + 1
    tbl = (1 + rng.permutation(P - 1))[:B * NP].reshape(B, NP)
    if B == 8 and min(pos[2], pos[6], pos[7]) >= 2 * ps:
        for b in (6, 7):
            tbl[b, :2] = tbl[2, :2]
    for b, p in enumerate(pos):
        tbl[b, p // ps + 1:] = 0
    g = torch.Generator(dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    return (rn(B, 1, KV * G, hd).to(qdt), rn(B, KV, hd), rn(B, KV, hd),
            rn(P, ps, KV, hd).to(pdt), rn(P, ps, KV, hd).to(pdt),
            torch.tensor(pos, dtype=torch.int32, device=dev),
            torch.tensor(tbl, dtype=torch.int32, device=dev),
            torch.tensor([b % 4 != 3 for b in range(B)], dtype=torch.bool,
                         device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("G,hd,qdt,pdt,window,softcap,ps,NP,block_k,pos", [
    (2, 128, torch.bfloat16, torch.bfloat16, 0, 0.0, 16, 64, 128,
     PAGED_POS),
    (1, 128, torch.float32, torch.bfloat16, 0, 0.0, 16, 64, 128, PAGED_POS),
    (8, 64, torch.float32, torch.bfloat16, 0, 0.0, 16, 64, 128, PAGED_POS),
    (2, 64, torch.float32, torch.bfloat16, 100, 0.0, 16, 64, 128,
     PAGED_POS),
    (2, 128, torch.float32, torch.bfloat16, 0, 30.0, 16, 64, 128,
     PAGED_POS),
    (2, 128, torch.float32, torch.float32, 0, 0.0, 16, 64, 128, PAGED_POS),
    # 16 and 32 k-blocks; C 1008, not a multiple of block_k; block_k 64 and
    # 256; pages of 48 rows across k-block edges; B 1; every pos 0; f32
    # pools at hd 256 (a ring of stages)
    (2, 128, torch.bfloat16, torch.bfloat16, 0, 0.0, 16, 128, 128,
     [16, 2047, 200, 1500, 900, 1023, 47, 64]),
    (2, 128, torch.bfloat16, torch.bfloat16, 0, 0.0, 16, 256, 128,
     [4095, 31, 3000, 511, 2048, 1023, 47, 64]),
    (2, 128, torch.bfloat16, torch.bfloat16, 0, 0.0, 16, 63, 128,
     [1007, 31, 200, 1000, 900, 896, 47, 64]),
    (2, 128, torch.bfloat16, torch.bfloat16, 0, 0.0, 16, 64, 64, PAGED_POS),
    (2, 128, torch.bfloat16, torch.bfloat16, 0, 0.0, 16, 64, 256,
     PAGED_POS),
    (2, 128, torch.bfloat16, torch.bfloat16, 0, 0.0, 48, 22, 128,
     [47, 48, 1055, 511, 900, 128, 127, 64]),
    (2, 128, torch.bfloat16, torch.bfloat16, 0, 0.0, 16, 64, 128, [700]),
    (2, 128, torch.bfloat16, torch.bfloat16, 0, 0.0, 16, 64, 128, [0] * 8),
    (2, 256, torch.float32, torch.float32, 0, 0.0, 16, 64, 128, PAGED_POS),
    # G = 3 at head_dim 64, bf16 and f32 pools
    (3, 64, torch.bfloat16, torch.bfloat16, 0, 0.0, 16, 64, 128,
     PAGED_POS),
    (3, 64, torch.float32, torch.float32, 0, 0.0, 16, 64, 128, PAGED_POS)])
def test_cuda_paged_decode_attention_matches_plain_and_dense(
        cuda_device, G, hd, qdt, pdt, window, softcap, ps, NP, block_k,
        pos):
    """The fused paged kernel: o within the dense kernel's tolerance of
    its plain version, pools bitwise outside the null page, bitwise the
    dense kernel on the gathered view at the same block_k, and bitwise
    itself over back-to-back launches and graph replays."""
    q, nk, nv, kp, vp, pos, tbl, act = _paged_state(
        cuda_device, G, hd, qdt, pdt, ps=ps, NP=NP, pos=pos)
    B = pos.numel()
    kw = dict(window=window, softcap=softcap, block_k=block_k)
    kk, kv, pk, pv = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    before = ops.LAUNCHES["paged_decode_attention"]
    o, k2, _ = ops.paged_decode_attention(q, nk, nv, kk, kv, pos, tbl, act,
                                          **kw)
    assert ops.LAUNCHES["paged_decode_attention"] == before + 1
    assert k2 is kk
    r, _, _ = ops.paged_decode_attention(q, nk, nv, pk, pv, pos, tbl, act,
                                         mode="plain", **kw)
    if qdt == torch.float32:
        torch.testing.assert_close(o, r, **F32_TOL)
    else:
        torch.testing.assert_close(o.float(), r.float(), rtol=0,
                                   atol=BF16_ATOL)
    assert torch.equal(_bits(kk[1:]), _bits(pk[1:]))
    assert torch.equal(_bits(kv[1:]), _bits(pv[1:]))
    P, _, KV, _ = kp.shape
    ridx = (tbl.long()[:, :, None] * ps
            + torch.arange(ps, device=cuda_device)).reshape(B, -1)
    ck, cv = kk.view(P * ps, KV, hd)[ridx], kv.view(P * ps, KV, hd)[ridx]
    od = ops.decode_attention(q, ck, cv, pos, **kw)
    assert torch.equal(_bits(o), _bits(od))
    _same_bits_over_launches_and_replays(
        lambda: ops.paged_decode_attention(q, nk, nv, kk, kv, pos, tbl, act,
                                           **kw)[0], o)
    _same_bits_over_launches_and_replays(
        lambda: ops.decode_attention(q, ck, cv, pos, **kw), o)


@pytest.mark.cuda
def test_cuda_paged_decode_attention_rejects_what_it_does_not_take(
        cuda_device):
    q, nk, nv, kp, vp, pos, tbl, act = _paged_state(cuda_device, 2, 128,
                                                    torch.float32,
                                                    torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_decode_attention(q, nk, nv, kp, vp, pos, tbl.long(), act)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention(q, nk, nv, kp, vp, pos, tbl.cpu(), act,
                                   mode="kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("speculate", [0, 3])
def test_cuda_paged_server_streams_equal_dense(cuda_device, speculate):
    """A small f32 model served paged on the card (fused kernel) gives the
    dense server's streams, with and without speculative decoding."""
    from repro_torch.adapters import InMemoryRegistry, extract_delta
    from repro_torch.adapters.testing import perturb_rows
    from repro_torch.runtime.serve_config import (KVConfig, ServeConfig,
                                                  SpecConfig)
    from repro_torch.runtime.serve_loop import DecodeServer, Request
    cfg = ModelConfig(name="tiny-gqa", family="dense", num_layers=4,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=256, remat=False, dtype="float32")
    params = tmodel.init_params(cfg, device=cuda_device,
                                generator=torch.Generator(
                                    cuda_device).manual_seed(0))
    reg = InMemoryRegistry({"T": extract_delta(params, perturb_rows(
        params, rows=(1, 3), scale=0.05, seed=1), meta={"adapter_id": "T"})})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 32) for _ in range(6)]
    outs = {}
    for layout, spec in (("dense", 0), ("paged", speculate)):
        srv = DecodeServer(cfg, params, ServeConfig(
            batch_slots=3, max_seq=128, prefill_chunk=32,
            kv=KVConfig(layout=layout, page_size=16),
            spec=SpecConfig(draft=spec)), registry=reg)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=10,
                        adapter_id=[None, "T"][i % 2])
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        before = ops.LAUNCHES["paged_decode_attention"]
        srv.run_until_drained()
        launched = ops.LAUNCHES["paged_decode_attention"] - before
        assert (launched > 0) == (layout == "paged")
        outs[layout] = [r.out for r in reqs]
    assert outs["paged"] == outs["dense"]


# ------------------------------------------------ the RG-LRU scan kernel


def _scan_inputs(device, B, S, W, seed):
    g = torch.Generator(device).manual_seed(seed)
    a = torch.rand(B, S, W, generator=g, device=device) * 0.199 + 0.8
    b = torch.randn(B, S, W, generator=g, device=device) * 0.1
    h0 = torch.randn(B, W, generator=g, device=device) * 0.1
    return a, b, h0


# the main path's shape; ragged S and W; S past one group of 8 chunks of
# SCAN_CHUNK = 16 steps (291 and 1000 steps: 3 and 8 groups); B * W < 32
SCAN_SHAPES = [(8, 256, 2560), (2, 96, 192), (1, 33, 130), (2, 291, 200),
               (1, 1000, 64), (1, 40, 7), (2, 9, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W", SCAN_SHAPES)
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_cuda_rglru_scan_bitwise_equals_plain(cuda_device, B, S, W,
                                              with_h0, direction):
    """The kernels round every product and sum on their own (no FMA) over
    the same chunk grid as their plain versions: bitwise equal, over 3
    back-to-back launches, each counted once.  The forward kernel gives
    y and h_last; the backward kernel, the reversed scan with the VJP's
    products, gives da, db, and dh0 when h0 is given."""
    from repro_torch.kernels import rglru_scan as rs
    a, b, h0 = _scan_inputs(cuda_device, B, S, W, 0)
    h0 = h0 if with_h0 else None
    backward = direction == "backward"
    name = "rglru_scan_bwd" if backward else "rglru_scan"
    if backward:
        y, _ = rs.rglru_scan_plain(a, b, h0)
        dh_last = torch.randn(B, W, device=cuda_device)

        def kernel():
            return rs.rglru_scan_bwd_cuda(a, y, h0, b, dh_last,
                                          need_dh0=with_h0)
        plain = rs.rglru_scan_bwd_plain(a, y, h0, b, dh_last,
                                        need_dh0=with_h0)
    else:
        def kernel():
            return rs.rglru_scan_cuda(a, b, h0)
        plain = rs.rglru_scan_plain(a, b, h0)
    for _ in range(3):
        before = ops.LAUNCHES[name]
        outs = kernel()
        assert ops.LAUNCHES[name] == before + 1
        torch.cuda.synchronize()
        assert len(outs) == len(plain)
        if backward:
            assert (outs[2] is None) == (plain[2] is None) == (not with_h0)
        for k, p in zip(outs, plain):
            if p is not None:
                assert torch.equal(_bits(k), _bits(p))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [5, 291])
def test_cuda_rglru_scan_keeps_negative_zero(cuda_device, S):
    """A run of -0 states stays -0 across chunks (H starts from -0; the
    padding is a = 1, b = -0), as in the sequential scan."""
    from repro_torch.kernels import rglru_scan as rs
    a = torch.full((2, S, 40), 0.9, device=cuda_device)
    b = torch.full_like(a, -0.0)
    h0 = torch.full((2, 40), -0.0, device=cuda_device)
    y, h = rs.rglru_scan_cuda(a, b, h0)
    torch.cuda.synchronize()
    assert torch.signbit(y).all() and torch.signbit(h).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W", [(2, 96, 192), (1, 33, 130)])
def test_cuda_rglru_scan_op_grads_bitwise(cuda_device, B, S, W):
    """``ops.rglru_scan`` with the kernel against the plain directions:
    y, h_last, da, db, dh0 bitwise; one forward and one backward launch."""
    ins = _scan_inputs(cuda_device, B, S, W, 1)
    outs = {}
    for mode in ("kernel", "plain"):
        ts = [t.clone().requires_grad_() for t in ins]
        ops.reset_launches()
        y, h = ops.rglru_scan(*ts, mode=mode)
        grads = torch.autograd.grad((y ** 2).sum() + (h ** 2).sum(), ts)
        torch.cuda.synchronize()
        outs[mode] = (y, h) + grads
        n = 1 if mode == "kernel" else 0
        assert ops.LAUNCHES["rglru_scan"] == ops.LAUNCHES[
            "rglru_scan_bwd"] == n
    for k, p in zip(outs["kernel"], outs["plain"]):
        assert torch.equal(_bits(k.detach()), _bits(p.detach()))


@pytest.mark.cuda
def test_cuda_rglru_scan_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import rglru_scan as rs
    a, b, h0 = _scan_inputs(cuda_device, 2, 8, 32, 2)
    dh = torch.zeros_like(h0)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="f32"):
        rs.rglru_scan_cuda(a.bfloat16(), b.bfloat16(), None)
    with pytest.raises(ValueError, match="contiguous"):
        rs.rglru_scan_cuda(a.transpose(1, 2), b.transpose(1, 2), None)
    with pytest.raises(ValueError, match="h0"):
        rs.rglru_scan_cuda(a, b, h0[:, :16])
    with pytest.raises(ValueError, match="CUDA"):
        rs.rglru_scan_cuda(a, b.cpu(), None)
    with pytest.raises(ValueError, match="dh_last"):
        rs.rglru_scan_bwd_cuda(a, b, h0, b, dh[:, :16])
    with pytest.raises(ValueError, match="contiguous"):
        rs.rglru_scan_bwd_cuda(a, b, h0, b.transpose(1, 2).contiguous()
                               .transpose(1, 2), dh)
    with pytest.raises(ValueError, match="f32"):
        rs.rglru_scan_bwd_cuda(a, b, h0.double(), b, dh)
    assert ops.LAUNCHES == before


G10_RING_POS = [0, 100, 2047, 2048, 2500, 3000, 4095, 9000]


@pytest.mark.cuda
@pytest.mark.parametrize("kw,pos", [
    (dict(window=2048, ring=True), G10_RING_POS),
    (dict(window=2048, ring=True, softcap=30.0), G10_RING_POS),
    (dict(window=700), [0, 100, 699, 700, 1000, 1500, 2000, 2047])],
    ids=["ring", "ring-softcap", "window"])
@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32])
def test_cuda_decode_attention_g10_ring(cuda_device, qdt, kw, pos):
    """recurrentgemma-2b's local layers: MQA with 10 query heads, head_dim
    256, a ring cache over the 2048-token window, before and after the
    ring wraps; the same with softcap, and a non-ring window shorter than
    the cache (the tensor-core kernel over a bf16 cache; tolerances of the
    other decode-attention cases)."""
    g = torch.Generator(cuda_device).manual_seed(3)
    B, C, KV, G, hd = 8, 2048, 1, 10, 256
    q = torch.randn(B, 1, KV * G, hd, generator=g, device=cuda_device).to(qdt)
    k = torch.randn(B, C, KV, hd, generator=g, device=cuda_device).bfloat16()
    v = torch.randn(B, C, KV, hd, generator=g, device=cuda_device).bfloat16()
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    before = ops.LAUNCHES["decode_attention"]
    o = ops.decode_attention(q, k, v, pos, **kw)
    r = ops.decode_attention(q, k, v, pos, mode="plain", **kw)
    assert ops.LAUNCHES["decode_attention"] == before + 1
    if qdt == torch.float32:
        torch.testing.assert_close(o, r, **F32_TOL)
    else:
        torch.testing.assert_close(o.float(), r.float(), rtol=0,
                                   atol=BF16_ATOL)
    with pytest.raises(ValueError, match="group"):   # dense kernel only
        ops.paged_decode_attention(
            q, k[:, 0], v[:, 0], k.view(-1, 16, KV, hd)[:32],
            v.view(-1, 16, KV, hd)[:32], pos.clamp(max=15),
            torch.ones(B, 1, dtype=torch.int32, device=cuda_device),
            torch.ones(B, dtype=torch.bool, device=cuda_device))


# (B, Sq, Sk, H, KV, hd, causal, window): chip_smoke.py's phase-18 sweep
FLASH_SHAPES = [(2, 256, 256, 4, 2, 64, True, 0),
                (1, 512, 512, 4, 1, 64, True, 64),
                (2, 128, 128, 2, 2, 32, False, 0),
                (1, 384, 384, 4, 4, 128, True, 0),
                (1, 256, 256, 8, 2, 64, True, 128),
                (1, 1000, 1000, 4, 2, 128, True, 0),
                (1, 1000, 1000, 2, 1, 256, True, 300),
                (1, 100, 100, 2, 1, 256, True, 0),
                (2, 77, 77, 4, 1, 32, True, 0),
                (1, 200, 333, 4, 2, 32, False, 0),
                (1, 333, 200, 4, 1, 64, False, 64),
                (1, 384, 384, 10, 1, 256, True, 128),
                (1, 2048, 2048, 4, 2, 128, True, 0),
                (2, 1000, 1000, 10, 1, 256, True, 300)]


def _flash_inputs(device, B, Sq, Sk, H, KV, hd, dtype, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(B, S, n, hd, generator=g, device=device).to(dtype)
            for S, n in ((Sq, H), (Sk, KV), (Sk, KV))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", FLASH_SHAPES)
def test_cuda_flash_attention_matches_plain(cuda_device, B, Sq, Sk, H, KV,
                                            hd, causal, window, dtype):
    q, k, v = _flash_inputs(cuda_device, B, Sq, Sk, H, KV, hd, dtype)
    before = ops.LAUNCHES["flash_attention"]
    o = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    r = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert o.dtype == dtype and bool(torch.isfinite(o).all())
    err = (o.double() - r.double()).abs()
    tol = 2e-5
    if dtype == torch.bfloat16:
        e = torch.floor(torch.log2(r.double().abs().clamp(min=2.0 ** -133)))
        tol = tol + torch.exp2(e - 7)
    assert bool((err <= tol).all()), err.max().item()


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_it_does_not_take(cuda_device):
    q, k, v = _flash_inputs(cuda_device, 1, 64, 64, 4, 2, 64, torch.float32)
    bad = {"head_dim": (q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous()),
           "one dtype": (q, k.bfloat16(), v),
           "float32 or": (q.half(), k.half(), v.half()),
           "contiguous": (q.transpose(1, 2), k, v),
           "H % KV": (q[:, :, :3].contiguous(), k, v)}
    for match, args in bad.items():
        with pytest.raises(ValueError, match=match):
            fa.flash_attention_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q.cpu(), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_rejects_unaligned_views(cuda_device, dtype):
    """Both kernels read 16-byte rows: a contiguous view that starts one
    element into its storage is refused, in bf16 as in f32."""
    q, k, v = _flash_inputs(cuda_device, 1, 64, 64, 4, 2, 64, dtype)
    buf = torch.empty(q.numel() + 1, dtype=dtype, device=cuda_device)
    shifted = buf[1:].view(q.shape).copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_cuda(shifted, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,window", [(torch.bfloat16, 0),
                                          (torch.float32, 700)])
def test_cuda_flash_attention_op_grads_equal_plain(cuda_device, dtype,
                                                   window):
    """The op's q/k/v gradients under a fixed upstream gradient equal
    ``mode="plain"``'s bitwise: both backwards are the same chunked
    recompute from the same saved inputs."""
    q, k, v = _flash_inputs(cuda_device, 2, 2048, 2048, 4, 2, 64, dtype)
    w = torch.randn_like(q)
    grads = {}
    for mode in ("auto", "plain"):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        o = ops.flash_attention(*ins, True, window, mode=mode)
        grads[mode] = torch.autograd.grad(o, ins, w)
    for a, b in zip(grads["auto"], grads["plain"]):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_cuda_moe_routes_equal_cpu_and_grads_rerun_bitwise(cuda_device,
                                                          arch):
    """A reduced MoE on the card: ``moe_apply``'s routes (top-k in order,
    the keep mask, with drops) equal the CPU's, its output within f32
    rtol 1e-4 / atol 2e-5, and ``loss_fn``'s gradients bitwise equal over
    two runs (no atomics in the dispatch and combine backward)."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.models import moe
    cfg = reduce_config(get_config(arch), 4).replace(dtype="float32")
    params = tmodel.init_params(cfg, generator=torch.Generator(
        "cpu").manual_seed(0), device="cpu")
    bp = tree_map(lambda a: a[0], params["stages"][0]["pos0"]["moe"])
    x = torch.randn(2, 256, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    with moe.route_log(keep_routes=True) as cpu:
        yc, _ = moe.moe_apply(bp, x, cfg, capacity=64)
    with moe.route_log(keep_routes=True) as card:
        yg, _ = moe.moe_apply(tree_map(lambda a: a.to(cuda_device), bp),
                              x.to(cuda_device), cfg, capacity=64)
    assert card.dropped == cpu.dropped > 0
    for (ti, tk, _), (ci, ck, _) in zip(card.routes, cpu.routes):
        assert torch.equal(ti, ci) and torch.equal(tk, ck)
    torch.testing.assert_close(yg.cpu(), yc, **F32_TOL)
    toks = torch.randint(0, cfg.vocab_size, (4, 64),
                         generator=torch.Generator().manual_seed(1))
    pg = tree_map(lambda a: a.to(cuda_device).requires_grad_(), params)
    leaves = _flatten_with_names(pg)[1]
    grads = []
    for _ in range(2):
        loss, _ = tmodel.loss_fn(pg, cfg, {"tokens": toks.to(cuda_device)})
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(_bits(a), _bits(b))
