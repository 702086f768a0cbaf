#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

What it does, failing (non-zero exit, no result line) on any error:

1. device: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, and the build of every CUDA kernel of the serving
   and training paths from the sources in the checkout (``nvcc`` for
   ``sm_90a``, one process per source, with the ``-Xptxas -v`` register
   / shared-memory summary);
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the full-width ``internlm2-1.8b`` serving path:
   decode attention within a stated tolerance (GQA group 1/2/4, ring,
   window, softcap, f32/bf16), the row scatter-swap bitwise, and the
   swap applied twice is the identity;
3. each kernel's time (CUDA events, warm, L2 exceeded) beside its bound
   (bytes over 3.35 TB/s or operations over the peak rate, whichever is
   larger), its plain version's time and one PyTorch library call's time
   as a yardstick;
4. the main path: ``python -m repro_torch.launch.serve`` at the full
   width of ``internlm2-1.8b`` (random weights from a seed, two demo
   adapter tenants, the kernel decode attention), with every kernel's
   launch count reset just before and read just after — a kernel that
   did not launch there fails the run; then a ``DecodeServer`` run with
   200-900-token prompts, so decode crosses several 128-row k-blocks;
5. a teacher-forced check: the same prompts and the same fed tokens for
   16 decode steps through ``attn_impl="kernel"`` and ``"full"``; the
   largest logit difference per step against a stated tolerance, in f32
   compute and in bf16 compute; then a ``torch.profiler`` window of
   steady full-width decode steps (wall vs device busy, top kernels);
6. training (the port's slice 2), ``internlm2-1.8b`` at full width:
   masked Adam (f32 moments) and Q8 masked Adam against their plain
   versions on the card (ragged sizes and the main path's leaf shapes;
   f32 within 2 ulp, bf16 parameters within one bf16 ulp, Q8 codes and
   scales bitwise), then their times over the main path's whole
   12-leaf selection beside the bound, the plain version and
   ``torch._fused_adam_``;
7. the training main path: ``python -m repro_torch.launch.train --arch
   internlm2-1.8b --reduce 0 --optimizer blockllm+q8 --batch 8 --seq 256
   --steps 8`` (full width, full depth, random weights from a seed) with
   the launch counts reset just before and read just after — the Q8
   kernel must have launched; loss per step, step times, peak memory;
8. through the API: ``blockllm`` with f32 moments and
   ``fused_update="kernel"`` (the f32 kernel must launch), then full
   ``adam`` at the same batch: the paper's memory comparison; then a
   ``torch.profiler`` window of 2 steady ``blockllm`` steps;
9. checkpoint -> crash -> resume -> export -> serve at full width with
   the depth cut to 4 layers (full depth would write about 12 GB of npz
   per checkpoint): the resumed run equals the uninterrupted one
   bitwise, its exported BlockDelta tenant is served through
   ``DecodeServer`` with kernel attention and gives the tokens of a
   server whose base has the trained rows written in;
10. a ``kernels:`` summary and one JSON line with every kernel's numbers,
   the card's name and power limit again, and as the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of the JAX package.  Long logs (ptxas output, the
profile tables) go to the ``OUT`` directory beside it; checkpoints and
the adapter registry (gigabytes) go to ``SCRATCH``, which ``.gitignore``
lists, and are deleted at the end.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
SCRATCH = ROOT / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                  # f32 outside the tensor cores
ARCH = "internlm2-1.8b"

# tolerances (reasons beside each)
ATTN_F32_RTOL, ATTN_F32_ATOL = 1e-4, 2e-5   # f32 output: summation order
ATTN_BF16_ATOL = 2e-2     # bf16 output: one rounding step apart at |o| < 4
LOGIT_F32_TOL = 2e-3      # f32 model: the two attentions differ in order only
LOGIT_BF16_TOL = 0.25     # bf16 model: the full path rounds probabilities
                          # to bf16 before PV, the kernel keeps f32
ADAM_F32_ULPS = 2         # masked Adam: the kernel and its plain version do
ADAM_BF16_ULPS = 1        # the same IEEE ops in the same order (no FMA)
SERVE_KERNELS = ("decode_attention", "scatter_swap")
TRAIN_ARGV = ["--arch", ARCH, "--reduce", "0", "--optimizer", "blockllm+q8",
              "--batch", "8", "--seq", "256", "--steps", "8"]


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` warm calls (CUDA events)."""
    import torch
    for _ in range(3):
        fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Mean device milliseconds per call: ``iters`` calls captured in one
    CUDA graph and replayed, so host launch overhead is not counted."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def ptxas_summary(log: str, want: str):
    """(entry, registers, spill line) for entries whose name holds
    ``want``, plus the largest register count of the whole library."""
    rows, entry, most = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "Used" in line and "registers" in line and entry:
            regs = int(line.split("Used")[1].split("registers")[0])
            most = max(most, regs)
            if want in entry:
                rows.append((entry, line.strip()))
        elif "spill" in line and entry and want in entry:
            rows.append((entry, line.strip()))
    return rows, most


# --------------------------------------------------------------------- #
# phase 2 + 3: kernels against their plain versions, and their times
# --------------------------------------------------------------------- #


def check_decode_attention(torch, da, results):
    dev = "cuda"
    g = torch.Generator(dev).manual_seed(0)
    B, C, KV, hd = 8, 2048, 8, 128
    pos_main = [0, 127, 128, 1000, 2047, 513, 1536, 64]
    cases = [  # name, G, C, window, ring, softcap, q dtype, cache dtype
        ("main G2 bf16", 2, C, 0, False, 0.0, torch.bfloat16, torch.bfloat16),
        ("G2 f32 q", 2, C, 0, False, 0.0, torch.float32, torch.bfloat16),
        ("G1", 1, C, 0, False, 0.0, torch.float32, torch.bfloat16),
        ("G4", 4, C, 0, False, 0.0, torch.float32, torch.bfloat16),
        ("window 256", 2, C, 256, False, 0.0, torch.float32, torch.bfloat16),
        ("ring C512", 2, 512, 512, True, 0.0, torch.float32, torch.bfloat16),
        ("softcap 30", 2, C, 0, False, 30.0, torch.float32, torch.bfloat16),
        ("f32 cache", 2, C, 0, False, 0.0, torch.float32, torch.float32),
    ]
    worst = 0.0
    for name, G, Cc, window, ring, softcap, qd, cd in cases:
        q = torch.randn(B, 1, KV * G, hd, generator=g, device=dev).to(qd)
        k = torch.randn(B, Cc, KV, hd, generator=g, device=dev).to(cd)
        v = torch.randn(B, Cc, KV, hd, generator=g, device=dev).to(cd)
        pos = ([0, 100, 511, 512, 900, 1500, 2047, 3000] if ring
               else [min(p, Cc - 1) for p in pos_main])
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        kw = dict(window=window, ring=ring, softcap=softcap)
        o = da.decode_attention_cuda(q, k, v, pos, **kw)
        r = da.decode_attention_plain(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        err = (o.float() - r.float()).abs()
        if qd == torch.float32:
            tol = ATTN_F32_ATOL + ATTN_F32_RTOL * r.float().abs()
            tol_s = f"rtol {ATTN_F32_RTOL} atol {ATTN_F32_ATOL}"
        else:
            tol = torch.full_like(err, ATTN_BF16_ATOL)
            tol_s = f"atol {ATTN_BF16_ATOL}"
        ok = bool((err <= tol).all()) and bool(torch.isfinite(o).all())
        print(f"decode_attention [{name}] B{B} C{Cc} KV{KV} G{G} hd{hd} "
              f"q {str(qd)[6:]} cache {str(cd)[6:]}: max|kernel-plain| "
              f"{err.max().item():.3g} ({tol_s}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention [{name}] disagrees "
                                 f"with its plain version")
        if name.startswith("main"):
            worst = err.max().item()
    # times at the main path's shapes: ring of cache copies > L2
    copies = 8
    q = torch.randn(B, 1, KV * 2, hd, generator=g, device=dev).bfloat16()
    ks = [torch.randn(B, C, KV, hd, generator=g, device=dev).bfloat16()
          for _ in range(copies)]
    vs = [torch.randn(B, C, KV, hd, generator=g, device=dev).bfloat16()
          for _ in range(copies)]
    pos = torch.tensor(pos_main, dtype=torch.int32, device=dev)
    valid = torch.arange(C, device=dev)[None, :] <= pos[:, None].long()
    mask = valid[:, None, None, :]
    qt = q.transpose(1, 2)
    fns = {
        "kernel": lambda i: da.decode_attention_cuda(
            q, ks[i % copies], vs[i % copies], pos),
        "plain": lambda i: da.decode_attention_plain(
            q, ks[i % copies], vs[i % copies], pos),
        "sdpa": lambda i: torch.nn.functional.scaled_dot_product_attention(
            qt, ks[i % copies].transpose(1, 2),
            vs[i % copies].transpose(1, 2), attn_mask=mask,
            enable_gqa=True)}
    # device time (CUDA graph replay) and eager time per call (host
    # launch overhead included), each in turns
    dev_ms = {k: graph_time_ms(f) for k, f in fns.items()}
    eager_ms = {k: cuda_time_ms(f, 50) for k, f in fns.items()}
    ms, plain_ms, lib_ms = dev_ms["kernel"], dev_ms["plain"], dev_ms["sdpa"]
    # bound: q read, each slot's K/V rows lo*bk..pos read once, o written
    lo, hi = da.block_bounds(pos.cpu(), seq_len=C)
    rows = sum(int(p) + 1 - int(l) * 128 for p, l in zip(pos.cpu(), lo))
    nbytes = 2 * q.nbytes + rows * KV * hd * 2 * 2
    flops = rows * KV * 2 * hd * 4               # QK and PV, G = 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    results["decode_attention"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_ms)
    print(f"decode_attention time B{B} C{C} KV{KV} G2 hd{hd} bf16, pos "
          f"{pos_main}: device (graph replay) kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; bound "
          f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.2f} MB); eager per "
          f"call kernel {eager_ms['kernel']:.4f} ms, plain "
          f"{eager_ms['plain']:.4f} ms, sdpa {eager_ms['sdpa']:.4f} ms")


def check_scatter_swap(torch, sa, results):
    dev = "cuda"
    G, C = 24, 2048 * 8192                      # w_gate [24, 2048, 8192]
    idx = [1, 3]
    for dt in (torch.float32, torch.bfloat16):
        full = torch.randn(G, C, device=dev).to(dt)
        orig = full.clone()
        rows = torch.randn(len(idx), C, device=dev).to(dt)
        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        kf, kd = sa.scatter_swap_cuda(full.clone(), idx, rows)
        pf, pd = sa.scatter_swap_plain(full.clone(), idx, rows)
        torch.cuda.synchronize()
        ok = (torch.equal(kf.view(bits), pf.view(bits))
              and torch.equal(kd.view(bits), pd.view(bits)))
        back, bd = sa.scatter_swap_cuda(kf, idx, kd)      # in place on kf
        torch.cuda.synchronize()
        ok = (ok and torch.equal(back.view(bits), orig.view(bits))
              and torch.equal(bd.view(bits), rows.view(bits)))
        print(f"scatter_swap [{str(dt)[6:]}] full [{G}, {C}] K {len(idx)}: "
              f"bitwise vs plain and apply∘apply == identity: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("scatter_swap disagrees with its plain "
                                 "version or is not an involution")
        del kf, kd, pf, pd, back, bd
    full = torch.randn(G, C, device=dev)
    rows = [torch.randn(len(idx), C, device=dev) for _ in range(2)]
    ms = cuda_time_ms(lambda i: sa.scatter_swap_cuda(full, idx,
                                                     rows[i % 2]), 50)
    plain_ms = cuda_time_ms(lambda i: sa.scatter_swap_plain(
        full, idx, rows[i % 2]), 20)
    ix = torch.tensor(idx, device=dev)

    def library(i):
        disp = full.index_select(0, ix)
        full.index_copy_(0, ix, rows[i % 2])
        return disp

    lib_ms = cuda_time_ms(library, 50)
    nbytes = 4 * len(idx) * C * 4               # 2 row reads + 2 row writes
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    results["scatter_swap"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes", library_ms=lib_ms)
    print(f"scatter_swap time full [{G}, {C}] f32 K {len(idx)}: kernel "
          f"{ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), "
          f"plain {plain_ms:.4f} ms, index_select+index_copy_ "
          f"{lib_ms:.4f} ms")


# --------------------------------------------------------------------- #
# phase 4 + 5: the serving path at full width
# --------------------------------------------------------------------- #


def serve_long_prompts(torch, np):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_demo_registry
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.serve_config import ServeConfig
    from repro_torch.runtime.serve_loop import DecodeServer, Request

    cfg = get_config(ARCH)
    params = model_lib.init_params(
        cfg, generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    registry, ids = make_demo_registry(params, 2)
    tenants = [None] + ids
    srv = DecodeServer(cfg, params, ServeConfig(
        batch_slots=8, max_seq=1024, attn_impl="kernel"), registry=registry)
    del params
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(200, 901))),
                    max_new_tokens=32, adapter_id=tenants[i % 3])
            for i in range(16)]
    for r in reqs:
        srv.submit(r)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    srv.run_until_drained()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    st = srv.stats()
    tok = sum(len(r.out) for r in reqs)
    print(f"long-prompt serve ({ARCH}, 8 slots, prompts 200-900, 3 "
          f"tenants): {tok} tokens in {dt:.2f} s ({tok / dt:.1f} tok/s), "
          f"decode step ms p50 {st['decode']['step_ms']['p50']:.2f} "
          f"p99 {st['decode']['step_ms']['p99']:.2f}, "
          f"{st['decode']['steps']} steps, prefill "
          f"{st['prefill']['prompt_tokens']} prompt tokens in "
          f"{st['prefill']['dispatches']} dispatches, swaps "
          f"{st['sched']['swaps']}, launches {launches}")
    if not all(r.done and len(r.out) == 32 for r in reqs):
        raise AssertionError("long-prompt serve left requests unfinished")
    if not all(launches[k] for k in SERVE_KERNELS):
        raise AssertionError(f"a kernel did not launch: {launches}")
    srv.restore_base()
    return srv


def teacher_forced(torch, np):
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib

    base_cfg = get_config(ARCH)
    rng = np.random.default_rng(2)
    B, steps, max_seq = 8, 16, 1024
    lengths = rng.integers(300, 900, B)
    prompt = rng.integers(0, base_cfg.vocab_size, (B, int(lengths.max())))
    params = model_lib.init_params(
        base_cfg, generator=torch.Generator("cuda").manual_seed(2),
        device="cuda")
    for dtype, tol in (("float32", LOGIT_F32_TOL),
                       ("bfloat16", LOGIT_BF16_TOL)):
        cfg = base_cfg.replace(dtype=dtype)
        logits = {}
        fed = []
        for impl in ("kernel", "full"):
            cache = model_lib.init_cache(cfg, B, max_seq, device="cuda")
            last = None
            for s in range(0, prompt.shape[1], 128):
                toks = torch.as_tensor(prompt[:, s:s + 128], device="cuda")
                lg, _ = model_lib.prefill_into_slots(
                    params, cfg, cache, toks, lengths, chunk_start=s)
                done = (lengths > s) & (lengths <= s + toks.shape[1])
                last = lg if last is None else torch.where(
                    torch.as_tensor(done, device="cuda")[:, None], lg, last)
            tok = last.argmax(-1)
            pos = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
            out = []
            for i in range(steps):
                t = fed[i] if impl == "full" else tok
                if impl == "kernel":
                    fed.append(t)
                lg, _ = model_lib.decode_step(params, cfg, cache, t[:, None],
                                              pos, attn_impl=impl)
                out.append(lg.float())
                tok = lg.argmax(-1)
                pos = pos + 1
            logits[impl] = out
        diffs = [(a - b).abs().max().item()
                 for a, b in zip(logits["kernel"], logits["full"])]
        finite = all(bool(torch.isfinite(a).all()) for a in logits["kernel"])
        scale = max(a.abs().max().item() for a in logits["full"])
        print(f"teacher-forced {dtype} ({ARCH}, B{B}, prompts "
              f"{int(lengths.min())}-{int(lengths.max())}, {steps} steps): "
              f"max|logit kernel - full| per step "
              f"{[round(d, 5) for d in diffs]} (tol {tol}; max|logit| "
              f"{scale:.3g}) {'ok' if max(diffs) <= tol and finite else 'FAIL'}")
        if not finite or max(diffs) > tol:
            raise AssertionError(f"teacher-forced {dtype} logits disagree")


def profile_decode(torch, np):
    """Where a full-width decode step's time goes: 4 steady bf16 decode
    steps (8 slots, 300-900-token contexts, kernel attention) under
    ``torch.profiler``: wall per step, device busy per step, top kernels."""
    from torch.autograd import DeviceType
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config(ARCH)
    rng = np.random.default_rng(3)
    B, max_seq = 8, 1024
    lengths = rng.integers(300, 900, B)
    prompt = rng.integers(0, cfg.vocab_size, (B, int(lengths.max())))
    params = model_lib.init_params(
        cfg, generator=torch.Generator("cuda").manual_seed(3), device="cuda")
    cache = model_lib.init_cache(cfg, B, max_seq, device="cuda")
    for s in range(0, prompt.shape[1], 128):
        model_lib.prefill_into_slots(
            params, cfg, cache,
            torch.as_tensor(prompt[:, s:s + 128], device="cuda"), lengths,
            chunk_start=s)
    pos = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    tok = torch.zeros(B, 1, dtype=torch.int64, device="cuda")

    def step():
        nonlocal pos, tok
        lg, _ = model_lib.decode_step(params, cfg, cache, tok, pos,
                                      attn_impl="kernel")
        tok = lg.argmax(-1, keepdim=True).cpu().to("cuda")
        pos = pos + 1

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    n = 4
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / n
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / n
    print(f"decode step profile ({ARCH}, bf16, B{B}, contexts "
          f"{int(lengths.min())}-{int(lengths.max())}, kernel attention, "
          f"{n} steps): wall {wall_ms:.2f} ms/step, device busy "
          f"{busy:.2f} ms/step, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.1%}")
    groups = {"decode_attention (both passes)": 0.0, "gemm/gemv": 0.0,
              "elementwise/copy": 0.0, "other": 0.0}
    for e in rows:
        name = e.key.lower()
        t = e.self_device_time_total / 1e3 / n
        if "decode_attention" in name:
            groups["decode_attention (both passes)"] += t
        elif any(w in name for w in ("gemm", "gemv", "cutlass", "sm90_",
                                     "matmul", "nvjet")):
            groups["gemm/gemv"] += t
        elif any(w in name for w in ("elementwise", "copy", "cast",
                                     "vectorized", "unrolled")):
            groups["elementwise/copy"] += t
        else:
            groups["other"] += t
    print("  device ms/step by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in groups.items()))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/step "
              f"{e.count // n:5d} calls/step  {e.key[:70]}")
    (OUT / "decode_profile.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))

# --------------------------------------------------------------------- #
# phases 6-9: training (masked Adam, the BlockLLM trainers)
# --------------------------------------------------------------------- #


def ulps(torch, a, b) -> int:
    """Largest distance in units of the last place (f32 or bf16)."""
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return int((a.view(bits).long() - b.view(bits).long()).abs().max())


def selection_shapes(cfg, k):
    """Leaf shapes of the main path's BlockLLM selection: K rows of each of
    the 9 stacked leaves, plus the embed, head and final_norm units."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv = cfg.num_heads * cfg.resolved_head_dim, (
        cfg.num_kv_heads * cfg.resolved_head_dim)
    rows = {"ln1": (d,), "ln2": (d,), "wq": (d, hq), "wk": (d, hkv),
            "wv": (d, hkv), "wo": (hq, d), "w_up": (d, f), "w_gate": (d, f),
            "w_down": (f, d)}
    out = {n: (k,) + shp for n, shp in rows.items()}
    out.update(embed=(V, d), head=(d, V), final_norm=(d,))
    return out


def adam_inputs(torch, shape, dtype, seed, offset=0):
    g = torch.Generator("cuda").manual_seed(seed)
    n = 1
    for x in shape:
        n *= x

    def mk():
        return torch.randn(n + offset, generator=g,
                           device="cuda")[offset:].view(shape)
    p, gr = mk().to(dtype), (mk() * 0.01).to(dtype)
    m = mk() * 1e-3
    v = mk().abs_() * 1e-5
    mask = torch.rand(shape, generator=g, device="cuda") > 0.875
    return p, gr, m, v, mask


def check_masked_adam(torch, ma, results):
    """Both kernels against their plain versions: ragged and misaligned
    sizes, and the main path's largest leaf shapes (a stacked leaf's 6
    selected rows, the embedding table)."""
    from repro_torch.configs.base import get_config
    from repro_torch.runtime.compression import quantize_int8
    cfg = get_config(ARCH)
    shapes = selection_shapes(cfg, 6)
    cases = [((100, 257), 0), ((4099,), 1), ((7,), 0),
             (shapes["w_gate"], 0), (shapes["embed"], 0)]
    scal = ma.scalars(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                      count=3, tau=0.7)
    worst = {"masked_adam": 0.0, "masked_adam_q8": 0.0}
    for shape, off in cases:
        big = shape in (shapes["w_gate"], shapes["embed"])
        for dt in ((torch.float32,) if big else
                   (torch.float32, torch.bfloat16)):
            for gate in ("mask", "none", "tau"):
                p, g, m, v, mask = adam_inputs(torch, shape, dt, 11, off)
                mk = mask if gate == "mask" else None
                tau = gate == "tau"
                # f32 moments
                kp, km, kv = p.clone(), m.clone(), v.clone()
                ma.masked_adam_cuda(kp, g, km, kv, mk, scal, use_tau=tau)
                pp, pm, pv = p.clone(), m.clone(), v.clone()
                ma.masked_adam_plain(pp, g, pm, pv, mk, scal, use_tau=tau)
                torch.cuda.synchronize()
                lim = ADAM_BF16_ULPS if dt == torch.bfloat16 else ADAM_F32_ULPS
                u = (ulps(torch, kp, pp), ulps(torch, km, pm),
                     ulps(torch, kv, pv))
                err = (kp.float() - pp.float()).abs().max().item()
                ok = u[0] <= lim and max(u[1:]) <= ADAM_F32_ULPS
                print(f"masked_adam [{gate}] {tuple(shape)} "
                      f"{str(dt)[6:]}{' misaligned' if off else ''}: ulps "
                      f"p/m/v {u}, max|kernel-plain| p {err:.3g} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("masked_adam disagrees with its "
                                         "plain version")
                if big and dt == torch.float32:
                    worst["masked_adam"] = max(worst["masked_adam"], err)
                del kp, km, kv, pp, pm, pv
                # Q8 moments
                q = [t for pair in (quantize_int8(m), quantize_int8(v))
                     for t in pair]
                k8 = [p.clone()] + [t.clone() for t in q]
                ma.masked_adam_q8_cuda(k8[0], g, *k8[1:], mk, scal,
                                       use_tau=tau)
                p8 = [p.clone()] + [t.clone() for t in q]
                ma.masked_adam_q8_plain(p8[0], g, *p8[1:], mk, scal,
                                        use_tau=tau)
                torch.cuda.synchronize()
                codes = (torch.equal(k8[1], p8[1])
                         and torch.equal(k8[3], p8[3]))
                scales = (torch.equal(k8[2].view(torch.int32),
                                      p8[2].view(torch.int32))
                          and torch.equal(k8[4].view(torch.int32),
                                          p8[4].view(torch.int32)))
                up = ulps(torch, k8[0], p8[0])
                err = (k8[0].float() - p8[0].float()).abs().max().item()
                ok = codes and scales and up <= lim
                print(f"masked_adam_q8 [{gate}] {tuple(shape)} "
                      f"{str(dt)[6:]}: codes bitwise {codes}, scales "
                      f"bitwise {scales}, p ulps {up} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("masked_adam_q8 disagrees with its "
                                         "plain version")
                if big and dt == torch.float32:
                    worst["masked_adam_q8"] = max(worst["masked_adam_q8"],
                                                  err)
                del k8, p8, q, p, g, m, v, mask
    for name in worst:
        results[name] = {"max_abs_err": worst[name]}
    torch.cuda.empty_cache()


def time_masked_adam(torch, ops, results):
    """Device time of one optimizer step over the main path's whole
    selection (12 leaves, 756.6 M elements): the kernels, their plain
    versions, and ``torch._fused_adam_`` (Adam without a mask) as the
    nearest one-call yardstick."""
    from repro_torch.configs.base import get_config
    from repro_torch.optim.q8adam import quantize_tree
    cfg = get_config(ARCH)
    shapes = selection_shapes(cfg, 6)
    n = sum(int(torch.Size(s).numel()) for s in shapes.values())
    g = torch.Generator("cuda").manual_seed(12)
    p = {k: torch.randn(s, generator=g, device="cuda") for k, s in
         shapes.items()}
    gr = {k: torch.randn(s, generator=g, device="cuda") * 0.01
          for k, s in shapes.items()}
    m = {k: torch.randn(s, generator=g, device="cuda") * 1e-3
         for k, s in shapes.items()}
    v = {k: torch.rand(s, generator=g, device="cuda") * 1e-5
         for k, s in shapes.items()}
    mask = {k: torch.rand(s, generator=g, device="cuda") > 0.875
            for k, s in shapes.items()}
    kw = dict(lr=1e-3, count=3, weight_decay=0.0)
    f32 = {"kernel": lambda i: ops.masked_adam_tree(p, gr, m, v, mask,
                                                    mode="kernel", **kw),
           "plain": lambda i: ops.masked_adam_tree(p, gr, m, v, mask,
                                                   mode="plain", **kw)}
    steps = [torch.full((), 4.0, device="cuda") for _ in p]
    args = [list(t.values()) for t in (p, gr, m, v)]
    lib = (lambda i: torch._fused_adam_(
        *args, [], steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.0,
        eps=1e-8, amsgrad=False, maximize=False))
    ms = {"kernel": cuda_time_ms(f32["kernel"], 10),
          "plain": cuda_time_ms(f32["plain"], 3),
          "library": cuda_time_ms(lib, 10)}
    ms["kernel2"] = cuda_time_ms(f32["kernel"], 10)
    mq, ms_, vq, vs = (*quantize_tree(m), *quantize_tree(v))
    del m, v, args
    torch.cuda.empty_cache()
    q8 = {"kernel": lambda i: ops.masked_adam_q8_tree(
              p, gr, mq, ms_, vq, vs, mask, mode="kernel", **kw),
          "plain": lambda i: ops.masked_adam_q8_tree(
              p, gr, mq, ms_, vq, vs, mask, mode="plain", **kw)}
    ms8 = {"kernel": cuda_time_ms(q8["kernel"], 10),
           "plain": cuda_time_ms(q8["plain"], 3)}
    ms8["kernel2"] = cuda_time_ms(q8["kernel"], 10)
    # bounds: every input read once, every output written once
    nb = n // 256 + len(shapes)                      # codec blocks, rounded up
    f32_bytes = n * (4 * 4 + 1) + n * 3 * 4          # p g m v mask; p m v
    q8_bytes = (n * (4 + 4 + 1 + 2) + nb * 8         # p g mask codes, scales
                + n * (4 + 2) + nb * 8)              # p codes, scales
    f32_ops, q8_ops = 16 * n, 22 * n                 # flops per element
    for name, nbytes, nops, t, lib_ms in (
            ("masked_adam", f32_bytes, f32_ops, ms, ms["library"]),
            ("masked_adam_q8", q8_bytes, q8_ops, ms8, None)):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS * 1e3
        results[name].update(
            ms=t["kernel"], plain_ms=t["plain"], bound_ms=max(tb, to),
            bound_by="bytes" if tb >= to else "operations",
            library_ms=lib_ms)
        print(f"{name} time, one step over the {len(shapes)}-leaf selection "
              f"({n / 1e6:.1f} M elements, {nbytes / 1e9:.2f} GB moved): "
              f"kernel {t['kernel']:.3f} ms (again {t['kernel2']:.3f}), "
              f"bound {max(tb, to):.3f} ms, plain {t['plain']:.3f} ms"
              + (f", torch._fused_adam_ {lib_ms:.3f} ms (no mask: reads "
                 f"1 B/element less)" if lib_ms is not None else
                 ", no one-call library equivalent"))
    del p, gr, mask, mq, ms_, vq, vs
    torch.cuda.empty_cache()


def reference_small(torch, np):
    """Small-input reference: 6 BlockLLM steps of reduced internlm2 (f32)
    on the card (the kernels) and on the CPU (their plain versions), from
    the same weights and batches, f32 and Q8 moments.  Adam eps 1e-3, as
    in tests/test_torch_blockllm.py (with 1e-8 the refresh-step mask is
    decided by rounding).  Losses within rtol 1e-4, the same selections."""
    from repro_torch import trainers
    from repro_torch.adapters import copy_tree
    from repro_torch.checkpoint.checkpointer import tree_map
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.core.blockllm import BlockLLMConfig
    from repro_torch.core.selection import SelectorConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adam import Adam
    cfg = reduce_config(get_config(ARCH), 8).replace(dtype="float32")
    params = model_lib.init_params(cfg, generator=torch.Generator(
        "cpu").manual_seed(4), device="cpu")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=4, seed=4))
    sel = SelectorConfig(sparsity=0.9, static_k_frac=0.34, reselect_every=3)
    for q8 in (False, True):
        runs = {}
        for dev, fused in (("cuda", "kernel"), ("cpu", "plain")):
            tr = trainers.handle(
                "blockllm", cfg, tree_map(lambda a: a.to(dev),
                                          copy_tree(params)),
                device=dev, adam=Adam(lr=1e-3, eps=1e-3), quantize_state=q8,
                bcfg=BlockLLMConfig(selector=sel, fused_update=fused))
            runs[dev] = ([tr.train_step(pipe.batch(s))["loss"]
                          for s in range(6)], tr.state.meta)
        lc, lp = runs["cuda"][0], runs["cpu"][0]
        rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
        same = all(runs["cuda"][1][k] == runs["cpu"][1][k] for k in
                   ("stack_idx", "probe_idx", "active_leaves"))
        ok = rel <= 1e-4 and same and np.isfinite(lc).all()
        print(f"small-input reference ({'Q8' if q8 else 'f32'} moments, "
              f"reduced {ARCH}, 6 steps, 2 reselections): card (kernels) "
              f"vs CPU (plain) losses max rel diff {rel:.2e} (rtol 1e-4), "
              f"same selections {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("training on the card disagrees with the "
                                 "CPU reference")


def train_main_path(torch, np, ops):
    """The slice's main path through the launcher a user calls."""
    from repro_torch.launch import train as tlaunch
    print(f"train main path: python -m repro_torch.launch.train "
          f"{' '.join(TRAIN_ARGV)}")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = tlaunch.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses, step_ms = out["losses"], out["step_ms"]
    rest = np.asarray(step_ms[1:])
    vocab = out["trainer"].cfg.vocab_size
    print(f"train main path: losses per step {[round(x, 4) for x in losses]}"
          f"; step ms: refresh step {step_ms[0]:.1f}, the other "
          f"{len(rest)} p50 {np.percentile(rest, 50):.1f} p99 "
          f"{np.percentile(rest, 99):.1f}; {wall:.1f} s wall including "
          f"init; launches {launches}; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB")
    if not (np.isfinite(losses).all() and len(losses) == 8):
        raise AssertionError("train main path: non-finite or missing loss")
    if abs(losses[0] - np.log(vocab)) > 1.0:
        raise AssertionError(f"first loss {losses[0]:.3f} is not near "
                             f"ln(vocab) = {np.log(vocab):.3f}")
    if launches["masked_adam_q8"] == 0:
        raise AssertionError("masked_adam_q8 did not launch on the train "
                             "main path")
    # the Q8 state: a v code of 0 beside a non-zero m code makes Adam's
    # step m_hat / eps (the reference's Q8 divergence, ROADMAP C)
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    opt = out["trainer"].state.arrays["opt"]
    pairs = list(zip(_flatten_with_names(opt.mu_q)[1],
                     _flatten_with_names(opt.nu_q)[1]))
    flushed = sum(int(((vq == 0) & (mq != 0)).sum()) for mq, vq in pairs)
    total = sum(vq.numel() for _, vq in pairs)
    print(f"train main path: Q8 state after the run: {flushed} of {total} "
          f"moment elements ({flushed / total:.1%}) have v code 0 beside a "
          f"non-zero m code")
    report = out["trainer"].memory_report()
    del out, opt, pairs
    torch.cuda.empty_cache()
    return launches, peak, report


def profile_train(torch, core, state, pipe, first):
    """2 steady BlockLLM steps under torch.profiler: wall vs device busy,
    the masked-Adam kernels' share, the top kernels."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = 2
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for s in range(first, first + n):
            state, _ = core.step(state, pipe.batch(s))
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / n
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / n
    adam = sum(e.self_device_time_total for e in rows
               if "masked_adam" in e.key) / 1e3 / n
    print(f"train step profile ({ARCH}, blockllm f32 moments, fused "
          f"kernel, batch 8 x 256, {n} steady steps): wall {wall_ms:.1f} "
          f"ms/step, device busy {busy:.1f} ms/step, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.1%}, masked_adam "
          f"{adam:.3f} ms/step ({adam / max(busy, 1e-9):.1%} of busy)")
    groups = {"gemm": 0.0, "elementwise/copy": 0.0, "reduce/softmax": 0.0,
              "masked_adam": 0.0, "other": 0.0}
    for e in rows:
        name = e.key.lower()
        t = e.self_device_time_total / 1e3 / n
        if "masked_adam" in name:
            groups["masked_adam"] += t
        elif any(w in name for w in ("gemm", "cutlass", "sm90_", "nvjet",
                                     "matmul")):
            groups["gemm"] += t
        elif any(w in name for w in ("reduce", "softmax", "norm", "sort",
                                     "scan")):
            groups["reduce/softmax"] += t
        elif any(w in name for w in ("elementwise", "copy", "cast",
                                     "vectorized", "unrolled", "index",
                                     "gather", "scatter")):
            groups["elementwise/copy"] += t
        else:
            groups["other"] += t
    print("  device ms/step by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in groups.items()))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/step "
              f"{e.count // n:5d} calls/step  {e.key[:70]}")
    (OUT / "train_profile.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    return state


def train_api(torch, np, ops, q8_peak, q8_report):
    """blockllm (f32 moments, fused_update="kernel") then full adam, at
    the main path's width, depth and batch: the memory comparison."""
    from repro_torch import trainers
    from repro_torch.configs.base import get_config
    from repro_torch.core.blockllm import BlockLLMConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim.adam import Adam
    cfg = get_config(ARCH)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                    global_batch=8, seed=0))
    core = trainers.make("blockllm", cfg, adam=Adam(lr=1e-3),
                         bcfg=BlockLLMConfig(fused_update="kernel"),
                         device="cuda")
    state = core.init(torch.Generator("cuda").manual_seed(0))
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for s in range(8):
        t0 = time.monotonic()
        state, m = core.step(state, pipe.batch(s))   # ends in a host read
        step_ms.append((time.monotonic() - t0) * 1e3)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_f32 = torch.cuda.max_memory_allocated()
    rep_f32 = core.memory_report(state)
    print(f"blockllm f32 moments (fused_update='kernel'), 8 steps: losses "
          f"{[round(x, 4) for x in losses]}; step ms: refresh step "
          f"{step_ms[0]:.1f}, the other 7 p50 "
          f"{np.percentile(step_ms[1:], 50):.1f} p99 "
          f"{np.percentile(step_ms[1:], 99):.1f}; launches {launches}, peak "
          f"device memory {peak_f32 / 2 ** 30:.2f} GiB")
    if launches["masked_adam"] == 0 or not np.isfinite(losses).all():
        raise AssertionError("masked_adam did not launch (or the loss is "
                             "not finite) on the f32 path")
    state = profile_train(torch, core, state, pipe, 8)
    del state, core
    torch.cuda.empty_cache()
    core = trainers.make("adam", cfg, adam=Adam(lr=1e-3), device="cuda")
    state = core.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    a_losses, a_ms = [], []
    for s in range(3):
        t0 = time.monotonic()
        state, m = core.step(state, pipe.batch(s))
        a_ms.append((time.monotonic() - t0) * 1e3)
        a_losses.append(m["loss"])
    torch.cuda.synchronize()
    peak_adam = torch.cuda.max_memory_allocated()
    rep_adam = core.memory_report(state)
    print(f"adam (dense), 3 steps: losses {[round(x, 4) for x in a_losses]}"
          f", step ms {[round(x, 1) for x in a_ms]}, peak device memory "
          f"{peak_adam / 2 ** 30:.2f} GiB")
    if not np.isfinite(a_losses).all():
        raise AssertionError("adam loss is not finite")
    del state, core
    torch.cuda.empty_cache()
    gib = lambda r: {k: round(v / 2 ** 30, 3) for k, v in r.items()}
    print(f"peak device memory ({ARCH}, batch 8 x 256): blockllm+q8 "
          f"{q8_peak / 2 ** 30:.2f} GiB, blockllm {peak_f32 / 2 ** 30:.2f} "
          f"GiB, adam {peak_adam / 2 ** 30:.2f} GiB")
    for name, rep in (("blockllm+q8", q8_report), ("blockllm", rep_f32),
                      ("adam", rep_adam)):
        print(f"  memory_report {name} (GiB): {gib(rep)}")
    return launches


def checkpoint_export_serve(torch, np, ops):
    """Checkpoint -> crash -> resume -> export -> serve, full width, depth
    cut to 4 layers (full depth writes about 12 GB of npz per checkpoint).
    blockllm+q8 (the fused Q8 kernel), patience 2 so it reselects, the
    leaf units always active (restore takes the fresh state's structure)."""
    import shutil
    from repro_torch import trainers
    from repro_torch.adapters import AdapterRegistry, copy_tree
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.configs.base import get_config
    from repro_torch.core.blockllm import BlockLLMConfig
    from repro_torch.core.selection import SelectorConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adam import Adam
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.serve_config import ServeConfig
    from repro_torch.runtime.serve_loop import DecodeServer, Request
    cfg = get_config(ARCH).replace(num_layers=4)
    params0 = model_lib.init_params(cfg, generator=torch.Generator(
        "cuda").manual_seed(7), device="cuda")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                    global_batch=8, seed=7))
    bcfg = BlockLLMConfig(selector=SelectorConfig(
        patience=2, always_active_leaves=("final_norm", "embed", "head")),
        fused_update="kernel")

    def handle():
        core = trainers.make("blockllm+q8", cfg, adam=Adam(lr=1e-3),
                             bcfg=bcfg, device="cuda")
        return trainers.TrainerHandle(core, core.init(None,
                                                      copy_tree(params0)))

    shutil.rmtree(SCRATCH, ignore_errors=True)
    t0 = time.monotonic()
    whole = handle()
    train_loop.run(whole, pipe.batch, train_loop.TrainLoopConfig(
        total_steps=6, log_every=0))
    lcfg = train_loop.TrainLoopConfig(
        total_steps=6, ckpt_every=3, log_every=0,
        ckpt_dir=str(SCRATCH / "ckpt"), adapter_dir=str(SCRATCH / "adapters"),
        adapter_id="tuned")
    crashed = handle()
    try:
        train_loop.run(crashed, pipe.batch, lcfg, crash_at=5)
        raise AssertionError("the simulated crash did not happen")
    except RuntimeError as e:
        if "simulated node failure" not in str(e):
            raise
    del crashed
    resumed = handle()
    train_loop.run(resumed, pipe.batch, lcfg)
    torch.cuda.synchronize()
    na, la, _ = _flatten_with_names(whole.state.arrays)
    nb, lb, _ = _flatten_with_names(resumed.state.arrays)
    same = (na == nb and resumed.state.meta == whole.state.meta and all(
        a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                           b.reshape(-1).view(torch.uint8))
        for a, b in zip(la, lb)))
    print(f"crash-resume ({ARCH} width, 4 layers, blockllm+q8, ckpt at 3, "
          f"crash at 5, resumed to 6; {whole.state.meta['reselections']} "
          f"selections): resumed == uninterrupted bitwise over {len(la)} "
          f"leaves and the host meta: {same} "
          f"({time.monotonic() - t0:.1f} s with checkpoint I/O)")
    if not same:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted run")
    del whole
    registry = AdapterRegistry(SCRATCH / "adapters")
    delta = registry.get("tuned")
    print(f"exported tenant 'tuned': {delta.num_rows()} rows, "
          f"{delta.nbytes / 2 ** 20:.1f} MiB, step {delta.meta['step']}")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 48)))
               for _ in range(4)]
    scfg = ServeConfig(batch_slots=4, max_seq=128, attn_impl="kernel")

    def serve(params, reg, tenant):
        srv = DecodeServer(cfg, params, scfg, registry=reg)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16,
                        adapter_id=tenant) for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        torch.cuda.synchronize()
        out = [r.out for r in reqs]
        del srv
        return out

    ops.reset_launches()
    got = serve(params0, registry, "tuned")
    launches = dict(ops.LAUNCHES)
    want = serve(resumed.merged_params(), None, None)
    ok = got == want and all(len(o) == 16 for o in got)
    print(f"serve the exported tenant (4 requests, kernel attention): "
          f"launches {launches}; tokens equal a server with the trained "
          f"rows written in: {ok}")
    if not ok or not all(launches[k] for k in SERVE_KERNELS):
        raise AssertionError("the served tenant disagrees, or a serving "
                             "kernel did not launch")
    del resumed, params0, delta, registry
    shutil.rmtree(SCRATCH, ignore_errors=True)
    torch.cuda.empty_cache()



def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the port (src/repro_torch) is not next to "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    t_start = time.monotonic()

    # phase 1: device and build
    card = smi()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import masked_adam as ma
    from repro_torch.kernels import scatter_apply as sa
    t0 = time.monotonic()
    build.build_all()
    print(f"kernel build: {time.monotonic() - t0:.1f} s "
          f"(nvcc sm_90a, one process per source, in parallel)")
    for name, info in build.BUILD_INFO.items():
        (OUT / f"ptxas_{name}.txt").write_text(info["log"])
        wants = {"decode_attention": ["Li4ELi2E"],        # hd 128, G 2
                 "scatter_swap": ["scatter_swap"],
                 # f32 p, stored mask: the main path's instantiations
                 "masked_adam": ["masked_adam_kernelIfLb0ELb1E",
                                 "masked_adam_q8_kernelIfLb0ELb1E"]}[name]
        for want in wants:
            rows, most = ptxas_summary(info["log"], want)
            if want == wants[0]:
                print(f"  {name}: {info['seconds']:.1f} s, compiled="
                      f"{info['compiled']}, max registers over all entries "
                      f"{most}")
            for entry, line in rows:
                short = entry[entry.find(name):][:60]
                print(f"    {short}: "
                      f"{line.replace('ptxas info    : ', '')}")

    # phases 2 + 3
    results = {}
    check_decode_attention(torch, da, results)
    check_scatter_swap(torch, sa, results)
    torch.cuda.empty_cache()

    # phase 4: the main path through the launcher a user calls
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--reduce", "0", "--attn-impl", "kernel",
            "--demo-adapters", "2", "--slots", "8", "--max-seq", "1024",
            "--requests", "16", "--new-tokens", "32"]
    print(f"main path: python -m repro_torch.launch.serve {' '.join(argv)}")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    reqs = serve.main(argv)
    torch.cuda.synchronize()
    main_s = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    tok = sum(len(r.out) for r in reqs)
    print(f"main path: {tok} tokens, {main_s:.2f} s wall including init "
          f"and adapter build, launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if tok != 16 * 32:
        raise AssertionError(f"main path emitted {tok} tokens, not 512")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    torch.cuda.empty_cache()
    serve_long_prompts(torch, np)
    torch.cuda.empty_cache()

    # phase 5
    teacher_forced(torch, np)
    torch.cuda.empty_cache()
    profile_decode(torch, np)
    torch.cuda.empty_cache()

    # phase 6: the training kernels against their plain versions, times
    check_masked_adam(torch, ma, results)
    time_masked_adam(torch, ops, results)
    reference_small(torch, np)
    torch.cuda.empty_cache()

    # phase 7: the training main path through the launcher
    t_launches, q8_peak, q8_report = train_main_path(torch, np, ops)

    # phase 8: the f32 kernel path and the memory comparison via the API
    f32_launches = train_api(torch, np, ops, q8_peak, q8_report)

    # phase 9: checkpoint -> crash -> resume -> export -> serve
    checkpoint_export_serve(torch, np, ops)

    # phase 10: launches are each kernel's count on its path's run:
    # serving main path, training main path (Q8), the f32 API run
    launches = {**{k: launches[k] for k in SERVE_KERNELS},
                "masked_adam_q8": t_launches["masked_adam_q8"],
                "masked_adam": f32_launches["masked_adam"]}
    path_of = {"decode_attention": "serving main path",
               "scatter_swap": "serving main path",
               "masked_adam_q8": "training main path (blockllm+q8)",
               "masked_adam": "blockllm f32 run (fused_update='kernel')"}
    csrc = "src/repro_torch/kernels/csrc/"
    sources = {"decode_attention": csrc + "decode_attention.cu",
               "scatter_swap": csrc + "scatter_swap.cu",
               "masked_adam": csrc + "masked_adam.cu",
               "masked_adam_q8": csrc + "masked_adam.cu"}
    replaces = {"decode_attention": "src/repro/kernels/decode_attention.py:186",
                "scatter_swap": "src/repro/kernels/scatter_apply.py:81",
                "masked_adam": "src/repro/kernels/masked_adam.py:152",
                "masked_adam_q8": "src/repro/kernels/masked_adam.py:117"}
    kernels = []
    for name in ("decode_attention", "scatter_swap", "masked_adam",
                 "masked_adam_q8"):
        r = results[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": sources[name], "replaces": replaces[name],
                        "launches": launches[name], **r})
        print(f"kernels: {name} launches {launches[name]} on the "
              f"{path_of[name]}, parity ok (max_abs_err "
              f"{r['max_abs_err']:.3g}), {r['ms']:.4f} ms vs bound "
              f"{r['bound_ms']:.4f} ms")
    print(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
