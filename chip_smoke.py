#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

What it does, failing (non-zero exit, no result line) on any error:

1. device: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, and the build of every CUDA kernel of the serving
   path from the sources in the checkout (``nvcc`` for ``sm_90a``, with
   the ``-Xptxas -v`` register / shared-memory summary);
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
6. a ``kernels:`` summary and one JSON line with every kernel's numbers,
   the card's name and power limit again, and as the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of the JAX package.  Long logs (ptxas output, the
profile table) go to the ``OUT`` directory beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                  # f32 outside the tensor cores
ARCH = "internlm2-1.8b"

# tolerances (reasons beside each)
ATTN_F32_RTOL, ATTN_F32_ATOL = 1e-4, 2e-5   # f32 output: summation order
ATTN_BF16_ATOL = 2e-2     # bf16 output: one rounding step apart at |o| < 4
LOGIT_F32_TOL = 2e-3      # f32 model: the two attentions differ in order only
LOGIT_BF16_TOL = 0.25     # bf16 model: the full path rounds probabilities
                          # to bf16 before PV, the kernel keeps f32


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
    if not all(launches.values()):
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
    from repro_torch.kernels import scatter_apply as sa
    t0 = time.monotonic()
    build.build_all()
    print(f"kernel build: {time.monotonic() - t0:.1f} s "
          f"(nvcc sm_90a, one process per source, in parallel)")
    for name, info in build.BUILD_INFO.items():
        (OUT / f"ptxas_{name}.txt").write_text(info["log"])
        want = {"decode_attention": "Li4ELi2E",   # hd 128, G 2
                "scatter_swap": "scatter_swap"}[name]
        rows, most = ptxas_summary(info["log"], want)
        print(f"  {name}: {info['seconds']:.1f} s, compiled="
              f"{info['compiled']}, max registers over all entries {most}")
        for entry, line in rows:
            short = entry[entry.find(f"{name}_kernel"):][:60]
            print(f"    {short}: {line.replace('ptxas info    : ', '')}")

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
    missing = [k for k, n in launches.items() if n == 0]
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

    # phase 6
    sources = {"decode_attention": "src/repro_torch/kernels/csrc/"
                                   "decode_attention.cu",
               "scatter_swap": "src/repro_torch/kernels/csrc/"
                               "scatter_swap.cu"}
    replaces = {"decode_attention": "src/repro/kernels/decode_attention.py:186",
                "scatter_swap": "src/repro/kernels/scatter_apply.py:81"}
    kernels = []
    for name in ("decode_attention", "scatter_swap"):
        r = results[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": sources[name], "replaces": replaces[name],
                        "launches": launches[name], **r})
        print(f"kernels: {name} launches {launches[name]} on the main path, "
              f"parity ok (max_abs_err {r['max_abs_err']:.3g}), "
              f"{r['ms']:.4f} ms vs bound {r['bound_ms']:.4f} ms")
    print(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
