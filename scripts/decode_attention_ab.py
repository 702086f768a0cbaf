#!/usr/bin/env python3
"""Decode-attention kernels of several source trees, side by side on one card.

    git archive <commit> | tar -x -C build/other     # e.g. the parent
    python3 scripts/decode_attention_ab.py --tree other=build/other

Builds the dense and paged decode-attention libraries of this checkout
("this") and of each checkout given as ``--tree LABEL=DIR`` with ``nvcc``
(the flags of ``kernels/build.py``, into ``build/ab/``, where nvcc's
``-Xptxas -v`` logs stay), prints their ptxas lines for the main path's
instantiations (bf16, hd 128, G 2), then, at the main path's shapes of
``internlm2-1.8b`` (B 8, KV 8, G 2, hd 128, bf16; dense C 2048 at
chip_smoke.py's ``pos_main``, C 1024 at serving contexts, C 2048 with
every pos 0 and with every pos 2047; ``recurrentgemma-2b``'s local
layers, G 10 at hd 256 over a 2048-row ring; paged ps 16, NP 64,
contexts 200-900), for each tree in turns (this, the others, then the same
backwards): the output bitwise against the tree's own first turn and its
largest difference from this tree's, the device time per call (20 calls
replayed from a CUDA graph) and the ``torch.profiler`` device time of
each kernel a call launches.  Each tree runs through its own wrapper
module and bindings (``src/repro_torch/kernels/decode_attention.py``,
``build.py``).  Needs one card; imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LIBS = ("decode_attention", "paged_decode_attention")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=DIR: the root of another checkout")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("decode_attention_ab: no CUDA device", file=sys.stderr)
        return 2
    print(cs.smi(), flush=True)
    trees = {"this": ROOT}
    for t in args.tree:
        label, path = t.split("=", 1)
        trees[label] = Path(path).resolve()
    out = ROOT / "build" / "ab"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    jobs = []
    for tag, root in trees.items():
        csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
        for lib in LIBS:
            so = out / f"{tag}_{lib}.so"
            jobs.append((tag, lib, so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                 str(csrc / build.SOURCES[lib])], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    mods = {}
    for tag, lib, so, proc in jobs:
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode:
            print(f"{tag} {lib}: nvcc failed\n{log[-8000:]}")
            return 1
        for want in ("ILi128ELi2E", "Li4ELi2E", "merge"):
            for entry, line in cs.ptxas_summary(log, want)[0]:
                print(f"  {tag} {lib} {entry[:80]} | {line}")
        if tag not in mods:
            mods[tag] = {}
            for mod in ("decode_attention", "build"):
                path = trees[tag] / "src" / "repro_torch" / "kernels"
                spec = importlib.util.spec_from_file_location(
                    f"{mod}_{tag}", path / f"{mod}.py")
                mods[tag][f"{mod}.py"] = importlib.util.module_from_spec(
                    spec)
                spec.loader.exec_module(mods[tag][f"{mod}.py"])
        mods[tag][lib] = ctypes.CDLL(str(so))
        mods[tag]["build.py"]._bind(lib, mods[tag][lib])
    print(f"builds {time.monotonic() - t0:.1f} s", flush=True)

    def use(tag):
        for lib in LIBS:
            build._LIBS[lib] = mods[tag][lib]
        return mods[tag]["decode_attention.py"]

    def prof_us(fn, n=20):
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
        return ", ".join(
            f"{e.key.split('(')[0].split('::')[-1][:32]} x{e.count // n} "
            f"{e.device_time_total / e.count:.2f} us"
            for e in prof.key_averages() if e.device_time_total > 0)

    g = torch.Generator("cuda").manual_seed(0)
    B, KV, hd, copies = 8, 8, 128, 8      # 8 copies of the cache > L2
    cases = {}
    for C, pos in ((2048, [0, 127, 128, 1000, 2047, 513, 1536, 64]),
                   (1024, [351, 420, 500, 610, 700, 760, 800, 821]),
                   (2048, [0] * B), (2048, [2047] * B)):
        def rn(*s):
            return torch.randn(*s, generator=g, device="cuda").bfloat16()
        cases[f"dense C{C} pos {pos}"] = (
            "dense", rn(B, 1, KV * 2, hd),
            [rn(B, C, KV, hd) for _ in range(copies)],
            [rn(B, C, KV, hd) for _ in range(copies)],
            torch.tensor(pos, dtype=torch.int32, device="cuda"), {})
    # recurrentgemma-2b's local layers: MQA, 10 heads, hd 256, a ring over
    # the 2048-token window, every slot past the wrap (the G = 10 kernel)
    pos = [2100, 2500, 3000, 3500, 4000, 5000, 6000, 9000]
    cases[f"dense G10 hd256 ring 2048 pos {pos}"] = (
        "dense", rn(B, 1, 10, 256),
        [rn(B, 2048, 1, 256) for _ in range(copies)],
        [rn(B, 2048, 1, 256) for _ in range(copies)],
        torch.tensor(pos, dtype=torch.int32, device="cuda"),
        dict(window=2048, ring=True))
    ctx = [int(c) for c in np.random.default_rng(4).integers(200, 901, B)]
    x = cs.paged_state(torch, np, G=2, hd=hd, qd=torch.bfloat16,
                       pd=torch.bfloat16, pos=ctx, act=[True] * B,
                       shared=(), seed=20)
    x["nk"], x["nv"] = x["nk"].bfloat16(), x["nv"].bfloat16()
    cases[f"paged ps16 NP64 contexts {ctx}"] = (
        "paged", x, [x["kp"]] + [x["kp"].clone() for _ in range(copies - 1)],
        [x["vp"]] + [x["vp"].clone() for _ in range(copies - 1)], None, {})
    first = {}
    for tag in list(trees) + list(trees)[::-1]:
        da = use(tag)
        for name, (kind, a, ks, vs, pos, kw) in cases.items():
            if kind == "dense":
                def fn(i, a=a, ks=ks, vs=vs, pos=pos, kw=kw):
                    return da.decode_attention_cuda(a, ks[i % copies],
                                                    vs[i % copies], pos, **kw)
            else:
                def fn(i, a=a, ks=ks, vs=vs):
                    return da.paged_decode_attention_cuda(
                        a["q"], a["nk"], a["nv"], ks[i % copies],
                        vs[i % copies], a["pos"], a["tbl"], a["act"])[0]
            o = fn(0).float()
            torch.cuda.synchronize()
            own = first.setdefault((tag, name), o)
            base = first.setdefault(("this", name), o)
            ms = cs.graph_time_ms(fn)
            print(f"[{tag}] {name}: graph replay {ms * 1e3:.2f} us/call; "
                  f"profile {prof_us(fn)}; bitwise its first turn "
                  f"{torch.equal(o, own)}, max|o - this| "
                  f"{(o - base).abs().max().item():.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
