#!/usr/bin/env python3
"""RG-LRU scan kernels of several source trees, side by side on one card.

    git archive <commit> | tar -x -C build/parent     # e.g. the parent
    python3 scripts/rglru_scan_ab.py --tree parent=build/parent

Builds ``csrc/rglru_scan.cu`` of this checkout ("this") and of each
checkout given as ``--tree LABEL=DIR`` with ``nvcc`` (the flags of
``kernels/build.py``, into ``build/ab/``, where nvcc's ``-Xptxas -v`` logs
stay) and prints their ptxas lines.  Then, at the main path's shape
[8, 256, 2560] f32 (``recurrentgemma-2b`` at batch 8 x 256), for each
tree in turns (this, the others, then the same backwards), times
- the forward kernel (a, b -> y, h_last);
- the backward of ``ops.rglru_scan`` as a whole: in a tree with
  ``rglru_scan_bwd_cuda``, that one kernel; in an older tree, the
  reversed scan and the four passes around it (the shifted copy of a,
  the copy of dy with dh_last added, the shifted copy of y, the product
  and dh0), as that tree's ``_RGLRUScan.backward`` runs them;
each the median of 5 runs of 50 back-to-back calls (CUDA events) on two
input copies (126 MB, more than L2), beside the bounds (12 and 20 bytes
an element at 3.35 TB/s), and checks every tree's outputs bitwise
against that tree's own plain version (an older tree's backward: its
plain reversed scan with the same passes).  Each tree runs through its
own wrapper module (``src/repro_torch/kernels/rglru_scan.py``) and
``build.py`` bindings.  Another chunk length is a tree too: a copy with
``kChunk`` of ``csrc/rglru_scan.cu`` and ``SCAN_CHUNK`` of the module
both set to it.
Needs one card; imports nothing of the JAX package.
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
SHAPE = (8, 256, 2560)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=DIR: the root of another checkout")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("rglru_scan_ab: no CUDA device", file=sys.stderr)
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
        src = root / "src" / "repro_torch" / "kernels" / "csrc" / \
            build.SOURCES["rglru_scan"]
        so = out / f"{tag}_rglru_scan.so"
        jobs.append((tag, so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    mods = {}
    for tag, so, proc in jobs:
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode:
            print(f"{tag}: nvcc failed\n{log[-8000:]}")
            return 1
        for entry, line in cs.ptxas_summary(log, "rglru")[0]:
            short = entry[entry.find("rglru"):][:40]
            print(f"  {tag} {short} | "
                  f"{line.replace('ptxas info    : ', '').strip()}")
        mods[tag] = {}
        for mod in ("rglru_scan", "build"):
            path = trees[tag] / "src" / "repro_torch" / "kernels"
            spec = importlib.util.spec_from_file_location(
                f"{mod}_{tag}", path / f"{mod}.py")
            mods[tag][mod] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[tag][mod])
        mods[tag]["lib"] = ctypes.CDLL(str(so))
        mods[tag]["build"]._bind("rglru_scan", mods[tag]["lib"])
    print(f"builds {time.monotonic() - t0:.1f} s", flush=True)
    rs_this = mods["this"]["rglru_scan"]

    def use(tag):
        build._LIBS["rglru_scan"] = mods[tag]["lib"]
        return mods[tag]["rglru_scan"]

    def backward(rs, a, y, h0, dy, dh_last, kernel=True):
        """The backward of ``ops.rglru_scan`` as the tree runs it, with
        its kernels or its plain versions."""
        fused = "rglru_scan_bwd_cuda" if kernel else "rglru_scan_bwd_plain"
        if hasattr(rs, fused):
            return getattr(rs, fused)(a, y, h0, dy, dh_last)
        fn = rs.rglru_scan_cuda if kernel else rs.rglru_scan_plain
        B, S, W = a.shape
        a_next = torch.cat([a[:, 1:], a.new_zeros(B, 1, W)], dim=1)
        dy = dy.clone(memory_format=torch.contiguous_format)
        dy[:, -1] += dh_last
        lam, _ = fn(a_next, dy, None, reverse=True)
        y_prev = torch.cat([h0[:, None], y[:, :-1]], dim=1)
        return lam * y_prev, lam, lam[:, 0] * a[:, 0]

    B, S, W = SHAPE
    ins = [cs.scan_inputs(torch, B, S, W, 2 + i) for i in range(2)]
    for a, b, h0 in ins:
        b.copy_(torch.randn_like(b))            # dy of the backward
    dh = torch.randn(B, W, device="cuda")
    elems = B * S * W
    fwd_bound = rs_this.scan_bytes(B, S, W) / cs.HBM_BYTES_PER_S * 1e3
    bwd_bound = rs_this.scan_bwd_bytes(B, S, W) / cs.HBM_BYTES_PER_S * 1e3
    print(f"[{B}, {S}, {W}] f32 ({elems} elements): bounds forward "
          f"{fwd_bound:.4f} ms (12 B an element), backward "
          f"{bwd_bound:.4f} ms (20 B an element)", flush=True)

    def turn(tag):
        rs = use(tag)
        a, b, h0 = ins[0]
        y, h = rs.rglru_scan_cuda(a, b, h0)
        grads = backward(rs, a, y, h0, b, dh)
        torch.cuda.synchronize()
        py, ph = rs.rglru_scan_plain(a, b, h0)
        ref = (py, ph) + tuple(backward(rs, a, py, h0, b, dh, kernel=False))
        same = all(cs.same_bits(torch, k, p)
                   for k, p in zip((y, h) + tuple(grads), ref))
        fwd = cs.median_time_ms(lambda i: rs.rglru_scan_cuda(*ins[i % 2]))
        ys = [rs.rglru_scan_cuda(*x)[0] for x in ins]
        bwd = cs.median_time_ms(lambda i: backward(
            rs, ins[i % 2][0], ys[i % 2], ins[i % 2][2], ins[i % 2][1], dh))
        print(f"[{tag}] forward {fwd:.4f} ms ({fwd_bound / fwd:.0%} of "
              f"bound), backward as a whole {bwd:.4f} ms "
              f"({bwd_bound / bwd:.0%} of bound); y, h_last, da, db, dh0 "
              f"bitwise the tree's plain version: {same}", flush=True)
        return same

    ok = True
    for tag in list(trees) + list(trees)[::-1]:
        ok &= turn(tag)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
