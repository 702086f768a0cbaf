"""Lazy build of the CUDA kernels, their ``ctypes`` bindings, and the
per-kernel launch counters.

Each ``csrc/*.cu`` file has a plain C interface.  At the first kernel
use in a process every source is compiled at once (one ``nvcc`` per
source, all started together) for ``sm_90a`` into a shared library under
the build directory, which ``.gitignore`` lists; a library whose source
hash matches is reused.  Nothing here runs at import: the CPU tests
import every module of the port, and there is no ``nvcc`` there.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: each
wrapper adds one where it launches its kernel and nowhere else.
``builds()`` counts library loads in this process (1 after the first
kernel use, never more): ``DecodeServer`` reports it as
``sched/compiles``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"decode_attention": "decode_attention.cu",
           "paged_decode_attention": "paged_decode_attention.cu",
           "scatter_swap": "scatter_swap.cu",
           "masked_adam": "masked_adam.cu",
           "rglru_scan": "rglru_scan.cu",
           "flash_attention": "flash_attention.cu"}
# -split-compile=0: cicc and ptxas optimise the kernels of one source on
# every core, which halves the build of the two decode-attention sources
# (each holds dozens of instantiations)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0", "-Xptxas", "--split-compile=0"]

# one counter per kernel; masked_adam.cu holds two, and rglru_scan.cu its
# forward and its backward (reversed) kernel
KERNELS = ("decode_attention", "paged_decode_attention", "scatter_swap",
           "masked_adam", "masked_adam_q8", "rglru_scan", "rglru_scan_bwd",
           "flash_attention")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# per kernel: seconds, whether nvcc ran, and nvcc's output (-Xptxas -v)
BUILD_INFO: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILDS = 0


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def builds() -> int:
    return _BUILDS


def build_dir() -> Path:
    """``<checkout>/build/repro_torch`` (listed in ``.gitignore``)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


def _bind(name: str, lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    n = ctypes.c_longlong
    if name == "decode_attention":
        fns = [(lib.decode_attention_launch,
                [p] * 7 + [i] * 9 + [f, f, i, p])]
    elif name == "paged_decode_attention":
        fns = [(lib.paged_decode_attention_launch,
                [p] * 11 + [i] * 9 + [f, f, i, p])]
    elif name == "scatter_swap":
        fns = [(lib.scatter_swap_launch, [p, p, p, p, i, n, p])]
    elif name == "rglru_scan":
        fns = [(lib.rglru_scan_launch, [p] * 5 + [i] * 4 + [p]),
               (lib.rglru_scan_bwd_launch, [p] * 8 + [i] * 4 + [p])]
    elif name == "flash_attention":
        fns = [(lib.flash_attention_launch, [p] * 4 + [i] * 9 + [f, p])]
    else:
        fns = [(lib.masked_adam_launch, [p] * 5 + [n, i, i] + [f] * 8
                + [i, p]),
               (lib.masked_adam_q8_launch, [p] * 7 + [n, i, i] + [f] * 8
                + [i, p])]
    for fn, argtypes in fns:
        fn.argtypes = argtypes
        fn.restype = i
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [i]
    err.restype = ctypes.c_char_p


def build_all() -> None:
    """Compile every kernel source in parallel (skipping up-to-date
    libraries) and load them.  Raises if any build fails."""
    global _BUILDS
    if len(_LIBS) == len(SOURCES):
        return
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.monotonic()
    # every source includes whichever shared headers it needs: a header
    # change rebuilds them all
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    for name, src in SOURCES.items():
        path = CSRC / src
        digest = hashlib.sha256(path.read_bytes() + headers
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = out_dir / f"{name}-{digest[:16]}.so"
        if so.exists():
            jobs[name] = (so, None, None)
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (so, tmp, proc)
    failed = []
    for name, (so, tmp, proc) in jobs.items():
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                continue
            os.replace(tmp, so)
        BUILD_INFO[name] = {"seconds": time.monotonic() - t0,
                            "compiled": proc is not None, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for name, (so, _, _) in jobs.items():
        lib = ctypes.CDLL(str(so))
        _bind(name, lib)
        _LIBS[name] = lib
    _BUILDS += 1


def library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def check(name: str, rc: int) -> None:
    """Raise on a non-zero return code of a kernel's launch function."""
    if rc == 0:
        return
    if rc == -1:
        raise ValueError(f"{name}: arguments the kernel does not take")
    msg: Optional[bytes] = getattr(library(name),
                                   f"{name}_error_string")(rc)
    raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                       f"({msg.decode() if msg else '?'})")
