"""The multi-rank harness that ``distributed_ranks.py`` and
``serving_ranks.py`` share: their common arguments, the launcher (one
process per rank, meeting through a ``file://`` rendezvous in a
temporary directory, under one deadline) and each rank's start (the
process group, its device, one kernel built before anything is timed,
rank 0 printing the card's name and power limit).  Imports nothing of
the JAX package.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def parser() -> argparse.ArgumentParser:
    """``--device`` (NCCL on the cards, one card a rank; gloo on the
    CPU), ``--rdv`` (the rendezvous file, set by ``launch``) and
    ``--timeout`` (seconds for every rank to end)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rdv", default="")
    ap.add_argument("--timeout", type=float, default=600.0)
    return ap


def is_rank() -> bool:
    """Whether this process is a rank ``launch`` started."""
    return os.environ.get("RANK") is not None


def launch(script: str, n: int, argv, timeout: float) -> int:
    """Run ``script`` with ``argv`` as ``n`` rank processes (``RANK``,
    ``WORLD_SIZE`` and ``--rdv`` set), kill whatever is left at the
    deadline, and return 0 only if every rank exited 0."""
    name = Path(script).stem
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        cmd = [sys.executable, str(Path(script).resolve()), *argv,
               "--rdv", os.path.join(tmp, "store")]
        procs = [subprocess.Popen(cmd, env=dict(os.environ, RANK=str(r),
                                                WORLD_SIZE=str(n)))
                 for r in range(n)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            print(f"{name}: time limit", file=sys.stderr)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    rcs = [p.returncode for p in procs]
    print(f"{name}: {n} ranks, exit codes {rcs}")
    return 0 if all(rc == 0 for rc in rcs) else 1


def start_rank(args, kernel: str):
    """Join the process group as ``RANK`` of ``WORLD_SIZE``; on the cards
    take card ``RANK`` mod the count, build ``kernel`` and print (rank 0)
    the card's name and power limit.  Returns ``(rank, world, device)``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(mesh_lib.BACKENDS[args.device],
                            init_method=f"file://{args.rdv}", rank=rank,
                            world_size=world)
    dev = (torch.device("cuda", rank % torch.cuda.device_count())
           if args.device == "cuda" else torch.device("cpu"))
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.library(kernel)                 # not inside the timed steps
        if rank == 0:
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip(), flush=True)
    return rank, world, dev
