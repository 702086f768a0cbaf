"""BAdam baseline (Luo et al., 2024, arXiv:2404.02827): block-coordinate
Adam, a cyclic configuration of BlockLLM's block machinery (counterpart
of ``repro.baselines.badam``)."""
from __future__ import annotations

from repro_torch.trainers.badam import badam_config  # noqa: F401 — re-export
