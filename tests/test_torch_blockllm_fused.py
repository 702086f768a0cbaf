"""BlockLLM training trajectories through the fused masked-Adam step:
the port's plain kernels (``fused_update="plain"``) against JAX's Pallas
kernels in interpret mode (``fused_update="interpret"``), in f32 moments
and in Q8 moments (``quantize_state=True``).  The same run and
tolerances as ``tests/test_torch_blockllm.py`` (whose docstring says
why each is what it is), split off so the JAX-heavy runs land on
another test worker."""
import importlib.util
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "_torch_blockllm_cases", Path(__file__).with_name("test_torch_blockllm.py"))
_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cases)


@pytest.mark.parametrize("mode", ["plain", "q8"])
def test_trajectory_fused_matches_jax(mode):
    jh, th = _cases.run_trajectory(mode)
    assert th.core.bcfg.fused_update == "plain"
    assert th.core.quantize_state == (mode == "q8")
