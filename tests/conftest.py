import os

# Tests intentionally see the single real CPU device (the 512-device flag
# belongs ONLY to launch/dryrun.py).  Subprocess tests that need multiple
# devices set XLA_FLAGS themselves.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import pytest

from repro.configs.base import ModelConfig


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running tier-1 test; CI runs these in a separate "
        "matrix leg (-m slow) so the fast leg stays under its timeout")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's kernels run on the card "
        "only); skips without one")


@pytest.fixture(scope="session")
def tiny_cfg():
    return ModelConfig(name="tiny", family="dense", num_layers=4,
                       d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                       vocab_size=128, remat=False)


@pytest.fixture(scope="session")
def tiny_params(tiny_cfg):
    from repro.models import model
    return model.init_params(jax.random.PRNGKey(0), tiny_cfg)


@pytest.fixture()
def tiny_batch(tiny_cfg):
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                              tiny_cfg.vocab_size)
    return {"tokens": toks}
