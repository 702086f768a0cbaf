"""Functional trainer protocol + registry (counterpart of
``repro.trainers``).

    from repro_torch import trainers
    core = trainers.make("blockllm", cfg, sparsity=0.95)   # device: cuda
    state = core.init(torch.Generator("cuda").manual_seed(0))
    state, metrics = core.step(state, batch)

or, for imperative callers:

    tr = trainers.handle("blockllm", cfg, params, device="cpu")
    tr.train_step(batch); tr.memory_report(); tr.params

Registered, as in the JAX package: ``blockllm``, ``blockllm+q8``,
``adam``, ``adam+q8``, and the paper's baselines ``galore``, ``lora``,
``badam`` and ``badam+q8``.  Every factory takes ``device`` (default:
the CUDA device; raises without a card unless the caller asks for the
CPU).
"""
from repro_torch.trainers.api import (StateSpec, TrainerCore, TrainerHandle,
                                      TrainState, check_state, jsonable,
                                      nbytes)
from repro_torch.trainers.registry import get, make, names, register


def handle(name: str, cfg, params=None, *, seed: int = 0, device=None,
           **hyperparams) -> TrainerHandle:
    """Build the named core, init one state, wrap both in a handle.
    Without ``params`` the weights are drawn from a generator seeded with
    ``seed`` on the core's device."""
    import torch
    core = make(name, cfg, device=device, **hyperparams)
    gen = torch.Generator(core.device).manual_seed(seed)
    return TrainerHandle(core, core.init(gen, params))


# importing the implementation modules populates the registry
from repro_torch.trainers import badam as _badam          # noqa: F401,E402
from repro_torch.trainers import blockllm as _blockllm    # noqa: F401,E402
from repro_torch.trainers import full_adam as _full_adam  # noqa: F401,E402
from repro_torch.trainers import galore as _galore        # noqa: F401,E402
from repro_torch.trainers import lora as _lora            # noqa: F401,E402

__all__ = [
    "StateSpec", "TrainerCore", "TrainerHandle", "TrainState",
    "check_state", "get", "handle", "jsonable", "make", "names",
    "nbytes", "register",
]
