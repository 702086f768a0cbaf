"""Name -> TrainerCore factory registry (counterpart of
``repro.trainers.registry``).  A factory takes ``(cfg, **hyperparams)``
and returns a ``TrainerCore``; factories accept (and ignore) the union of
launcher hyperparameters."""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.trainers.api import TrainerCore

_REGISTRY: Dict[str, Callable[..., TrainerCore]] = {}


def register(name: str):
    """Decorator: ``@register("adam")`` over a factory ``(cfg, **kw)``."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def get(name: str) -> Callable[..., TrainerCore]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown trainer {name!r}; registered: {names()}") \
            from None


def names() -> List[str]:
    return sorted(_REGISTRY)


def make(name: str, cfg, **kw) -> TrainerCore:
    return get(name)(cfg, **kw)
