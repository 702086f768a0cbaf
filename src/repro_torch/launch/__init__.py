"""Command-line entry points of the port: ``python -m
repro_torch.launch.serve`` (one DecodeServer), ``.fleet`` (replicas
behind the Router) and ``.train``."""
import importlib

__all__ = ["fleet", "serve", "train"]


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return importlib.import_module(f"{__name__}.{name}")
