"""Runtime: ServeConfig and the slot-batched DecodeServer, the serving
fleet (Router, replicas, failover and fault injection), the training
loop, the straggler monitor and the int8 block codec.

The names below are imported on first use: the adapters import the
codec from this package, and the serving modules import the adapters.
"""
import importlib

_EXPORTS = {
    "ServeConfig": "serve_config", "SchedConfig": "serve_config",
    "KVConfig": "serve_config", "SpecConfig": "serve_config",
    "FleetConfig": "serve_config",
    "DecodeServer": "serve_loop", "Request": "serve_loop",
    "ConsistentHashRing": "fleet", "FleetAdapterDirectory": "fleet",
    "Replica": "fleet", "Router": "fleet",
    "FaultPlan": "elastic", "ReplicaFailure": "elastic",
    "ReplicaHealth": "elastic", "ReplicaKilled": "elastic",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(mod, name)
