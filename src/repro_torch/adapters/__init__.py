"""BlockDelta adapters: row-sparse deltas hot-swapped over one resident
base model (counterpart of ``repro.adapters``; same on-disk format)."""
from repro_torch.adapters.delta import (AdapterCorruptError, DeltaEntry,
                                        SparseDelta, apply_delta, copy_tree,
                                        delta_from_trainer, extract_delta,
                                        fingerprint, load_delta, revert_delta,
                                        save_delta)
from repro_torch.adapters.registry import (AdapterReadError, AdapterRegistry,
                                           InMemoryRegistry, read_with_retry)

__all__ = [
    "AdapterCorruptError", "AdapterReadError", "DeltaEntry", "SparseDelta",
    "apply_delta", "copy_tree", "delta_from_trainer", "extract_delta",
    "fingerprint", "load_delta", "revert_delta", "save_delta",
    "AdapterRegistry",
    "InMemoryRegistry", "read_with_retry",
]
