"""BlockDelta adapters: row-sparse deltas hot-swapped over one resident
base model (counterpart of ``repro.adapters``; same on-disk format)."""
from repro_torch.adapters.delta import (AdapterCorruptError, DeltaEntry,
                                        SparseDelta, apply_delta, copy_tree,
                                        delta_from_trainer, extract_delta,
                                        fingerprint, flip_delta, load_delta,
                                        quantize_delta, revert_delta,
                                        save_delta)
from repro_torch.adapters.device_cache import AdapterCache
from repro_torch.adapters.registry import (AdapterReadError, AdapterRegistry,
                                           InMemoryRegistry, read_with_retry)

__all__ = [
    "AdapterCache", "AdapterCorruptError", "AdapterReadError", "DeltaEntry",
    "SparseDelta",
    "apply_delta", "copy_tree", "delta_from_trainer", "extract_delta",
    "fingerprint", "flip_delta", "load_delta", "quantize_delta",
    "revert_delta", "save_delta",
    "AdapterRegistry",
    "InMemoryRegistry", "read_with_retry",
]
