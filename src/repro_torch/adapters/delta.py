"""SparseDelta: a finetuned task as a row-sparse edit of the base model.

Counterpart of ``repro.adapters.delta``.  A finetune is stored as
``{leaf path -> (row indices, replacement rows)}``; ``apply_delta`` swaps
the rows in on the device (the row scatter-swap kernel on the card) and
hands back the displaced base rows, so revert is the same swap run again
— bit-exact by construction (replacement semantics, not additive
deltas).

Host-side payloads are CPU tensors (the JAX package uses numpy); the
on-disk format, the payload checksum and the base fingerprint are
byte-compatible with the JAX package, so a delta extracted by either
package applies in the other.  ``quantize_delta`` stores float rows
as int8 codec blocks + f32 block scales (``runtime/compression.py``):
the codes, the scales and the dequantized rows are bitwise the JAX
package's, and revert of an applied quantized delta stays bit-exact.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer as ckpt_lib
from repro_torch.kernels import ops
from repro_torch.runtime.compression import dequantize_int8, quantize_int8

Pytree = Any


class AdapterCorruptError(RuntimeError):
    """A stored delta failed its payload checksum: the bytes on disk do
    not match what ``save_delta`` wrote (torn write, bit rot, tamper)."""


def _as_tensor(a):
    return ckpt_lib.from_numpy(a) if isinstance(a, np.ndarray) else a


def _payload_checksum(named: Dict[str, Any]) -> str:
    """SHA-256 over the delta's array payloads, order-independent: each
    array hashed as (key, numpy dtype name, shape, bytes) in sorted-key
    order — the same digest the JAX package computes."""
    h = hashlib.sha256()
    for key in sorted(named):
        arr, dtype = ckpt_lib.to_numpy(named[key])
        h.update(key.encode())
        h.update(dtype.encode())
        h.update(repr(tuple(arr.shape)).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


@dataclass
class DeltaEntry:
    """One leaf's edit: ``rows`` [K, ...] replacing rows ``idx`` of the
    base leaf [G, ...].  ``idx is None`` => whole-leaf replacement.

    ``idx`` is a host int32 tensor; ``rows`` is a CPU tensor when loaded
    or extracted, and a device tensor in the displaced-rows delta
    ``apply_delta`` returns (revert never round-trips through the host).
    Numpy arrays given for ``idx``/``rows``/``scale`` become tensors.

    **Quantized payloads** (``scale is not None``): ``rows`` holds int8
    codec blocks ``[NB, 256]`` with f32 block scales ``scale`` [NB], and
    ``row_shape`` / ``row_dtype`` (a numpy dtype name, shared with the
    JAX package) record the original rows, so ``apply_delta``
    dequantizes transparently."""
    idx: Optional[torch.Tensor]
    rows: Any
    scale: Any = None
    row_shape: Optional[tuple] = None
    row_dtype: Optional[str] = None

    def __post_init__(self):
        self.idx = _as_tensor(self.idx)
        self.rows = _as_tensor(self.rows)
        self.scale = _as_tensor(self.scale)

    @property
    def quantized(self) -> bool:
        return self.scale is not None

    @property
    def nbytes(self) -> int:
        return (self.rows.nbytes
                + (self.scale.nbytes if self.scale is not None else 0)
                + (self.idx.nbytes if self.idx is not None else 0))

    def materialize_rows(self, device=None) -> torch.Tensor:
        """The rows on ``device`` (default: where they lie) in their
        original shape and dtype: dequantized there for a quantized
        entry (one f32 multiply, then one cast: bitwise the JAX
        package's on every device); the rows themselves otherwise."""
        if self.scale is None:
            return self.rows if device is None else self.rows.to(device)
        return dequantize_int8(self.rows.to(device), self.scale.to(device),
                               tuple(self.row_shape),
                               ckpt_lib.dtype_of(self.row_dtype))


@dataclass
class SparseDelta:
    entries: Dict[str, DeltaEntry]           # leaf path -> edit
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self.entries.values())

    def num_rows(self) -> int:
        return sum(e.row_shape[0] if e.quantized else e.rows.shape[0]
                   for e in self.entries.values())

    @property
    def quantized(self) -> bool:
        return any(e.quantized for e in self.entries.values())


def copy_tree(tree: Pytree) -> Pytree:
    """Clone every leaf: a tree that will be swapped in place must not
    alias tensors the caller still reads."""
    return ckpt_lib.tree_map(lambda a: a.clone(), tree)


def fingerprint(params: Pytree) -> str:
    """Structural fingerprint (leaf paths, shapes, numpy dtype names) —
    equal to the JAX package's for the same tree."""
    names, leaves, _ = ckpt_lib._flatten_with_names(params)
    h = hashlib.sha256()
    for name, leaf in zip(names, leaves):
        dt = (ckpt_lib.dtype_name(leaf.dtype)
              if isinstance(leaf, torch.Tensor) else str(leaf.dtype))
        h.update(f"{name}:{tuple(leaf.shape)}:{dt}\n".encode())
    return h.hexdigest()[:16]


def extract_delta(base: Pytree, tuned: Pytree, *,
                  meta: Optional[dict] = None) -> SparseDelta:
    """Diff two same-structure trees into a SparseDelta: every row that
    differs in any element is captured (compared where the tensors lie;
    the rows come back to the host)."""
    names_b, leaves_b, _ = ckpt_lib._flatten_with_names(base)
    names_t, leaves_t, _ = ckpt_lib._flatten_with_names(tuned)
    if names_b != names_t:
        raise ValueError("base/tuned param trees differ in structure")
    entries: Dict[str, DeltaEntry] = {}
    for name, b, t in zip(names_b, leaves_b, leaves_t):
        if b.shape != t.shape or b.dtype != t.dtype:
            raise ValueError(f"{name}: {b.shape}/{b.dtype} vs "
                             f"{t.shape}/{t.dtype}")
        if torch.equal(b, t):
            continue
        bv = b.reshape(b.shape[0] if b.dim() > 1 else 1, -1)
        tv = t.reshape(bv.shape)
        changed = torch.nonzero((bv != tv).any(dim=1)).flatten().cpu()
        if b.dim() <= 1 or len(changed) == bv.shape[0]:
            entries[name] = DeltaEntry(idx=None, rows=t.detach().cpu().clone())
        else:
            entries[name] = DeltaEntry(
                idx=changed.to(torch.int32),
                rows=t[changed.to(t.device)].cpu().contiguous())
    md = dict(meta or {})
    md.setdefault("base_fingerprint", fingerprint(base))
    return SparseDelta(entries, md)


def apply_delta(params: Pytree, delta: SparseDelta, *, mode: str = "auto",
                donate: bool = False, check_fingerprint: bool = True
                ) -> Tuple[Pytree, SparseDelta]:
    """Swap the delta rows into ``params``.

    Returns ``(new_params, displaced)``; applying ``displaced`` to
    ``new_params`` restores ``params`` bit-exactly.  ``mode`` routes the
    per-leaf swap (``kernels.ops.scatter_swap``: ``auto`` | ``kernel`` |
    ``plain``).  ``donate=True`` edits the leaves of ``params`` in place
    (O(delta) bytes moved; the caller treats ``params`` as dead); the
    default leaves ``params`` intact.
    """
    fp = delta.meta.get("base_fingerprint")
    if check_fingerprint and fp is not None and fp != fingerprint(params):
        raise ValueError(
            "delta base_fingerprint does not match target params "
            "(adapter extracted against a different architecture?)")
    names, leaves, treedef = ckpt_lib._flatten_with_names(params)
    by_name = dict(zip(names, range(len(names))))
    out = list(leaves)
    displaced: Dict[str, DeltaEntry] = {}
    for name, e in delta.entries.items():
        if name not in by_name:
            raise KeyError(f"delta leaf {name!r} not present in params")
        i = by_name[name]
        leaf = out[i]
        # quantized entries dequantize on the leaf's device; the displaced
        # side is always the exact resident values, so revert stays
        # bit-exact
        rows = e.materialize_rows(leaf.device)
        if e.idx is None:
            # whole-leaf swap: the old leaf itself is the displaced
            # payload, and the new leaf is a copy the caller owns: the
            # rows may be a cached tensor that other trees (a fleet's
            # other replicas) also apply, and a later in-place swap on
            # this leaf must not reach them
            displaced[name] = DeltaEntry(idx=None, rows=leaf)
            out[i] = rows.reshape(leaf.shape).to(dtype=leaf.dtype,
                                                 copy=True)
        else:
            out[i], disp = ops.scatter_swap(leaf, e.idx, rows, mode=mode,
                                            donate=donate)
            # displaced rows stay on the device: revert re-swaps them
            # without a host round trip
            displaced[name] = DeltaEntry(idx=e.idx, rows=disp)
    disp_meta = dict(delta.meta)
    disp_meta["displaced_by"] = delta.meta.get("adapter_id", "<anon>")
    return treedef.unflatten(out), SparseDelta(displaced, disp_meta)


def revert_delta(params: Pytree, displaced: SparseDelta, *,
                 mode: str = "auto", donate: bool = False) -> Pytree:
    """Undo an ``apply_delta`` using its displaced-rows return value."""
    out, _ = apply_delta(params, displaced, mode=mode, donate=donate,
                         check_fingerprint=False)
    return out


def flip_delta(params: Pytree, other_side: SparseDelta, *, mode: str = "auto"
               ) -> Tuple[Pytree, SparseDelta]:
    """One half of a base <-> adapter flip on weights the caller owns: an
    in-place ``apply_delta`` with no fingerprint check, through the row
    scatter-swap.  Returns ``(flipped_params, other_side')``; applying
    ``other_side'`` flips back bit-exactly.  Self-speculative serving
    flips twice per round (draft under the base, verify under the
    adapter), moving O(delta rows) bytes each time."""
    return apply_delta(params, other_side, mode=mode, donate=True,
                       check_fingerprint=False)


def quantize_delta(delta: SparseDelta) -> SparseDelta:
    """Int8 block-quantize a delta's float row payloads (opt-in at
    export), with the JAX package's rules: integer rows and entries
    already quantized pass through; an entry whose quantized form is not
    smaller (256-element blocks pad tiny rows) stays unquantized; and
    ``meta["quantized"]`` is set only if something was quantized."""
    entries: Dict[str, DeltaEntry] = {}
    for name, e in delta.entries.items():
        if e.quantized or not e.rows.dtype.is_floating_point:
            entries[name] = e
            continue
        rows = e.rows.detach().cpu()
        q, s = quantize_int8(rows.float())
        qe = DeltaEntry(idx=e.idx, rows=q, scale=s,
                        row_shape=tuple(rows.shape),
                        row_dtype=ckpt_lib.dtype_name(rows.dtype))
        entries[name] = qe if qe.nbytes < e.nbytes else e
    meta = dict(delta.meta)
    meta["quantized"] = any(e.quantized for e in entries.values())
    return SparseDelta(entries, meta)


# ---------------------------------------------------------------------- #
# serialization (the checkpointer's atomic payload format)
# ---------------------------------------------------------------------- #


def save_delta(path, delta: SparseDelta):
    """Atomically write a delta directory (manifest+npz+DONE)."""
    named = {}
    qmeta = {}
    for name, e in delta.entries.items():
        if e.idx is not None:
            named[f"{name}::idx"] = e.idx
        named[f"{name}::rows"] = e.rows
        if e.quantized:
            named[f"{name}::scale"] = e.scale
            qmeta[name] = {"shape": list(e.row_shape),
                           "dtype": str(e.row_dtype)}
    meta = dict(delta.meta)
    meta["format"] = "blockdelta.v1"
    if qmeta:
        meta["qmeta"] = qmeta
    meta["payload_sha256"] = _payload_checksum(named)
    return ckpt_lib.write_payload(path, named, meta=meta)


def load_delta(path, *, verify_checksum: bool = True) -> SparseDelta:
    named, manifest = ckpt_lib.read_payload(path)
    meta = manifest.get("meta", {})
    if meta.get("format") != "blockdelta.v1":
        raise ValueError(f"{path}: not a BlockDelta payload")
    expect = meta.get("payload_sha256")
    if verify_checksum and expect is not None:   # pre-seal payloads pass
        got = _payload_checksum(named)
        if got != expect:
            raise AdapterCorruptError(
                f"{path}: payload checksum mismatch (stored "
                f"{expect[:16]}…, recomputed {got[:16]}…) — the delta "
                f"bytes changed since save_delta sealed them")
    qmeta = meta.get("qmeta", {})
    entries: Dict[str, DeltaEntry] = {}
    for key, arr in named.items():
        name, kind = key.rsplit("::", 1)
        if kind != "rows":
            continue
        qm = qmeta.get(name)
        entries[name] = DeltaEntry(
            idx=named.get(f"{name}::idx"), rows=arr,
            scale=named.get(f"{name}::scale"),
            row_shape=tuple(qm["shape"]) if qm else None,
            row_dtype=qm["dtype"] if qm else None)
    return SparseDelta(entries, meta)


def delta_from_trainer(trainer, base: Pytree, *,
                       meta: Optional[dict] = None) -> SparseDelta:
    """Diff a trainer's merged params against the pre-finetune base."""
    tuned = (trainer.merged_params() if hasattr(trainer, "merged_params")
             else trainer.params)
    return extract_delta(base, tuned, meta=meta)
