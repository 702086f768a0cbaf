"""Atomic checkpointing with auto-resume (counterpart of
``repro.checkpoint.checkpointer``), in the same on-disk format, so a
checkpoint or payload written by either package reads in the other:

    <dir>/step_00000123/
      manifest.json      ({"meta": ..., "leaves": [{name, key, dtype,
                          stored_as, shape}], "step": 123})
      arrays.npz         (one array per leaf, keys a0, a1, ...)
      DONE               (commit marker: written last => atomicity)

``_flatten_with_names`` is the leaf-path scheme that checkpoints,
adapter deltas and the interop layer key on (dict keys sorted, list
indices as ints, NamedTuple fields as ``.name``).  Writes go to
``<dir>.tmp`` and are committed by one rename after DONE, so a crash
never leaves a checkpoint that ``latest_step`` would pick up.  A
trainer's JSON host state rides in the manifest's ``meta``.

Arrays are torch tensors in memory.  Dtypes numpy lacks (bfloat16,
float8) are stored as their raw bits in a uintN array and the manifest
keeps the logical dtype name, exactly as the JAX package stores
ml_dtypes arrays.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

Pytree = Any

# torch dtype <-> the numpy dtype name the JAX package writes for it
_NAME_OF = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
    torch.float8_e4m3fn: "float8_e4m3fn", torch.float8_e5m2: "float8_e5m2",
}
_DTYPE_OF = {v: k for k, v in _NAME_OF.items()}
# dtypes numpy has natively; the rest travel as raw bits
_NUMPY_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16",
                 "int8", "uint8", "uint16", "uint32", "uint64", "bool"}


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``float32``, ``bfloat16``)."""
    return _NAME_OF[dtype]


class TreeDef:
    """Structure of a nested dict/list tree; rebuilds it from leaves."""

    def __init__(self, build: Callable[[List[Any]], Any], n: int):
        self._build = build
        self.num_leaves = n

    def unflatten(self, leaves) -> Pytree:
        leaves = list(leaves)
        assert len(leaves) == self.num_leaves, (len(leaves), self.num_leaves)
        return self._build(iter(leaves))


def _flatten(tree, path, names, leaves):
    """Depth-first flatten; returns a builder for the same structure."""
    if isinstance(tree, dict):
        keys = sorted(tree)           # JAX flattens dicts in sorted order
        subs = [_flatten(tree[k], path + (str(k),), names, leaves)
                for k in keys]
        return lambda it: {k: b(it) for k, b in zip(keys, subs)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        # a NamedTuple (AdamState): JAX names its fields ".count", ...
        subs = [_flatten(getattr(tree, f), path + (f".{f}",), names, leaves)
                for f in tree._fields]
        kind = type(tree)
        return lambda it: kind(*[b(it) for b in subs])
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(v, path + (str(i),), names, leaves)
                for i, v in enumerate(tree)]
        kind = type(tree)
        return lambda it: kind(b(it) for b in subs)
    if tree is None:                  # an empty subtree, as in JAX
        return lambda it: None
    names.append("/".join(path))
    leaves.append(tree)
    return lambda it: next(it)


def _flatten_with_names(tree) -> Tuple[List[str], List[Any], TreeDef]:
    """``("/"-joined leaf paths, leaves, treedef)``: dict keys sorted,
    list indices as ints — the names ``repro.checkpoint`` gives."""
    names: List[str] = []
    leaves: List[Any] = []
    build = _flatten(tree, (), names, leaves)
    return names, leaves, TreeDef(build, len(leaves))


def tree_map(fn, tree: Pytree) -> Pytree:
    _, leaves, td = _flatten_with_names(tree)
    return td.unflatten([fn(x) for x in leaves])


def to_numpy(t) -> Tuple[np.ndarray, str]:
    """Host numpy view of a tensor (or array) plus its logical dtype
    name.  Dtypes numpy lacks come back as their raw uintN bits."""
    if isinstance(t, np.ndarray):
        return t, str(t.dtype)
    t = t.detach().contiguous().cpu()
    name = dtype_name(t.dtype)
    if name in _NUMPY_NATIVE:
        return t.numpy(), name
    bits = {1: torch.uint8, 2: torch.int16}[t.element_size()]
    arr = t.view(bits).numpy()
    return arr.view(f"uint{8 * t.element_size()}"), name


def from_numpy(arr: np.ndarray, name: Optional[str] = None) -> torch.Tensor:
    """Tensor of logical dtype ``name`` (default: the array's own) from a
    host array, bit-exact; ``arr`` may hold raw uintN bits."""
    name = name or str(arr.dtype)
    arr = np.ascontiguousarray(arr).reshape(arr.shape)   # keeps 0-dim
    if name in _NUMPY_NATIVE:
        return torch.from_numpy(arr.copy())
    bits = {1: np.uint8, 2: np.int16}[arr.dtype.itemsize]
    return torch.from_numpy(arr.view(bits).copy()).view(_DTYPE_OF[name])


def write_payload(final: Path, named_arrays: Dict[str, Any], *,
                  meta: Optional[dict] = None,
                  extra: Optional[dict] = None) -> Path:
    """Atomic manifest+npz+DONE write of an ordered ``{name: tensor}`` map
    (``repro.checkpoint.checkpointer.write_payload``'s format)."""
    final = Path(final)
    tmp = final.parent / (final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = {}
    manifest = {"meta": meta or {}, "leaves": []}
    manifest.update(extra or {})
    for i, (name, leaf) in enumerate(named_arrays.items()):
        arr, dtype = to_numpy(leaf)
        key = f"a{i}"
        stored_as = str(arr.dtype)
        arrays[key] = arr
        manifest["leaves"].append(
            {"name": name, "key": key, "dtype": dtype,
             "stored_as": stored_as, "shape": list(arr.shape)})
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "DONE").write_text("ok")
    if final.exists():
        # two atomic renames: readers never see a torn payload
        old = final.parent / (final.name + ".old")
        if old.exists():
            shutil.rmtree(old)
        os.rename(final, old)
        os.rename(tmp, final)
        shutil.rmtree(old)
    else:
        os.rename(tmp, final)
    return final


def read_payload(path) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Inverse of ``write_payload``: ordered ``{name: CPU tensor}`` with
    bit-exact dtypes, plus the manifest dict."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as arrays:
        out = {}
        for e in manifest["leaves"]:
            out[e["name"]] = from_numpy(arrays[e["key"]], e["dtype"])
    return out, manifest


# --------------------------------------------------------------------- #
# step checkpoints
# --------------------------------------------------------------------- #


def save(ckpt_dir, step: int, tree: Pytree, *, meta: Optional[dict] = None,
         keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    names, leaves, _ = _flatten_with_names(tree)
    named = {}
    for name, leaf in zip(names, leaves):
        if name in named:
            raise ValueError(f"duplicate leaf path {name!r}")
        named[name] = leaf
    final = write_payload(ckpt_dir / f"step_{step:08d}", named, meta=meta,
                          extra={"step": step})
    _gc(ckpt_dir, keep)
    return final


def _committed_steps(ckpt_dir: Path):
    # only step_<digits> with DONE count: .tmp (staging) and .old
    # (mid-replace remnant) are never live checkpoints
    return [p for p in ckpt_dir.glob("step_*")
            if p.name.split("_", 1)[1].isdigit() and (p / "DONE").exists()]


def _gc(ckpt_dir: Path, keep: int):
    for p in sorted(_committed_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(p)


def read_meta(ckpt_dir, step: int) -> dict:
    """Manifest ``meta`` alone, without loading the arrays."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    return json.loads((path / "manifest.json").read_text()).get("meta", {})


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in _committed_steps(ckpt_dir)]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, like: Pytree):
    """Restore into the structure of ``like``: each leaf takes the dtype
    and device of its counterpart in ``like``.  Leaves are matched in
    flatten order, as the JAX package matches them."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    named, manifest = read_payload(path)
    _, flat_like, treedef = _flatten_with_names(like)
    entries = manifest["leaves"]
    if len(entries) != len(flat_like):
        raise ValueError(f"checkpoint has {len(entries)} leaves, expected "
                         f"{len(flat_like)}")
    out = []
    for e, proto in zip(entries, flat_like):
        arr = named[e["name"]]
        if list(arr.shape) != list(proto.shape):
            raise ValueError(f"{e['name']}: {tuple(arr.shape)} vs "
                             f"{tuple(proto.shape)}")
        out.append(arr.to(device=proto.device, dtype=proto.dtype))
    return treedef.unflatten(out), manifest["meta"]


def restore_latest(ckpt_dir, like: Pytree):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None, None
    tree, meta = restore(ckpt_dir, step, like)
    return step, tree, meta
