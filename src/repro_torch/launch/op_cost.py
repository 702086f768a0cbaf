"""Per-rank cost of one step, counted from the ops it dispatches
(counterpart of ``repro.launch.hlo_cost``).

JAX's counter re-derives its totals from the post-SPMD HLO text,
weighting each ``while`` body by its trip count.  The port has no HLO,
and its layer and attention loops are Python loops that run eagerly, so
every iteration dispatches its own ops: ``OpCounter`` is a
``TorchDispatchMode`` that sees each aten op of the step as it runs (on
meta tensors in the dry run, on real ones elsewhere) and totals, for
this rank:

- matmul FLOPs: ``torch.utils.flop_counter``'s formulas (mm, addmm,
  bmm, baddbmm, convolutions, fused attention): 2 * prod(out) *
  contracted dim for a product; elementwise FLOPs are ignored, as
  JAX's are;
- HBM bytes: the operands and outputs of every dispatched aten op that
  is not a view (each tensor operand's and output's bytes, once per op;
  allocations that write nothing, ``empty``, count none).  These are
  eager ops, unfused: every intermediate goes to memory and back, so the
  total is the traffic of the unfused program, not of a fused one, and
  JAX's bytes (fusions opaque, their internals never touching HBM) are
  not its yardstick;
- collective bytes and counts per kind: ``shard_ctx.COLLECTIVES`` over
  the counted region (the tensor sizes handed to the collectives, kinds
  ``<purpose>/<collective>``).

It also keeps a liveness count of the storages the step allocates
(each new storage's bytes from its first op until it is freed), whose
maximum is the step's peak of new memory on top of its arguments.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.runtime import shard_ctx

# allocations that write nothing
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


@dataclass
class CostTotals:
    """``hlo_cost.CostTotals``' fields, per rank."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    collective_counts: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages the tensors of ``tree`` use."""
    seen, total = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


class OpCounter(TorchDispatchMode):
    """Counts the step run under it (``with OpCounter() as c:``):
    ``c.totals`` (a ``CostTotals``, collectives filled on exit) and
    ``c.peak_bytes`` (the most bytes of storages allocated under it that
    were alive at once)."""

    def __init__(self):
        super().__init__()
        self.totals = CostTotals()
        self.live = 0
        self.peak_bytes = 0
        self._alive: Dict[int, weakref.ref] = {}

    def __enter__(self):
        shard_ctx.reset_collectives()
        return super().__enter__()

    def __exit__(self, *exc):
        for kind, (calls, nbytes) in shard_ctx.COLLECTIVES.items():
            self.totals.collective_counts[kind] += calls
            self.totals.collective_bytes[kind] += nbytes
        return super().__exit__(*exc)

    def _freed(self, key: int, nbytes: int) -> None:
        self._alive.pop(key, None)
        self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._alive and self._alive[key]() is st:
            return
        nbytes = st.nbytes()
        self._alive[key] = weakref.ref(
            st, lambda _, k=key, n=nbytes: self._freed(k, n))
        self.live += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.totals.flops += count(*args, **kwargs, out_val=out)
        if func.namespace == "aten" and not func.is_view:
            outs = _tensors(out)
            if func._overloadpacket.__name__ not in _NO_TRAFFIC:
                self.totals.hbm_bytes += sum(
                    _nbytes(t) for t in _tensors((args, kwargs)) + outs)
            ins = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
            for t in outs:
                if id(t.untyped_storage()) not in ins:
                    self._track(t)
        return out
