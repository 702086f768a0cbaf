"""Ambient sharding context for model code (counterpart of
``repro.runtime.shard_ctx``), on ``torch.distributed``.

The model stays mesh-agnostic: every rank runs the port's own code on
its local shards, and the collectives are explicit, Megatron style, at
the points where JAX's model calls ``shard_ctx.constrain``:

- ``constrain(h, "block_in")`` is Megatron's *f*: identity forward,
  all-reduce over the model group backward (in front of a
  column-parallel product);
- ``constrain(y, "residual")`` is Megatron's *g*: all-reduce over the
  model group forward, identity backward (after a row-parallel product).

Both are no-ops without a context or at model size 1.  The residual
stream stays replicated over the model group (Megatron tensor
parallelism without sequence parallelism: the same function as JAX's
``"residual": P(dp, TP, None)``).

Specs are ``P``, a small ``PartitionSpec``-like tuple of per-dim mesh
axis names (None, a name, or a tuple of names); ``placements`` turns
one into DTensor placements on a ``DeviceMesh``.  ``prune_spec`` is
JAX's per-dimension divisibility fallback.

The gradient hook ``reduce_grads`` (and ``ZeroUpdate`` for the
optimizer moments kept as ZeRO chunks over the data axes) is the one
place the data-parallel mean of the gradients runs.  Every collective
made here counts itself in ``COLLECTIVES``: ``kind -> [calls, bytes]``
(bytes = the tensor's size as handed to the collective), the style of
``ops.LAUNCHES``.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Pytree = Any

# kind -> [calls, bytes]; kinds are "<purpose>/<collective>"
COLLECTIVES: Dict[str, list] = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()


def _count(kind: str, nbytes: int) -> None:
    c = COLLECTIVES.setdefault(kind, [0, 0])
    c[0] += 1
    c[1] += int(nbytes)


class P:
    """Per-dim mesh axes of a tensor: ``P(None, "model")``,
    ``P(("data", "model"), None)``; trailing dims not named are
    unsharded.  A leaf in trees (not a tuple, which trees flatten)."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.dims == other.dims

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return f"P{self.dims!r}"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a dict, or any object
    with a ``shape`` mapping (the rule functions read only this)."""
    if isinstance(mesh, dict):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim naming it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_shape(mesh):
        dims = [d for d, e in enumerate(spec) if name in _axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclass
class ShardRules:
    """A mesh, the data-parallel axes and the tensor-parallel axis.
    ``tp_leaves``: names of the parameter leaves the model axis shards
    (for the norms BlockLLM's selection reads).  JAX's other fields have
    no counterpart: its named activation rules are GSPMD layout hints,
    which the port's local shards already follow (``constrain`` acts on
    ``block_in`` and ``residual`` only), and its ``moe_shard_map`` picks
    between two MoE lowerings where the port has one."""
    mesh: Any
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    tp_leaves: frozenset = frozenset()
    _groups: Dict = field(default_factory=dict, repr=False)

    def axis_size(self, axes) -> int:
        shape = mesh_shape(self.mesh)
        return int(math.prod(shape[a] for a in _axes(axes)))

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.tp_axis) if self.tp_axis not in \
            self.dp_axes else 1

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.dp_axes)

    def coord(self, axes) -> int:
        """This rank's index along the (flattened, major first) axes."""
        shape = mesh_shape(self.mesh)
        idx = 0
        for a in _axes(axes):
            dim = list(shape).index(a)
            idx = idx * shape[a] + int(self.mesh.get_coordinate()[dim])
        return idx

    def group(self, axes):
        """The process group over ``axes`` holding this rank (built on
        first use; every rank must ask for the same axes in order)."""
        axes = _axes(axes)
        if axes not in self._groups:
            if len(axes) == 1:
                self._groups[axes] = self.mesh.get_group(axes[0])
            else:
                import torch.distributed as dist
                shape = mesh_shape(self.mesh)
                names = list(shape)
                ranks = self.mesh.mesh.permute(
                    [names.index(a) for a in names if a not in axes]
                    + [names.index(a) for a in axes])
                ranks = ranks.reshape(-1, math.prod(shape[a] for a in axes))
                mine = None
                for row in ranks.tolist():
                    g = dist.new_group(row)
                    if dist.get_rank() in row:
                        mine = g
                self._groups[axes] = mine
        return self._groups[axes]

    def tp_sharded(self, name: str) -> bool:
        return name in self.tp_leaves


_CTX: Optional[ShardRules] = None


def get() -> Optional[ShardRules]:
    return _CTX


@contextlib.contextmanager
def use(rules: Optional[ShardRules]):
    global _CTX
    prev = _CTX
    _CTX = rules
    try:
        yield
    finally:
        _CTX = prev


def fits(shape, spec: P, mesh) -> bool:
    """True iff every sharded dim divides the product of its mesh axes."""
    ms = mesh_shape(mesh)
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, padded):
        size = int(math.prod(ms[a] for a in _axes(entry)))
        if size > 1 and dim % size != 0:
            return False
    return True


def prune_spec(shape, spec: P, mesh) -> P:
    """Drop (per dimension) the axes that do not divide: the fallback."""
    ms = mesh_shape(mesh)
    out = []
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, padded):
        if entry is None:
            out.append(None)
            continue
        keep = []
        for a in _axes(entry):
            if dim % int(math.prod(ms[x] for x in keep + [a])) == 0:
                keep.append(a)
        out.append(tuple(keep) if len(keep) > 1
                   else (keep[0] if keep else None))
    return P(*out)


# --------------------------------------------------------------------- #
# collectives (counted)
# --------------------------------------------------------------------- #


def all_reduce(x: torch.Tensor, axes, kind: str, op="sum",
               rules: Optional[ShardRules] = None) -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``axes`` of ``rules`` (default:
    the installed context's)."""
    import torch.distributed as dist
    ctx = rules or _CTX
    _count(kind, x.numel() * x.element_size())
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=ctx.group(axes))
    return x


def all_gather(x: torch.Tensor, axes, kind: str) -> torch.Tensor:
    """``[n * x.shape[0], ...]``: the ranks' ``x`` stacked in rank order
    along dim 0 (every rank's ``x`` must have one shape)."""
    import torch.distributed as dist
    ctx = _CTX
    n = ctx.axis_size(axes)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _count(kind, x.numel() * x.element_size())
    dist.all_gather_into_tensor(out, x, group=ctx.group(axes))
    return out


def reduce_scatter(x: torch.Tensor, axes, kind: str) -> torch.Tensor:
    """Sum over ``axes`` of ``x`` [n * c, ...]; this rank keeps its
    ``[c, ...]`` block (rank order along dim 0)."""
    import torch.distributed as dist
    ctx = _CTX
    n = ctx.axis_size(axes)
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _count(kind, x.numel() * x.element_size())
    dist.reduce_scatter_tensor(out, x, group=ctx.group(axes))
    return out


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward (over the
    model group of the context installed at the forward)."""

    @staticmethod
    def forward(ctx, x):
        ctx.rules = _CTX
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.rules.tp_axis,
                          "tp/all_reduce", rules=ctx.rules)


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce(x.contiguous().clone(), _CTX.tp_axis,
                          "tp/all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g


class _MeanOverData(torch.autograd.Function):
    """The data-parallel mean of a replicated-downstream scalar (the MoE
    aux loss): all-reduce mean forward, identity backward — each rank's
    gradient is its own term's, and the gradient hook takes the mean."""

    @staticmethod
    def forward(ctx, x):
        rules = _CTX
        y = all_reduce(x.detach().clone().contiguous(), rules.dp_axes,
                       "metric/all_reduce")
        return y / rules.dp_size

    @staticmethod
    def backward(ctx, g):
        return g


def _tp_active() -> bool:
    return _CTX is not None and _CTX.tp_size > 1


def constrain(x, name: str):
    """Apply a named activation rule: ``block_in`` (f) and ``residual``
    (g) over the model group; other names and a missing context or a
    model axis of 1 leave ``x`` as it is."""
    if not _tp_active():
        return x
    if name == "block_in":
        return _CopyToModel.apply(x)
    if name == "residual":
        return _ReduceFromModel.apply(x)
    return x


def tp_split(local: int, full: int) -> bool:
    """True iff a dim of ``full`` elements is split over the model axis
    here (its local size is smaller)."""
    return _tp_active() and local != full


def tp_rank() -> int:
    return _CTX.coord(_CTX.tp_axis) if _tp_active() else 0


def tp_replicated_weight(w):
    """A model-replicated weight used inside a model-parallel branch (K/V
    projections whose heads do not divide the model axis while the query
    heads do): its gradient is partial per rank, so it is summed over the
    model group in the backward (``_CopyToModel``)."""
    return _CopyToModel.apply(w) if _tp_active() else w


def tp_max(x: torch.Tensor) -> torch.Tensor:
    """Max over the model group (no gradient)."""
    return all_reduce(x.detach().clone().contiguous(), _CTX.tp_axis,
                      "tp/all_reduce", op="max")


def data_mean(x) -> Any:
    """All-reduce mean over the data axes of a replicated-downstream
    value, identity backward (see ``_MeanOverData``)."""
    return x if _CTX is None else _MeanOverData.apply(x)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the data axes (no gradient); the value itself without a
    context."""
    if _CTX is None:
        return x
    return all_reduce(x.detach().clone().contiguous(), _CTX.dp_axes,
                      "metric/all_reduce")


# --------------------------------------------------------------------- #
# the gradient hook: the data-parallel mean, with ZeRO chunks
# --------------------------------------------------------------------- #


def zero_dim(grad_shape, moment_shape, n: int) -> Optional[int]:
    """The dim a ZeRO moment chunk splits (the one dim where the moment
    is ``1/n`` of the gradient), or None for a whole moment."""
    diff = [i for i, (a, b) in enumerate(zip(grad_shape, moment_shape))
            if a != b]
    if not diff:
        return None
    if len(diff) != 1 or grad_shape[diff[0]] != moment_shape[diff[0]] * n:
        raise ValueError(f"moment {tuple(moment_shape)} is not a ZeRO chunk "
                         f"of {tuple(grad_shape)} over {n} ranks")
    return diff[0]


def q8_chunk(numel: int, n: int, r: int) -> Tuple[int, int, int]:
    """Q8 moments chunk along their codec blocks: ``(c, lo, hi)`` with
    ``c = ceil(NB / n)`` blocks per rank and rank ``r`` owning blocks
    ``[lo, hi)`` (whole 256-element blocks; the last ranks may own
    fewer, or none)."""
    from repro_torch.runtime.compression import BLOCK
    nb = -(-numel // BLOCK)
    c = -(-nb // n)
    lo = min(r * c, nb)
    return c, lo, min(lo + c, nb)


class ZeroUpdate:
    """One optimizer step over ZeRO chunks.

    ``grads`` / ``params``: flat leaf lists of one tree (the model-local
    shards); ``moments``: per leaf the first moment as stored (an f32
    chunk, or the int8 ``[NB, 256]`` codes of ``q8``).  Without a
    context it is the identity layout.  ``reduce`` turns the gradients
    into the data mean of this rank's chunk — one bucketed reduce-
    scatter for the chunked leaves, one bucketed all-reduce for the
    rest; ``chunk`` cuts a param-shaped list (params, masks) to the
    same chunks (contiguous copies, views where the chunk is whole);
    ``gather_into`` all-gathers updated param chunks back into the
    full leaves in place."""

    def __init__(self, grads: Sequence[torch.Tensor],
                 moments: Sequence[torch.Tensor], *, q8: bool = False):
        self.ctx = _CTX
        self.q8 = q8
        self.shapes = [tuple(g.shape) for g in grads]
        self.dims = []
        if self.ctx is None:
            self.dims = [None] * len(grads)
            return
        n, r = self.ctx.dp_size, self.ctx.coord(self.ctx.dp_axes)
        self.n, self.r = n, r
        for g, m in zip(grads, moments):
            if m is g:              # no moments: reduced whole
                self.dims.append(None)
            elif q8:
                self.dims.append("q8")
            else:
                self.dims.append(zero_dim(g.shape, m.shape, n))

    def _slice(self, t: torch.Tensor, i: int) -> torch.Tensor:
        d = self.dims[i]
        if d is None:
            return t
        if d == "q8":
            c, lo, hi = q8_chunk(t.numel(), self.n, self.r)
            from repro_torch.runtime.compression import BLOCK
            return t.reshape(-1)[lo * BLOCK:min(hi * BLOCK, t.numel())]
        if self.n == 1:
            return t
        size = t.shape[d] // self.n
        return t.narrow(d, self.r * size, size).contiguous()

    def chunk(self, tensors: Sequence[Optional[torch.Tensor]]):
        if self.ctx is None:
            return list(tensors)
        return [None if t is None else self._slice(t, i)
                for i, t in enumerate(tensors)]

    def _to_rows(self, g: torch.Tensor, i: int,
                 local: bool = False) -> torch.Tensor:
        """A full leaf as [n, chunk elements], rank r's chunk in row r;
        with ``local``, this rank's chunk ``g`` as its flat row."""
        from repro_torch.runtime.compression import BLOCK
        d = self.dims[i]
        n = 1 if local else self.n
        if d == "q8":
            c, _, _ = q8_chunk(math.prod(self.shapes[i]), self.n, self.r)
            flat = g.reshape(-1)
            pad = n * c * BLOCK - flat.numel()
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            return flat.reshape(n, -1) if not local else flat
        gm = g.movedim(d, 0)
        return gm.reshape(n, -1) if not local else gm.reshape(-1)

    def _from_rows(self, rows: torch.Tensor, p: torch.Tensor, i: int):
        """Copy the ranks' chunk rows [n, chunk elements] into the full
        leaf ``p`` (inverse of ``_to_rows``)."""
        d = self.dims[i]
        if d == "q8":
            p.copy_(rows.reshape(-1)[:p.numel()].reshape(p.shape))
            return
        moved = (p.shape[d],) + tuple(p.shape[:d]) + tuple(p.shape[d + 1:])
        p.copy_(rows.reshape(moved).movedim(0, d))

    def _from_row(self, row: torch.Tensor, i: int) -> torch.Tensor:
        from repro_torch.runtime.compression import BLOCK
        d, shape = self.dims[i], self.shapes[i]
        if d == "q8":
            numel = math.prod(shape)
            _, lo, hi = q8_chunk(numel, self.n, self.r)
            return row[:max(0, min(hi * BLOCK, numel) - lo * BLOCK)]
        moved = (shape[d] // self.n,) + shape[:d] + shape[d + 1:]
        return row.reshape(moved).movedim(0, d).contiguous()

    def reduce(self, grads: Sequence[torch.Tensor]):
        """The data-mean gradient chunks (the gradients themselves
        without a context)."""
        if self.ctx is None:
            return list(grads)
        out = [None] * len(grads)
        whole = [i for i, d in enumerate(self.dims) if d is None]
        cut = [i for i, d in enumerate(self.dims) if d is not None]
        n = self.n
        for idx, scatter in ((whole, False), (cut, True)):
            by_dtype: Dict[torch.dtype, list] = {}
            for i in idx:
                by_dtype.setdefault(grads[i].dtype, []).append(i)
            for ids in by_dtype.values():
                if scatter:
                    rows = [self._to_rows(grads[i], i) for i in ids]
                    red = reduce_scatter(torch.cat(rows, dim=1).reshape(-1),
                                         self.ctx.dp_axes,
                                         "grad/reduce_scatter").div_(n)
                    off = 0
                    for i, row in zip(ids, rows):
                        w = row.shape[1]
                        out[i] = self._from_row(red[off:off + w], i)
                        off += w
                else:
                    flat = torch.cat([grads[i].reshape(-1) for i in ids])
                    flat = all_reduce(flat, self.ctx.dp_axes,
                                      "grad/all_reduce").div_(n)
                    off = 0
                    for i in ids:
                        k = grads[i].numel()
                        out[i] = flat[off:off + k].reshape(grads[i].shape)
                        off += k
        return out

    def row_sums(self, i: int, chunk: torch.Tensor) -> torch.Tensor:
        """Per-row (dim 0 of leaf ``i``) sums of this rank's ``chunk``
        of an elementwise quantity (a Q8 chunk is a flat block range)."""
        if self.dims[i] != "q8":
            return (chunk.sum(dim=tuple(range(1, chunk.dim())))
                    if chunk.dim() > 1 else chunk)
        from repro_torch.runtime.compression import BLOCK
        shape = self.shapes[i]
        per_row = math.prod(shape[1:])
        _, lo, _ = q8_chunk(math.prod(shape), self.n, self.r)
        rows = torch.arange(lo * BLOCK, lo * BLOCK + chunk.numel(),
                            device=chunk.device) // per_row
        return chunk.new_zeros(shape[0]).index_add_(0, rows, chunk)

    @torch.no_grad()
    def gather_into(self, params: Sequence[torch.Tensor],
                    chunks: Sequence[torch.Tensor]) -> None:
        """Write every rank's updated chunks back into the full leaves, in
        one bucketed all-gather per dtype."""
        if self.ctx is None:
            return
        by_dtype: Dict[torch.dtype, list] = {}
        for i, (p, ch) in enumerate(zip(params, chunks)):
            if self.dims[i] is None:
                if ch is not p:
                    p.copy_(ch)
            else:
                by_dtype.setdefault(p.dtype, []).append(i)
        for ids in by_dtype.values():
            rows = [self._to_rows(chunks[i], i, local=True) for i in ids]
            full = all_gather(torch.cat(rows), self.ctx.dp_axes,
                              "zero/all_gather").reshape(self.n, -1)
            off = 0
            for i, row in zip(ids, rows):
                self._from_rows(full[:, off:off + row.numel()], params[i], i)
                off += row.numel()

def reduce_grads(grads: Sequence[torch.Tensor]):
    """The gradient hook for leaves without ZeRO moments: the data mean
    in one bucketed all-reduce (the gradients themselves without a
    context)."""
    return ZeroUpdate(grads, grads).reduce(grads)


def reduce_metrics(loss: torch.Tensor, metrics: Dict[str, torch.Tensor]):
    """The data-parallel mean of the loss and of every metric but
    ``tokens`` (``model.loss_fn`` counts the global tokens already), in
    one all-reduce; unchanged without a context."""
    if _CTX is None:
        return loss, metrics
    keys = [k for k in metrics if k != "tokens"]
    vals = torch.stack([loss.float()] + [metrics[k].float().reshape(())
                                         for k in keys])
    vals = all_reduce(vals, _CTX.dp_axes, "metric/all_reduce") / \
        _CTX.dp_size
    out = dict(metrics)
    for i, k in enumerate(keys):
        out[k] = vals[i + 1].to(metrics[k].dtype)
    return vals[0].to(loss.dtype), out


def sum_over(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum of a per-rank partial (norms) over ``axes`` (no gradient)."""
    if _CTX is None or not _axes(axes):
        return x
    return all_reduce(x.detach().clone().contiguous(), axes,
                      "metric/all_reduce")
